"""The trace kernel's (``persistent_trace``) least time on one H100: the
larger of its bytes over HBM bandwidth and its lane instructions over the
card's lane-instruction rate.

The count is frozen here so that every mode of the kernel (exact, packed,
packed with transit jumps) and any later rewrite is judged against one
yardstick.  It is built from quantities that no implementation changes: the
run's physics bounces (a jump's skipped hops count), its deposits, each
design's region edges and the cell grid of the workload.

- Bytes: every input read once and every output written once.  Inputs: a
  cell row of ``ROW_FLOATS`` floats a cell, a geometry row and a launch
  tile of ``6 * slots`` floats a design, a seed a slot of one design's
  cells a launch (every design of a launch shares them).  Outputs: a
  (ny, nx) float histogram and ``NB_WORDS`` counters a cell.
- Operations, as lane instructions with a fused multiply-add counted once:
  every bounce tests its slot against the whole-system region, at least
  ``OPS_PER_R1_EDGE`` instructions an edge (two FMAs and a compare); every
  deposit computes its bin and adds to it, at least ``OPS_PER_DEPOSIT``
  instructions (per axis an FMA, a conversion and a clamp of two; the
  index; the atomic add).  The Jones products, the strip selection and the
  roulette of interacting bounces are not counted: the bound is a floor.

How it differs from ``chip_smoke.simulate_bound_ms`` (and ``bound_ms``),
which it replaces for the benchmark: those count 4 operations an r1 edge
(3 when packed) at 67e12 a second, which takes an FMA as two operations and
halves the bound, and divide the bounces by the hops a jump may skip, so a
change of mode changed the yardstick; they also count the packed words and
each cell's seeds as inputs.  Here one count holds in every mode, at
``PEAK_FP32_ADDS`` instructions a second.
"""

from __future__ import annotations

# 132 SMs x 128 FP32 lanes x 1.98 GHz (the SXM part's boost clock): lane
# instructions a second
PEAK_FP32_ADDS = 132 * 128 * 1.98e9
PEAK_HBM_BYTES = 3.35e12     # bytes a second

ROW_FLOATS = 704             # a cell row
GEOM_ROW_FLOATS = 320        # a design's geometry row
NB_WORDS = 4                 # per-cell counters written back
OPS_PER_R1_EDGE = 3
OPS_PER_DEPOSIT = 10

KERNEL = "persistent_trace_kernel"   # its name in the profiler's trace


def kernel_seconds(kernels: dict):
    """The kernel's device seconds in a trace summary's ``kernels``, or
    None when it did not run."""
    return kernels.get(KERNEL)


def counts(*, designs: int, cells_per_design: int, slots: int, bins: int,
           launches: int, edge_bounces: float, deposits: float) -> tuple:
    """(bytes, lane instructions) of ``launches`` launches over ``designs``
    designs in all; ``edge_bounces`` is the sum over designs of bounces
    times the design's whole-system region edges."""
    cells = designs * cells_per_design
    nbytes = 4 * (cells * (ROW_FLOATS + bins + NB_WORDS)
                  + designs * (GEOM_ROW_FLOATS + 6 * slots)
                  + launches * cells_per_design * slots)
    ops = edge_bounces * OPS_PER_R1_EDGE + deposits * OPS_PER_DEPOSIT
    return nbytes, ops


def least_seconds(**kw) -> tuple:
    """(seconds, "bytes" or "operations"): the least time and what sets it."""
    nbytes, ops = counts(**kw)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / PEAK_FP32_ADDS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
