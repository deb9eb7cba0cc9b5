"""Sharding of the trace over a ``torch.distributed`` device mesh.

Port of ``parallel/shard.py`` of the JAX package.  There a ``jax.sharding
.Mesh`` and ``shard_map`` split an array over devices and ``psum`` merges
the per-device results.  Here every rank is one process that holds one
coordinate of a :class:`~torch.distributed.device_mesh.DeviceMesh`: a
wrapper takes the global (host or device) arrays every rank holds, keeps this
rank's contiguous slice of the sharded axis, traces it, and merges over the
process group of the mesh dimension with ``all_reduce`` (JAX's ``psum``) or
``all_gather`` (the global output of a sharded axis).  Every rank returns
the whole result, as JAX's replicated outputs are.

- ray axis (:func:`make_sharded_trace_fn`): the vector trace over this
  rank's rays, one histogram ``all_reduce`` over the whole mesh;
- cell axis (:func:`make_sharded_cell_trace_fn`): the persistent trace (the
  CUDA kernel on a card) over this rank's cells, tiles gathered;
- sample axis (:func:`make_sample_sharded_cell_trace_fn`): every cell with
  this rank's seed block, tiles summed;
- both (:func:`make_2d_sharded_cell_trace_fn`).

Backends (:func:`make_mesh`): NCCL when every rank has a GPU of its own,
gloo when ranks share a card (gloo carries CUDA tensors through host
memory) and on the CPU.  Every process group gets a timeout, so a rank that
dies or hangs fails the others' collectives instead of blocking them.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import TraceConfig
from ..engine import trace_vector
from ..engine.trace_geometry import TraceGeometry
from ..luts.packing import CellTables

DEFAULT_TIMEOUT_S = 300.0


# ---------------------------------------------------------------------------
# the mesh


def choose_backend(device_type: str, ranks_per_host: int,
                   gpus_per_host: int) -> str:
    """NCCL when every rank of a host has a GPU of its own; gloo when ranks
    share a card (NCCL refuses two ranks on one device) and on the CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device_type must be cpu or cuda, got {device_type!r}")
    return "nccl" if ranks_per_host <= gpus_per_host else "gloo"


def _ranks_per_host() -> int:
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else the world (one
    host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()
                              if dist.is_initialized()
                              else os.environ.get("WORLD_SIZE", "1")))


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized()
                              else os.environ.get("RANK", "0")))


def _set_cuda_device() -> None:
    """Bind this rank to its card: local rank modulo the cards of the host
    (ranks share cards round-robin when there are fewer cards than ranks)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for but "
                           "torch.cuda.is_available() is False")
    torch.cuda.set_device(_local_rank() % torch.cuda.device_count())


def _group_options(backend: str, timeout: datetime.timedelta):
    opts = (dist.ProcessGroupNCCL.Options() if backend == "nccl"
            else dist.ProcessGroupGloo._Options())
    opts._timeout = timeout
    return opts


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("rays",),
              device_type: str = "cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DeviceMesh:
    """A mesh of every rank of the default process group; defaults to 1-D
    over the ray axis.

    The default group is the caller's (``init_process_group``) or, when none
    is initialised, made here from torchrun's ``env://`` variables with the
    backend :func:`choose_backend` picks and a timeout of ``timeout_s``.  A
    CUDA mesh binds each rank to its card first.  A group whose backend does
    not fit the devices raises: NCCL with ranks sharing a card, anything but
    gloo on the CPU.  Every mesh dimension's group gets the timeout and runs
    one collective before the mesh is returned."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be cpu or cuda, got {device_type!r}")
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                "make_mesh needs the default process group: run under "
                "torchrun (python -m torch.distributed.run --nproc-per-node "
                "N ...) or call torch.distributed.init_process_group first "
                f"(missing {', '.join(missing)})")
        gpus = torch.cuda.device_count() if device_type == "cuda" else 0
        dist.init_process_group(
            choose_backend(device_type, _ranks_per_host(), gpus),
            init_method="env://", timeout=timeout)
    backend = dist.get_backend()
    world = dist.get_world_size()
    if device_type == "cuda":
        _set_cuda_device()
        if backend == "nccl" and _ranks_per_host() > torch.cuda.device_count():
            raise ValueError(
                f"{_ranks_per_host()} ranks on {torch.cuda.device_count()} "
                "card(s): NCCL refuses two ranks on one device; use gloo")
    elif backend != "gloo":
        raise ValueError(f"a CPU mesh runs on gloo, not {backend}")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} "
                         f"does not cover the {world} ranks")
    opts = _group_options(backend, timeout)
    mesh = init_device_mesh(
        device_type, shape, mesh_dim_names=tuple(axis_names),
        backend_override={name: (backend, opts) for name in axis_names})
    # a group's first collective builds NCCL's communicator: make that set-up
    # time, and let a rank that did not come up fail here
    probe = torch.zeros(1, device=mesh_device(mesh) if backend == "nccl"
                        else "cpu")
    for name in axis_names:
        dist.all_reduce(probe, group=mesh.get_group(name))
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def describe_mesh(mesh: DeviceMesh) -> str:
    """The mesh, its backend and this rank's device, for a run's report."""
    axes = ", ".join(f"{n}={mesh.size(i)}"
                     for i, n in enumerate(mesh.mesh_dim_names))
    backend = dist.get_backend(mesh.get_group(mesh.mesh_dim_names[0]))
    dev = mesh_device(mesh)
    line = (f"mesh: {mesh.size()} ranks ({axes}), backend {backend}, "
            f"device {dev}")
    if dev.type == "cuda":
        line += f" ({torch.cuda.get_device_name(dev)}"
        if backend == "gloo":
            line += (f"; {_ranks_per_host()} ranks on "
                     f"{torch.cuda.device_count()} card(s), gloo carries "
                     "the tensors through host memory")
        line += ")"
    return line


def _axis(mesh: DeviceMesh, axis: str) -> Tuple[int, int, dist.ProcessGroup]:
    """(ranks along ``axis``, this rank's index along it, its group)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return (mesh.size(names.index(axis)), mesh.get_local_rank(axis),
            mesh.get_group(axis))


# ---------------------------------------------------------------------------
# collectives; gloo moves a CUDA tensor through host memory


def _comm_device(group) -> str:
    return "cuda" if dist.get_backend(group) == "nccl" else "cpu"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, on ``t``'s device (``t`` itself is
    left as it is)."""
    x = t.to(_comm_device(group), copy=True).contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated along axis 0 in rank
    order, on ``t``'s device; every rank's ``t`` has the same shape."""
    x = t.to(_comm_device(group)).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(t.device)


def broadcast_from(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the rank with index ``src`` in ``group``, on every rank (the
    other ranks pass a tensor of the same shape and dtype)."""
    x = t.to(_comm_device(group), copy=True).contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x.to(t.device)


def _chunk(a, n: int, i: int):
    """The ``i``-th of ``n`` equal contiguous chunks of axis 0."""
    k = len(a) // n
    return a[i * k:(i + 1) * k]


# ---------------------------------------------------------------------------
# ray axis


# neutral padding values per SoA key where zero is NOT neutral: a padded
# "dep" of 0 is a real bin-0 deposit code (the sentinel is -1,
# trace_vector.make_ray_state), and cos_th divides the branch efficiencies
_PAD_FILL = {"dep": -1, "cos_th": 1}


def pad_rays_to(rays: dict, multiple: int) -> dict:
    """Pad a host-side SoA batch so its length divides the mesh size.

    Padding rays carry zero field amplitude, so their first-interaction roulette
    probability is exactly 0 and they terminate at init without depositing.
    Works on both the seeding batch (x/y/te/tm/cid/idx/rng) and a full
    ``make_ray_state`` dict of numpy arrays: keys whose neutral value is
    nonzero (the ``dep`` deposit sentinel, ``cos_th``) are filled accordingly
    — zero-filled ``dep`` padding would silently deposit one count per
    padding ray into cell 0, bin 0.
    """
    n = len(rays["x"])
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return rays
    pad = target - n
    out = {}
    for k, v in rays.items():
        v = np.asarray(v)
        pv = np.full((pad,) + v.shape[1:], _PAD_FILL.get(k, 0), dtype=v.dtype)
        out[k] = np.concatenate([v, pv], axis=0)
    return out


def _flat_rank(mesh: DeviceMesh) -> int:
    """This rank's index in the mesh flattened row-major, the order in which
    JAX's ``P(mesh.axis_names)`` splits an axis over every mesh axis."""
    return int(np.ravel_multi_index(tuple(mesh.get_coordinate()),
                                    tuple(mesh.shape)))


def shard_ray_batch(rays: dict, mesh: DeviceMesh) -> dict:
    """This rank's contiguous slice of a ray batch (numpy arrays or tensors,
    the ray axis first), split over every mesh axis, on the rank's
    device."""
    n, size = len(rays["x"]), mesh.size()
    if n % size:
        raise ValueError(f"{n} rays do not divide over the {size} ranks of "
                         "the mesh (pad them with pad_rays_to)")
    dev, i = mesh_device(mesh), _flat_rank(mesh)
    return {k: torch.as_tensor(_chunk(v, size, i)).to(dev)
            for k, v in rays.items()}


def make_sharded_trace_fn(tables: CellTables, tgeom: TraceGeometry,
                          cfg: TraceConfig, mesh: DeviceMesh):
    """Build ``trace(rays) -> (histogram, bounces)`` sharded over ``mesh``.

    ``rays`` is this rank's slice (:func:`shard_ray_batch`) of a
    :func:`..engine.trace_vector.make_ray_state` batch whose length divides
    the mesh size (:func:`pad_rays_to`).  Each rank traces its rays with the
    vector tracer and bins them; the histogram and the bounce count are
    summed over every mesh axis, so every rank returns the whole batch's.
    """
    core = trace_vector.make_trace_fn(tables, tgeom, cfg,
                                      device=mesh_device(mesh))
    ny, nx = cfg.eyebox_bins
    L, M, N = tables.L, tables.M, tables.N

    def trace(rays):
        rays_f, bounces = core(rays)
        hist = trace_vector.deposits_to_histogram(
            rays_f["dep"], rays_f["cid"], L, M, N, ny, nx)
        for name in mesh.mesh_dim_names:
            group = mesh.get_group(name)
            hist = all_reduce_sum(hist, group)
            bounces = all_reduce_sum(bounces, group)
        return hist, bounces

    return trace


# ---------------------------------------------------------------------------
# cell and sample axes of the persistent trace


def _classify_rays(cell_params, geom_row, rays_in, n_dev: int):
    """Shared discriminator/validator for the cell-sharding wrappers.

    Returns ``(shared, design_sharded)``: whether ``rays_in`` is the shared
    per-design tile form (one (6, RT, 128) tile per design) or per-cell
    blocks, and whether the design axis itself shards over the mesh.

    The persistent trace accepts ``rays_in`` with leading dim ``Cb``
    (per-cell-block tiles, where Cb = C / cells_per_block) or ``D``
    (one shared tile per design, ``D = geom_row.shape[0]``), so the design
    axis is the exact discriminator.  Multi-design calls shard when each
    rank receives WHOLE designs — the trace derives its design fan-out
    (``cpd = C // D``) from the local call shapes, so a rank holding
    D/n_dev contiguous designs with their C/n_dev design-major cells
    computes exactly the single-rank result.  Layouts that would split a
    design across ranks are rejected loudly instead of producing silently
    wrong fan-out:

    - multi-design calls with ``D % n_dev != 0`` (a design would straddle a
      device boundary);
    - per-cell tiles whose block count differs from the cell count
      (``cells_per_block > 1``) — block rows would misalign with the
      cell shards.
    """
    D = geom_row.shape[0]
    C = cell_params.shape[0]
    nr = rays_in.shape[0]
    shared = nr == D and nr != C
    design_sharded = D > 1 and n_dev > 1
    if n_dev > 1:
        if D > 1:
            if D % n_dev:
                raise ValueError(
                    f"multi-design cell-axis sharding needs whole designs "
                    f"per device: {D} designs do not divide over {n_dev} "
                    f"devices of the mesh axis")
            if not shared:
                raise ValueError(
                    "multi-design cell-axis sharding supports the shared "
                    f"per-design ray-tile form only (got {nr} ray rows for "
                    f"{D} designs / {C} cells)")
        if not shared and nr != C:
            raise ValueError(
                f"per-cell ray tiles must have one row per cell to shard "
                f"(got {nr} rows for {C} cells; cells_per_block > 1 does "
                f"not compose with cell-axis sharding)")
    return shared, design_sharded


def _check_cells(n_cells: int, n_dev: int, axis: str) -> None:
    if n_cells % n_dev:
        raise ValueError(f"{n_cells} cells do not divide over {n_dev} "
                         f"devices of mesh axis {axis!r}")


def _check_seed_axis(rng_in, n_dev: int, axis: str) -> None:
    if rng_in.shape[0] != n_dev:
        raise ValueError(
            f"rng_in needs a leading device axis of {n_dev} (mesh axis "
            f"{axis!r}), got shape {tuple(rng_in.shape)}")


def _check_cell_rng(cell_params, geom_row, rng_in, n_dev: int) -> bool:
    """Whether the seeds shard with the cells: per-cell streams (C rows)
    shard; a per-cell-of-design block shared across designs (C // D rows,
    the sweep's form) replicates — each rank's trace still maps it as
    ``i % cpd``."""
    C, nr = cell_params.shape[0], rng_in.shape[0]
    rng_sharded = nr == C
    if n_dev > 1 and not rng_sharded and nr * geom_row.shape[0] != C:
        if nr and C % nr == 0 and C // nr > 1:
            # block-packed rng (C // cells_per_block rows): the actual
            # unsupported knob is cells_per_block, mirror the per-cell
            # tile rejection instead of a misleading row-count message
            raise ValueError(
                f"rng_in has {nr} rows for {C} cells — "
                f"cells_per_block == {C // nr} does not compose with "
                "cell-axis sharding (block rows would misalign with "
                "the cell shards)")
        raise ValueError(
            f"rng_in rows ({nr}) must equal the cell count "
            f"({C}) or the per-design cell count to "
            "shard soundly")
    return rng_sharded


def _packed_kw(packed: bool, cell_params_packed, n: int = 1,
               i: int = 0) -> dict:
    """The trace's packed-words keyword: the ``i``-th of ``n`` chunks of
    the cells' words when ``packed``, else none."""
    if not packed:
        return {}
    if cell_params_packed is None:
        raise ValueError("packed=True needs cell_params_packed")
    return {"cell_params_packed": _chunk(cell_params_packed, n, i)}


def gather_cells(tiles: torch.Tensor, nb: torch.Tensor, group):
    """This rank's (C / n, ny, nx) tiles and (C / n, 4) ``nb`` -> the whole
    axis's, in rank order."""
    return all_gather_rows(tiles, group), all_gather_rows(nb, group)


def make_sharded_cell_trace_fn(trace_fn, mesh: DeviceMesh, axis: str = "rays",
                               packed: bool = False):
    """Shard the *cell* axis of the persistent trace over a mesh axis.

    ``trace_fn(cell_params, geom_row, rays_in, rng_in, ctrl,
    cell_params_packed=None) -> (tiles, nb)`` has the positional contract of
    :func:`..engine.trace_persistent.persistent_trace` (its keywords bound):
    the CUDA kernel on a card.  Each rank traces its contiguous chunk of the
    cells (their rows, packed words, per-cell launch tiles and seeds); a
    shared per-design tile replicates, multi-design calls give each rank
    whole designs with their geometry rows, and seeds shared by every design
    (C / D rows) replicate.  The tiles and ``nb`` are gathered over the
    axis, so every rank returns the (C, ny, nx) / (C, 4) arrays of the whole
    call.  The number of cells must divide the axis's rank count.
    """

    def trace(cell_params, geom_row, rays_in, rng_in, ctrl,
              cell_params_packed=None):
        # the cell axis splits over THIS axis only (a 2-D cells x samples
        # mesh leaves the other axis to the sample-sharded wrapper)
        n_dev, idx, group = _axis(mesh, axis)
        _check_cells(cell_params.shape[0], n_dev, axis)
        shared, design_sharded = _classify_rays(cell_params, geom_row,
                                                rays_in, n_dev)
        rng_sharded = _check_cell_rng(cell_params, geom_row, rng_in, n_dev)
        kw = _packed_kw(packed, cell_params_packed, n_dev, idx)
        tiles, nb = trace_fn(
            _chunk(cell_params, n_dev, idx),
            _chunk(geom_row, n_dev, idx) if design_sharded else geom_row,
            (_chunk(rays_in, n_dev, idx) if design_sharded or not shared
             else rays_in),
            _chunk(rng_in, n_dev, idx) if rng_sharded else rng_in,
            ctrl, **kw)
        return gather_cells(tiles, nb, group)

    return trace


def make_sample_sharded_cell_trace_fn(trace_fn, mesh: DeviceMesh,
                                      axis: str = "samples",
                                      packed: bool = False):
    """Monte-Carlo *sample*-axis data parallelism for the persistent trace.

    The orthogonal direction to :func:`make_sharded_cell_trace_fn`: every
    rank traces ALL cells, with its own block of seeds — ``rng_in`` carries
    a leading axis ``(n_dev, C, RT, 128)`` of distinct seed blocks, one per
    rank of ``axis`` — and its share of the per-cell sample budget (the
    caller divides the generations or the count-spawn target by the rank
    count).  Tiles and ``nb`` are summed over the axis.  This lifts cell
    sharding's ``cells >= ranks`` requirement; for both axes at once use
    :func:`make_2d_sharded_cell_trace_fn`.
    """

    def trace(cell_params, geom_row, rays_in, rng_in, ctrl,
              cell_params_packed=None):
        # the leading seed axis splits over THIS axis only; sizing it to the
        # total rank count on a multi-axis mesh would trace a fraction of
        # the intended samples
        n_dev, idx, group = _axis(mesh, axis)
        _check_seed_axis(rng_in, n_dev, axis)
        kw = _packed_kw(packed, cell_params_packed)
        tiles, nb = trace_fn(cell_params, geom_row, rays_in, rng_in[idx],
                             ctrl, **kw)
        return all_reduce_sum(tiles, group), all_reduce_sum(nb, group)

    return trace


def make_2d_sharded_cell_trace_fn(trace_fn, mesh: DeviceMesh,
                                  cell_axis: str = "cells",
                                  sample_axis: str = "samples",
                                  packed: bool = False):
    """Cell-axis AND sample-axis data parallelism on a 2-D mesh.

    The cell rows, packed words and per-cell launch tiles split over
    ``cell_axis`` (disjoint tiles), while ``rng_in`` (S, C, RT, 128) with
    ``S = `` the ranks of ``sample_axis`` carries one seed block per rank of
    that axis: each rank traces its cells with its sample share, the tiles
    are summed over ``sample_axis`` and then gathered over ``cell_axis``.
    A shared launch tile replicates; multi-design calls raise (use
    :func:`make_sharded_cell_trace_fn` to shard a sweep).
    """

    def trace(cell_params, geom_row, rays_in, rng_in, ctrl,
              cell_params_packed=None):
        n_cell, ci, cgroup = _axis(mesh, cell_axis)
        n_samp, si, sgroup = _axis(mesh, sample_axis)
        shared, design_sharded = _classify_rays(cell_params, geom_row,
                                                rays_in, n_cell)
        if design_sharded:
            raise ValueError(
                "multi-design calls are not supported on the 2-D mesh "
                "wrapper; use make_sharded_cell_trace_fn for sweep sharding")
        _check_cells(cell_params.shape[0], n_cell, cell_axis)
        _check_seed_axis(rng_in, n_samp, sample_axis)
        kw = _packed_kw(packed, cell_params_packed, n_cell, ci)
        tiles, nb = trace_fn(
            _chunk(cell_params, n_cell, ci), geom_row,
            rays_in if shared else _chunk(rays_in, n_cell, ci),
            _chunk(rng_in[si], n_cell, ci), ctrl, **kw)
        tiles, nb = all_reduce_sum(tiles, sgroup), all_reduce_sum(nb, sgroup)
        return gather_cells(tiles, nb, cgroup)

    return trace
