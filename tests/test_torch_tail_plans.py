"""The launch plans of the cell-rows kernel and the colorimetry kernels.

Pure Python and numpy on the CPU (no JAX, no kernel): the rows' chunk kinds
against the kernel's rule and the row layout, every (row, chunk) of a
launch written exactly once; the colorimetry's splits covering every
(pixel, position) exactly once, fixed by the stack's shape alone, and the
fixed order of its float32 sums within the plain version's bar.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    WaveguideDesign,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    cell_rows as cr,
    trace_rows as tr,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
    eye_tail,
)

STRIPS = [(nf, no) for nf in range(cr.MAX_FC + 1)
          for no in range(cr.MAX_OC + 1)]
# an H100's resident blocks of the rows' kernel: one an SM
RESIDENT = 132
# a row's float4 chunks, and what each holds, in csrc/cell_rows.cu's
# ``Kind`` order
CHUNKS = tr.PC // 4
CHUNK_KINDS = ("zero", "jones", "init", "gaps0", "gaps1", "ph0", "ph1", "ph2",
               "ph3", "ebr", "ic_s", "fc_s", "oc_s", "ebt", "ebs_hop")
# the first column each scalar kind writes, from the row layout
KIND_COLUMNS = {"init": tr._INIT_SA, "gaps0": tr._GAPS, "gaps1": tr._GAPS + 4,
                "ph0": tr._TIR_PH, "ph1": tr._TIR_PH + 4,
                "ph2": tr._TIR_PH + 8, "ph3": tr._TIR_PH + 12,
                "ebr": tr._EBR, "ic_s": tr._IC_SA, "ebt": tr._EBT,
                "ebs_hop": tr._EBS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one thread, as the other port files do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk_kinds(nf: int, no: int) -> np.ndarray:
    """(CHUNKS,) int: the index in CHUNK_KINDS of what each float4 chunk of
    a row with ``nf`` FC and ``no`` OC strips holds, from the layout: the
    Jones chunks at :func:`cell_rows.branch_table`'s offsets, the scalar
    chunks, and zeros wherever the layout leaves the row empty."""
    kind = CHUNK_KINDS.index
    out = np.full(CHUNKS, kind("zero"), np.int64)
    for name, col in KIND_COLUMNS.items():
        out[col // 4] = kind(name)
    for off in cr.branch_table(nf, no)[:, 3]:
        out[off // 4:off // 4 + 2] = kind("jones")
    for s in range(nf):
        out[(tr._FC_BLK + s * tr._FC_STRIDE + 32) // 4] = kind("fc_s")
    for s in range(no):
        out[(tr._OC_BLK + s * tr._OC_STRIDE + 48) // 4] = kind("oc_s")
    return out


def _block_rows(total: int, grid: int) -> list:
    """Block k's rows ``[k * total // grid, (k + 1) * total // grid)`` of
    the cell-major order r = c * D + d (the kernel's ``r0``, ``r1``)."""
    return [(k * total // grid, (k + 1) * total // grid)
            for k in range(grid)]


def _kernel_chunk_kind(q: int, nf: int, no: int) -> str:
    """``csrc/cell_rows.cu``'s ``chunk_kind``, written out."""
    if q < 4:
        return "jones"
    if q == 4:
        return "init"
    if q < 7:
        return ("gaps0", "gaps1")[q - 5]
    if q < 11:
        return ("ph0", "ph1", "ph2", "ph3")[q - 7]
    if q == 11:
        return "ebr"
    if q < 20:
        return "jones"
    if q == 20:
        return "ic_s"
    if q < 24:
        return "zero"
    if q < 24 + 9 * 7:
        s, e = divmod(q - 24, 9)
        return "zero" if s >= nf else "jones" if e < 8 else "fc_s"
    if q < 88:
        return "zero"
    if q < 172:
        s, e = divmod(q - 88, 14)
        return ("zero" if s >= no else "jones" if e < 12
                else "oc_s" if e == 12 else "zero")
    return {172: "ebt", 173: "ebs_hop"}.get(q, "zero")


def _tile_plan(D: int, C: int, nf: int, no: int, resident: int) -> list:
    """Every store the rows' kernel makes, as ``(block, tile, row, chunk,
    kind)`` with ``row`` the global row d * C + c: per block its tiles of at
    most TILE rows of the cell-major order, per tile the Jones chunks of
    every (branch, row) item and the other chunks of every (chunk, row)
    item (``csrc/cell_rows.cu``'s loops, written out)."""
    total = D * C
    kinds = _chunk_kinds(nf, no)
    jones = CHUNK_KINDS.index("jones")
    offsets = cr.branch_table(nf, no)[:, 3]
    others = [(q, int(k)) for q, k in enumerate(kinds) if k != jones]
    out = []
    spans = _block_rows(total, cr.rows_grid(total, resident))
    for blk, (r0, r1) in enumerate(spans):
        for t, base in enumerate(range(r0, r1, cr.TILE)):
            for r in range(base, min(base + cr.TILE, r1)):
                c, d = divmod(r, D)
                g = d * C + c
                for off in offsets:
                    out += [(blk, t, g, off // 4, jones),
                            (blk, t, g, off // 4 + 1, jones)]
                out += [(blk, t, g, q, k) for q, k in others]
    return out


def _colorimetry_units(P: int, npix: int) -> list:
    """Every unit of one design's colorimetry launch, ``(split, tile,
    pixels, positions)``: the split's pixels and the tile's positions as
    ranges (``csrc/eye_tail.cu``'s ``color_unit``, written out)."""
    S, chunk = eye_tail.colorimetry_splits(P, npix)
    return [(s, t, range(s * chunk, min(npix, (s + 1) * chunk)),
             range(t * eye_tail.LANES, min(P, (t + 1) * eye_tail.LANES)))
            for t in range(-(-P // eye_tail.LANES)) for s in range(S)]


@pytest.mark.parametrize("nf,no", STRIPS)
def test_chunk_kinds_are_the_kernels_rule(nf, no):
    """The chunk kinds from the layout and the branch table and the
    kernel's closed form agree on every chunk; the Jones chunks are two a
    branch."""
    kinds = _chunk_kinds(nf, no)
    want = [_kernel_chunk_kind(q, nf, no) for q in range(CHUNKS)]
    assert [CHUNK_KINDS[k] for k in kinds] == want
    assert want.count("jones") == 2 * len(cr.branch_table(nf, no))


@pytest.mark.parametrize("nf,no", [(0, 0), (7, 6), (3, 2), (7, 0), (0, 6)])
def test_zero_chunks_are_the_layouts_padding(nf, no):
    """On the plain version's rows of a design with these strips, every
    column that holds a value lies in a chunk of a non-zero kind and every
    chunk of the zero kind is zero."""
    g = generate_geometry(dataclasses.replace(
        WaveguideDesign(), num_fc=nf, num_oc=no), 2, 1)
    inputs = cr.synthetic_row_inputs([g], seed=3)
    rows = cr.cell_rows_reference(inputs, g.eyebox_range).numpy()
    kinds = np.repeat(_chunk_kinds(nf, no), 4)
    zero = kinds == CHUNK_KINDS.index("zero")
    assert not rows[:, zero].any()
    assert (rows != 0).any(axis=0)[~zero].mean() > 0.9


@pytest.mark.parametrize("designs,cells", [(1, 1), (1, 15), (1, 16), (1, 17),
                                           (1, 31), (1, 32), (1, 33), (3, 7),
                                           (2, 17), (5, 13)])
@pytest.mark.parametrize("nf,no", STRIPS)
def test_rows_tile_plan_writes_each_chunk_once(designs, cells, nf, no):
    """Every (row, chunk) of a launch is stored exactly once, by a Jones
    item of its branch or by an item of its chunk's kind; a tile holds at
    most TILE rows."""
    plan = _tile_plan(designs, cells, nf, no, RESIDENT)
    total = designs * cells
    seen = np.zeros((total, CHUNKS), np.int64)
    kinds = _chunk_kinds(nf, no)
    per_tile = {}
    for blk, t, g, q, k in plan:
        seen[g, q] += 1
        assert k == kinds[q]
        per_tile.setdefault((blk, t), set()).add(g)
    assert (seen == 1).all()
    assert max(len(v) for v in per_tile.values()) <= cr.TILE


@pytest.mark.parametrize("designs,cells", [(1, 1), (1, 15), (1, 16), (1, 17),
                                           (1, 33), (1, 22_500), (16, 22_500),
                                           (8, 22_500)])
def test_rows_blocks_cover_every_row_once(designs, cells):
    """The blocks' row ranges partition the launch's rows, each block's
    within one row of the others'; at 22,500 cells the grid fills the
    resident blocks, so no wave is mostly empty."""
    total = designs * cells
    grid = cr.rows_grid(total, RESIDENT)
    spans = _block_rows(total, grid)
    assert spans[0][0] == 0 and spans[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [r1 - r0 for r0, r1 in spans]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if total >= cr.TILE * RESIDENT:
        assert grid == RESIDENT


SHAPES = [(56, 7_500), (4_641, 7_500), (1, 192), (45, 192), (56, 4),
          (33, 5), (4_641, 1), (2_000, 300)]


@pytest.mark.parametrize("P,npix", SHAPES)
def test_colorimetry_units_cover_each_item_once(P, npix):
    """The units' pixel splits and position tiles partition the stack's
    (pixel, position) items; every split holds a pixel."""
    units = _colorimetry_units(P, npix)
    S, chunk = eye_tail.colorimetry_splits(P, npix)
    assert len(units) == S * -(-P // eye_tail.LANES)
    pix = np.zeros(npix, np.int64)
    pos = np.zeros(P, np.int64)
    for s, t, pixels, positions in units:
        assert len(pixels) > 0 and len(positions) > 0
        if t == 0:
            pix[pixels.start:pixels.stop] += 1
        if s == 0:
            pos[positions.start:positions.stop] += 1
    assert (pix == 1).all() and (pos == 1).all()


@pytest.mark.parametrize("P,npix", SHAPES)
def test_colorimetry_plan_is_the_shapes_alone(P, npix):
    """The split (which fixes the order of every sum) is the same at D = 1
    and D = 8; only the grid's design axis and the scratch grow with D."""
    one, eight = (eye_tail.colorimetry_plan(D, P, npix) for D in (1, 8))
    for k in ("S", "chunk", "tiles"):
        assert one[k] == eight[k]
    assert eight["grid"] == one["grid"][:2] + (8,)
    assert all(eight[k] == 8 * one[k] for k in ("part", "pos", "done"))


def test_colorimetry_splits_fill_the_slots():
    """simulate's stack (56 positions) fills one wave of the card's unit
    slots and the dense scan's (4,641) two, each at least 99 % full."""
    for P, waves in ((56, 1), (4_641, 2)):
        S, _ = eye_tail.colorimetry_splits(P, 7_500)
        units = S * -(-P // eye_tail.LANES)
        assert -(-units // eye_tail.SLOTS) == waves
        assert units >= 0.99 * waves * eye_tail.SLOTS


def _sum8(v):
    return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))


def _kernel_sum(values: np.ndarray, S: int, chunk: int) -> np.ndarray:
    """The colorimetry kernel's float32 sum over pixels of (npix, P) values,
    in its order: per group over the pixels s * chunk + g, + 8, ...; a tree
    over the 8 groups; per group over the splits g, g + 8, ...; a tree."""
    npix, P = values.shape
    part = np.zeros((S, P), np.float32)
    for s in range(S):
        acc = np.zeros((8, P), np.float32)
        for g in range(8):
            for i in range(s * chunk + g, min(npix, (s + 1) * chunk), 8):
                acc[g] += values[i]
        part[s] = _sum8(acc)
    acc = np.zeros((8, P), np.float32)
    for g in range(8):
        for s in range(g, S, 8):
            acc[g] += part[s]
    return _sum8(acc)


@pytest.mark.parametrize("P,npix", [(56, 7_500), (45, 192), (1, 5)])
def test_colorimetry_sum_order_within_bar(P, npix):
    """The kernel's order of float32 sums, emulated on seeded values, lies
    within the plain version's bar (1e-5 relative) of the exact sum."""
    rng = np.random.default_rng(7)
    values = rng.random((2, npix, P)).astype(np.float32) * 40.0
    S, chunk = eye_tail.colorimetry_splits(P, npix)
    got = [_kernel_sum(v, S, chunk) for v in values]
    exact = values.astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(np.stack(got), exact, rtol=1e-5, atol=0)
