"""PyTorch port: the host side of the window-sum kernel's launch
(``csrc/eye_tail.cu``'s ``pupil_window_sum``), on the CPU.

- ``eye_tail.window_sum_plan``: the kernel's launch rule written out in
  Python (``tests/test_torch_cuda.py`` holds it to the card's own,
  ``window_sum_shape``): the form and windows a thread by shape alone, the
  stages within the card's shared memory, row bands for images too large
  for the ring, the consumers.
- The ring's schedule, transcribed: the producer and every active
  consumer stepped in random interleavings, the copies landing in random
  order, each barrier wait answered by its phase parity as the card
  answers it; no wait returns before its unit landed, no stage is
  refilled while read, and no run deadlocks.
- The kernel's order of adds, transcribed: each unit staged as the
  producer stages it (the bins past its rows NaN), each item summed as its
  form sums it (the dense form's head, body and tail, the float4 chunks),
  equals ``metrics.eye_perceived_reference`` bit for bit.

No JAX: the window sum is port-side.  One torch thread (module fixture).
"""

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
    eye_tail,
    metrics,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,want", [
    # simulate's sampled grid: every lane sums, four images at once
    ((80, 120, 30, 30, 8, 12),
     dict(form=1, k=1, epy=7, epx=8, band_rows=7, bands=1, items=56,
          stage_rows=78, stages=6, lead=4, consumers=224, active=224,
          threads=256, smem=224_832)),
    # the dense scan: thirteen windows a thread
    ((80, 120, 30, 30, 1, 1),
     dict(form=2, k=13, epy=51, epx=91, band_rows=51, bands=1, items=357,
          stage_rows=80, stages=6, lead=4, consumers=512, active=512,
          threads=544, smem=230_784)),
    # a sparse stride: four windows an image, a warp of which 16 sum
    ((80, 120, 30, 30, 50, 90),
     dict(form=0, k=1, epy=2, epx=2, band_rows=2, bands=1, items=4,
          stages=6, lead=4, consumers=32, active=16, threads=64)),
])
def test_plan_at_the_reference_shapes(shape, want):
    plan = eye_tail.window_sum_plan(*shape)
    assert {k: plan[k] for k in want} == want


SHAPES = [
    (80, 120, 30, 30, 8, 12), (80, 120, 30, 30, 1, 1),
    (80, 120, 30, 30, 3, 5), (13, 17, 1, 1, 1, 1), (13, 17, 5, 5, 1, 1),
    (13, 17, 5, 5, 8, 12), (13, 17, 5, 5, 3, 5), (13, 17, 1, 1, 3, 5),
    (40, 44, 9, 9, 3, 4), (7, 9, 7, 9, 1, 1), (200, 256, 30, 30, 1, 1),
    (600, 120, 30, 30, 8, 12), (226, 256, 128, 40, 2, 2),
    (300, 256, 128, 40, 2, 2),
    (8, 7263, 8, 10, 1, 1), (128, 450, 128, 128, 1, 1),
    (80, 120, 30, 30, 50, 90), (37, 41, 30, 30, 8, 12),
    (128, 454, 128, 128, 1, 1),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_rules(shape):
    """Every plan fits the card and covers every window: stages within the
    shared bytes (two at least, with their barriers, unless one band of
    one window row takes more than half; one needs no barriers), whole
    window rows a unit, the consumers whole warps whose items leave stages
    to refill; of them the active ones hold at most ``lead`` units' items,
    so each starts below unit ``lead`` and steps at most ``lead`` units, as
    the ring's order needs; windows a thread by shape alone."""
    eby, ebx, rows, cols, sy, sx = shape
    p = eye_tail.window_sum_plan(*shape)
    assert p["epy"] == (eby - rows) // sy + 1
    assert p["epx"] == (ebx - cols) // sx + 1
    pad = {0: 0, 1: 3, 2: eye_tail.DENSE_K - 1}[p["form"]]
    assert p["stage_floats"] % 4 == 0
    assert p["stage_floats"] >= p["stage_rows"] * ebx + pad
    assert p["stage_rows"] == (p["band_rows"] - 1) * sy + rows <= eby
    if p["stages"] > 1:
        assert p["smem"] == p["stages"] * (p["stage_floats"] * 4
                                           + eye_tail.BAR_BYTES)
    else:                   # no ring: the stage alone
        assert p["smem"] == p["stage_floats"] * 4
    assert p["smem"] <= eye_tail.SMEM_LIMIT
    assert 1 <= p["stages"] <= eye_tail.MAX_STAGES
    if p["stages"] == 1:    # one window row does not fit twice
        one = ((rows * ebx + pad + 3) // 4 * 4) * 4 + eye_tail.BAR_BYTES
        assert 2 * one > eye_tail.SMEM_LIMIT
    assert (p["bands"] - 1) * p["band_rows"] < p["epy"]
    assert p["bands"] * p["band_rows"] >= p["epy"]
    assert p["xblocks"] * p["k"] >= p["epx"] > (p["xblocks"] - 1) * p["k"]
    assert p["items"] == p["band_rows"] * p["xblocks"]
    assert p["consumers"] % 32 == 0 and 32 <= p["consumers"] <= 512
    assert p["threads"] == p["consumers"] + eye_tail.PRODUCER
    # the active consumers hold the items of at most lead units: stages - 2
    # (stages - 1 in a ring of 2 or 3); so each starts below unit lead and
    # steps at most lead units, and the producer keeps stages - lead units
    # ahead of them
    lead = max(1, p["stages"] - (2 if p["stages"] >= 4 else 1))
    assert p["lead"] == lead
    active, items = p["active"], p["items"]
    assert 1 <= active <= p["consumers"]
    assert active == min(p["consumers"], lead * items)
    assert (active - 1) // items < lead
    assert -(-active // items) <= lead
    # windows a thread: DENSE_K at stride (sy, 1) with that many windows a row
    # (where the dense form's padding fits), else one
    assert p["k"] == (eye_tail.DENSE_K if p["form"] == 2 else 1)
    if sx == 1 and p["epx"] >= eye_tail.DENSE_K:
        assert p["form"] in (2, 0)
    else:
        assert p["form"] == (1 if sx % 4 == 0 and ebx % 4 == 0 else 0)


def test_plan_bands_and_refusal():
    """An image whose rows do not fit two stages is staged in row bands:
    the most window rows of which two stages fit, then one; the dense form
    falls back to scalar reads where its padding does not fit; a disc
    whose one window row does not fit a stage is refused."""
    p = eye_tail.window_sum_plan(200, 256, 30, 30, 1, 1)
    assert (p["bands"], p["band_rows"], p["stages"]) == (3, 84, 2)
    p = eye_tail.window_sum_plan(600, 120, 30, 30, 8, 12)
    assert (p["bands"], p["band_rows"], p["stages"]) == (3, 27, 2)
    # one stage: a window row's 128 x 256 bins do not fit twice
    p = eye_tail.window_sum_plan(226, 256, 128, 40, 2, 2)
    assert (p["bands"], p["band_rows"], p["stages"]) == (1, 50, 1)
    p = eye_tail.window_sum_plan(300, 256, 128, 40, 2, 2)
    assert (p["bands"], p["band_rows"], p["stages"]) == (2, 50, 1)
    # 8 x 7263 floats fit one stage; the dense form's 12 more do not
    p = eye_tail.window_sum_plan(8, 7263, 8, 10, 1, 1)
    assert (p["form"], p["k"], p["stages"]) == (0, 1, 1)
    # a window row that takes every shared byte: one stage with no
    # barriers, so every image that fits the block whole is taken
    p = eye_tail.window_sum_plan(128, 454, 128, 128, 1, 1)
    assert 128 * 454 * 4 == eye_tail.SMEM_LIMIT
    assert (p["form"], p["stages"], p["smem"]) == (0, 1, eye_tail.SMEM_LIMIT)
    # a smaller card's limit: more bands, never a larger stage
    a = eye_tail.window_sum_plan(80, 120, 30, 30, 1, 1, smem_limit=48 * 1024)
    assert a["stages"] >= 2 and a["smem"] <= 48 * 1024 and a["bands"] > 1
    with pytest.raises(ValueError, match="fits"):
        eye_tail.window_sum_plan(128, 600, 128, 128, 1, 1)
    with pytest.raises(ValueError, match="fits"):
        eye_tail.window_sum_plan(128, 455, 128, 128, 1, 1)
    with pytest.raises(ValueError):
        eye_tail.window_sum_plan(13, 17, 14, 5, 1, 1)


def _consumer_units(plan, tid, mine):
    """The units of consumer ``tid``'s items, in its order: the kernel's
    loop, stepped as it steps (an item of ``active`` every ``active``)."""
    items, active = plan["items"], plan["active"]
    step_n, step_i = divmod(active, items)
    n, item = divmod(tid, items)
    while n < mine:
        if item >= items:
            item -= items
            n += 1
            if n >= mine:
                break
        yield n
        n += step_n
        item += step_i


class _Bar:
    """An mbarrier: its current phase, arrivals pending, waiters."""

    def __init__(self, count):
        self.count, self.pending, self.phase, self.waiters = (
            count, count, 0, [])

    def done(self, parity):
        # try_wait.parity: true once the phase of that parity before the
        # current one has completed, i.e. the current phase's parity differs
        return (self.phase & 1) != parity

    def arrive(self, runnable):
        self.pending -= 1
        if self.pending == 0:
            self.phase += 1
            self.pending = self.count
            runnable.extend(self.waiters)
            self.waiters = []


def _run_ring(plan, mine, seed):
    """The ring's protocol (the kernel's producer and active consumers)
    over ``mine`` units of one block, stepped in a random interleaving with
    the bulk copies landing in a random order; asserts every wait that
    returns finds its unit landed in its stage, no stage refilled while an
    item reads it, every arrival in its unit's phase, and no deadlock."""
    rng = np.random.default_rng(seed)
    S, items, lead = plan["stages"], plan["items"], plan["lead"]
    ahead = S - lead
    full = [_Bar(1) for _ in range(S)]
    empty = [_Bar(items) for _ in range(S)]
    content, readers = [None] * S, [0] * S
    landed = [False] * mine
    seqs = [list(_consumer_units(plan, t, mine))
            for t in range(plan["active"])]
    pos = [0] * len(seqs)
    reading = [False] * len(seqs)
    assert sorted(n for q in seqs for n in q) == sorted(
        n for n in range(mine) for _ in range(items))
    prod = {"n": 0, "step": 0}
    runnable = [("p",)] + [("c", t) for t in range(len(seqs)) if seqs[t]]
    finished = 0
    while runnable:
        who = runnable.pop(int(rng.integers(len(runnable))))
        if who[0] == "l":                      # a copy lands
            n = who[1]
            bar = full[n % S]
            assert bar.phase == n // S
            landed[n] = True
            bar.arrive(runnable)
        elif who[0] == "p":
            n = prod["n"]
            if n >= mine:
                continue
            s = n % S
            if prod["step"] == 0:              # the stage released
                if n >= S and not empty[s].done((n // S - 1) & 1):
                    empty[s].waiters.append(who)
                    continue
                prod["step"] = 1
            if prod["step"] == 1:              # unit n - ahead landed
                if n >= ahead:
                    bar = full[(n - ahead) % S]
                    if not bar.done(((n - ahead) // S) & 1):
                        bar.waiters.append(who)
                        continue
                    assert landed[n - ahead]
                assert readers[s] == 0         # no item reads the stage
                # arrive.expect_tx: the phase then waits for the copy's
                # bytes, so its landing is the arrival that completes it
                content[s] = n
                runnable.append(("l", n))
                prod["n"], prod["step"] = n + 1, 0
            runnable.append(who)
        else:
            t = who[1]
            n = seqs[t][pos[t]]
            s = n % S
            if not reading[t]:                 # wait for the unit
                if not full[s].done((n // S) & 1):
                    full[s].waiters.append(who)
                    continue
                assert landed[n] and content[s] == n, (t, n)
                reading[t] = True
                readers[s] += 1
            else:                              # summed: release
                assert content[s] == n and empty[s].phase == n // S
                readers[s] -= 1
                reading[t] = False
                empty[s].arrive(runnable)
                pos[t] += 1
                if pos[t] == len(seqs[t]):
                    finished += 1
                    continue
            runnable.append(who)
    assert prod["n"] == mine and all(landed), "the ring deadlocked"
    assert finished == sum(1 for q in seqs if q)


@pytest.mark.parametrize("shape,limit", [
    ((80, 120, 30, 30, 8, 12), None),         # 6 stages, 224 summing
    ((80, 120, 30, 30, 1, 1), None),          # 512 summing, 357 items
    ((80, 120, 30, 30, 50, 90), None),        # 4 items: 16 of 32 sum
    ((37, 41, 30, 30, 8, 12), None),          # one item, 8 stages
    ((37, 41, 30, 30, 8, 12), 14_832),        # a ring of 3: lead 2
    ((80, 120, 30, 30, 8, 12), 120_000),      # a ring of 3, 96 summing
    ((200, 256, 30, 30, 1, 1), None),         # a ring of 2 in row bands
])
def test_ring_schedule_holds_its_order(shape, limit):
    """The ring's schedule under random interleavings and copies landing
    out of order: every wait answered by parity as the card answers it
    returns only once its unit landed, no stage is refilled under a read,
    every run ends."""
    plan = eye_tail.window_sum_plan(
        *shape, **({} if limit is None else {"smem_limit": limit}))
    assert plan["stages"] >= 2
    if limit is not None:
        assert plan["stages"] == 3
    mine = 3 * plan["stages"] + 2
    for seed in range(3):
        _run_ring(plan, mine, seed)


def _bin(v, f):
    return v if f is None else np.float32(v * f)


def _sum_scalar(stage, base, pitch, segs, f):
    acc = np.float32(0.0)
    for dy, (s, e) in enumerate(segs):
        for c in range(s, e):
            acc = np.float32(acc + _bin(stage[base + dy * pitch + c], f))
    return acc


def _sum_vec4(stage, base, pitch, segs, f):
    """Float4 chunks from the run's aligned start, VEC_CHUNKS at a time; a
    chunk adds only the run's bins."""
    assert base % 4 == 0 and pitch % 4 == 0
    acc = np.float32(0.0)
    for dy, (s, e) in enumerate(segs):
        r = base + dy * pitch
        for c0 in range(s & ~3, e, 4 * eye_tail.VEC_CHUNKS):
            for c in range(c0, c0 + 4 * eye_tail.VEC_CHUNKS):
                if s <= c < e:
                    acc = np.float32(acc + _bin(stage[r + c], f))
    return acc


def _sum_dense(stage, base, pitch, segs, f):
    K = eye_tail.DENSE_K
    acc = [np.float32(0.0)] * K
    for dy, (s, e) in enumerate(segs):
        r = stage[base + dy * pitch:]
        if e - s >= K - 1:
            for h in range(K - 1):
                x = _bin(r[s + h], f)
                for j in range(h + 1):
                    acc[j] = np.float32(acc[j] + x)
            for c in range(s + K - 1, e):
                x = _bin(r[c], f)
                for j in range(K):
                    acc[j] = np.float32(acc[j] + x)
            for t in range(K - 1):
                x = _bin(r[e + t], f)
                for j in range(t + 1, K):
                    acc[j] = np.float32(acc[j] + x)
        else:
            for j in range(K):
                for c in range(s, e):
                    acc[j] = np.float32(acc[j] + _bin(r[c + j], f))
    return acc


def _emulate(rows_in, ebx, mask, stride, scale, plan):
    """The kernel's units, items and adds on the CPU in float32 over the
    (B, eby, row_stride) rows ``rows_in`` cut to ``ebx``: each unit staged
    into a stage of ``stage_floats`` NaNs, its rows packed ``ebx`` floats
    apart."""
    segs = metrics.pupil_segments(mask).tolist()
    sy, sx = stride
    B, eby, row_stride = rows_in.shape
    epy, epx, k, pitch = plan["epy"], plan["epx"], plan["k"], ebx
    out = np.full((B, epy, epx), np.nan, np.float32)
    for b in range(B):
        f = None if scale is None else np.float32(scale[b])
        for band in range(plan["bands"]):
            wy_n = min(plan["band_rows"], epy - band * plan["band_rows"])
            nrows = (wy_n - 1) * sy + len(segs)
            y0 = band * plan["band_rows"] * sy
            stage = np.full(plan["stage_floats"], np.nan, np.float32)
            for y in range(nrows):
                stage[y * pitch:y * pitch + ebx] = rows_in[b, y0 + y, :ebx]
            for item in range(plan["items"]):
                wy, xb = divmod(item, plan["xblocks"])
                iy = band * plan["band_rows"] + wy
                if iy >= epy:
                    continue
                base = wy * sy * pitch + xb * k * sx
                if plan["form"] == 2:
                    acc = _sum_dense(stage, base, pitch, segs, f)
                    for j in range(k):
                        if xb * k + j < epx:
                            out[b, iy, xb * k + j] = acc[j]
                elif plan["form"] == 1:
                    out[b, iy, xb] = _sum_vec4(stage, base, pitch, segs, f)
                else:
                    out[b, iy, xb] = _sum_scalar(stage, base, pitch, segs,
                                                 f)
    return out


def _mask(kind):
    if kind == "empty_row":       # a disc row with an empty run
        m = metrics.pupil_mask(7)
        m[3] = 0.0
        return m
    return metrics.pupil_mask(kind)


@pytest.mark.parametrize("eby,ebx,pad,mask,stride,scaled,limit", [
    (13, 17, 0, 5, (1, 1), False, None),      # dense, short runs
    (13, 17, 0, 1, (1, 1), True, None),       # dense, 17 windows a row
    (20, 24, 0, 12, (1, 1), True, None),      # dense head and tail
    (26, 36, 0, 20, (1, 1), False, None),     # dense head, body and tail
    (20, 24, 0, 12, (2, 1), False, 1_500),    # dense in row bands, one stage
    (16, 24, 0, "empty_row", (1, 1), False, None),
    (40, 44, 0, 9, (3, 4), False, None),      # float4 chunks
    (40, 44, 0, 9, (8, 12), True, 3_000),     # float4 in row bands
    (13, 17, 0, 5, (3, 5), True, None),       # scalar
    (16, 19, 0, "empty_row", (2, 3), False, 700),
    (40, 44, 4, 9, (8, 12), True, None),      # rows 48 apart, packed
    (40, 44, 4, 9, (1, 1), False, 10_000),    # the same in row bands
    (16, 19, 5, 5, (3, 3), False, None),      # rows 24 apart
])
def test_order_of_adds_equals_plain_version(eby, ebx, pad, mask, stride,
                                            scaled, limit):
    """The kernel's order of adds, transcribed, equals the plain version
    bit for bit in every form, in row bands, with empty runs and with
    per-image scales; the bins past a unit's rows (NaN here) reach only the
    windows the kernel does not store."""
    m = _mask(mask)
    rng = np.random.default_rng(23)
    rows_in = rng.random((3, eby, ebx + pad)).astype(np.float32) * 100.0
    rows_in[rows_in < 20.0] = 0.0
    rows_in[:, :, ebx:] = np.nan          # a row's padding: never summed
    images = np.ascontiguousarray(rows_in[:, :, :ebx])
    scale = (rng.random(3).astype(np.float32) + 0.5) if scaled else None
    plan = eye_tail.window_sum_plan(
        eby, ebx, *m.shape, *stride,
        **({} if limit is None else {"smem_limit": limit}))
    if limit is not None:
        assert plan["bands"] > 1
    got = _emulate(rows_in, ebx, m, stride, scale, plan)
    want = metrics.eye_perceived_reference(
        torch.from_numpy(images), m, stride,
        None if scale is None else torch.from_numpy(scale)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
