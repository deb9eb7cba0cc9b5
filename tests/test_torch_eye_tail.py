"""PyTorch port: the plain versions and the routing of the tail's kernels
(``csrc/eye_tail.cu``), on the CPU.

- ``pupil_segments``: the disc of ``pupil_mask(s)`` for s = 1..40 as one
  run of ones per row, and its refusal of other masks;
- ``eye_perceived_reference`` (the perception kernel's plain version)
  against the JAX package's ``eye_perceived_jnp`` (one plain ``jax.jit``)
  and the float64 host ``eye_perceived``, and against ``pupil_conv`` (one
  ``conv2d``) at strides (1, 1) and (3, 5); its scaled form;
- the colorimetry kernel's float32 constants, bitwise the plain version's;
- on the CPU the wrappers take the plain versions and launch nothing, and
  the launchers refuse a CPU tensor.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
Bars: a 716-bin float32 sum in another order agrees within 2e-6 relative
(the seeded fixture's largest gap to the JAX package is 1.1e-6; the bound
for 716 positive terms is 716 x 2^-24 = 4.3e-5); the float64 host within
1e-5."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    EvalConfig as JEvalConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.eval import (
    metrics as jmetrics,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    EvalConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    trace_persistent as tp,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
    color,
    eye_tail,
    metrics,
)

SOURCE = (Path(metrics.__file__).resolve().parent.parent / "csrc"
          / "eye_tail.cu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist(shape=(3, 4, 3, 80, 120), seed=0):
    """Seeded float32 bins in [0, 1), 30 % of them empty."""
    rng = np.random.default_rng(seed)
    h = rng.random(shape).astype(np.float32)
    h[rng.random(shape) < 0.3] = 0.0
    return h


@pytest.mark.parametrize("size", range(1, 41))
def test_pupil_segments_cover_the_disc(size):
    mask = metrics.pupil_mask(size)
    segs = metrics.pupil_segments(mask)
    assert segs.shape == (size, 2) and segs.dtype == np.int32
    rebuilt = np.zeros_like(mask)
    for r, (x0, x1) in enumerate(segs):
        assert 0 <= x0 < x1 <= size      # every row of the disc has a run
        rebuilt[r, x0:x1] = 1.0
    np.testing.assert_array_equal(rebuilt, mask)


@pytest.mark.parametrize("mask", [
    np.array([[1.0, 0.0, 1.0], [1.0, 1.0, 1.0]]),     # a row of two runs
    np.array([[0.5, 1.0], [1.0, 1.0]]),               # not 0 / 1
    np.ones((2, 2, 2)),                               # not 2-D
])
def test_pupil_segments_refuse_other_masks(mask):
    with pytest.raises(ValueError):
        metrics.pupil_segments(mask)
    with pytest.raises(ValueError):
        metrics.eye_perceived_reference(torch.zeros((1, 8, 8)), mask, (1, 1))


def test_eye_perceived_reference_matches_jax_and_host():
    """The sampled grid at (3, 4, 3, 80, 120): the JAX package's window
    einsums and the float64 host sampler agree to float32 association;
    ``eye_perceived_torch`` on the CPU is the plain version, bit for bit."""
    h = _hist()
    ht = torch.from_numpy(h)
    got = metrics.eye_perceived_reference(ht, metrics.pupil_mask(30), (8, 12))
    assert got.shape == (3, 4, 3, 7, 8) and got.dtype == torch.float32
    assert torch.equal(metrics.eye_perceived_torch(ht), got)
    want_j = np.asarray(jmetrics.eye_perceived_jnp(jnp.asarray(h),
                                                   JEvalConfig()))
    want_h = metrics.eye_perceived(h.astype(np.float64), EvalConfig())
    np.testing.assert_allclose(got.numpy(), want_j, rtol=2e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), want_h, rtol=1e-5, atol=0)


@pytest.mark.parametrize("stride", [(1, 1), (3, 5)])
def test_eye_perceived_reference_matches_conv(stride):
    """Every VALID window at ``stride``: ``pupil_conv``'s ``conv2d`` within
    float32 association; scaling first equals the scaled form."""
    h = torch.from_numpy(_hist((2, 2, 3, 80, 120), seed=1))
    mask = metrics.pupil_mask(30)
    got = metrics.eye_perceived_reference(h, mask, stride)
    want = metrics.pupil_conv(h, torch.from_numpy(mask).float(), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6, atol=0)
    assert torch.equal(metrics.eye_perceived_conv(h, EvalConfig(), stride),
                       got)
    scale = torch.from_numpy(np.random.default_rng(2).random(
        (2, 2, 3)).astype(np.float32))
    assert torch.equal(
        metrics.eye_perceived_reference(h, mask, stride, scale),
        metrics.eye_perceived_reference(h * scale[..., None, None], mask,
                                        stride))


def test_colorimetry_constants_are_the_plain_versions():
    """The kernel's constants as ``_make_eval_core``'s ``const()`` and
    ``xyz_to_lab`` round them (bitwise), its scalars as float32 operations
    take Python floats, and the layout of ``csrc/eye_tail.cu``'s enum."""
    k = metrics.colorimetry_constants()
    assert k.dtype == np.float32 and k.shape == (eye_tail.NCONST,)

    def const(a):    # _make_eval_core's rounding
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).numpy()

    drive = np.linalg.solve(metrics.DISPLAY_M,
                            color.linearize_srgb(np.ones(3)))
    for got, want in ((k[0:3], const(drive)),
                      (k[3:12], const(metrics.DISPLAY_M_XYZ).ravel()),
                      (k[12:21], const(metrics.DISPLAY_M).ravel()),
                      (k[21:24], const(color.xyz_to_lab(color.D65_XYZ_100))),
                      (k[24:27], torch.as_tensor(
                          color.D65_WHITE_Y1, dtype=torch.float32).numpy())):
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # the scalars, as the plain version's torch operations apply them
    t = torch.from_numpy(np.random.default_rng(3).random(4096).astype(
        np.float32) * 400 - 100)
    assert torch.equal(torch.rad2deg(t), t * torch.tensor(k[38]))
    assert torch.equal(torch.deg2rad(t), t * torch.tensor(k[39]))
    delta = 6.0 / 29.0
    edge = torch.tensor([k[29], np.nextafter(k[29], np.float32(1))])
    assert torch.equal(edge > delta**3, edge > torch.tensor(k[29]))
    for i, x in ((27, 1e-10), (30, 3 * delta**2), (31, 4.0 / 29.0),
                 (37, 25.0**7), (40, 0.17), (46, 0.0031308), (47, 12.92),
                 (49, 1 / 2.4)):
        assert torch.equal(t * x, t * torch.tensor(k[i])), i
    src = SOURCE.read_text()
    body = re.search(r"enum \{\s*K_DRIVE = 0,(.*?)NCONST", src, re.S).group(1)
    names = re.findall(r"\bK_\w+", body)
    assert len(names) + 1 == 5 + 24       # K_DRIVE, then the rest
    offsets = dict(re.findall(r"\b(K_\w+) = (\d+)", body))
    assert offsets == {"K_MXYZ": "3", "K_MRGB": "12", "K_LABW": "21",
                       "K_WP": "24", "K_YFLOOR": "27"}
    assert names.index("K_RAD2DEG") + 1 == 38 - 27 + 5
    assert names.index("K_SRGB_SUB") + 1 == eye_tail.NCONST - 1 - 27 + 5


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    """Perception, colorimetry, the batch and the dense scan on CPU tensors:
    the plain versions, no kernel launched; the launchers refuse CPU
    tensors (no fallback), and another device is refused."""
    h = torch.from_numpy(_hist((3, 2, 3, 40, 50), seed=4))
    cfg = EvalConfig(pupil_mask_bins=10, eye_step_y=6, eye_step_x=8)
    mask = metrics.pupil_mask(10)
    before = dict(tp.launch_counts)
    perc = metrics.eye_perceived_torch(h, cfg)
    assert torch.equal(perc, metrics.eye_perceived_reference(h, mask, (6, 8)))
    out = metrics.colorimetry_torch(perc, norm=7.0, with_image=True)
    want = metrics._make_eval_core(True)(perc[None], metrics._inv_norm(7.0))
    assert set(out) == set(want)
    for key in out:
        assert torch.equal(out[key], want[key]), key
    stack = torch.stack([perc, 2 * perc])
    batch = metrics.evaluate_batch(stack, norm=7.0)
    assert [b.delta_e for b in batch] == [
        float(v) for v in metrics._make_eval_core(False)(
            stack, metrics._inv_norm(7.0))["delta_e"]]
    dense = metrics.evaluate_dense(h, cfg, norm=7.0, chunk_rows=4)
    assert dense.eye_luminance.shape == (31, 41)
    assert tp.launch_counts == before
    with pytest.raises(ValueError):
        eye_tail.launch_window_sum(h, metrics.pupil_segments(mask), 10,
                                   (1, 1))
    with pytest.raises(ValueError):
        eye_tail.launch_colorimetry(stack, metrics.colorimetry_constants(),
                                    1.0, False)
    meta = torch.empty((2, 40, 50), device="meta")
    with pytest.raises(ValueError):
        metrics.pupil_window_sum(meta, mask, (1, 1))
    with pytest.raises(ValueError):
        metrics.colorimetry_stack(torch.empty((1, 3, 2, 2, 3, 3),
                                              device="meta"), 1.0, False)
