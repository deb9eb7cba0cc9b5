"""PyTorch port on the card: the CUDA kernel against its plain version.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import generate_geometry

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import TraceConfig
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline,
    trace_persistent as tp,
)

M, N = 4, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small():
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=256, num_iter=2,
                      max_bounces=600, seed=6)
    return geom, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [128, 512])
def test_kernel_equals_plain_version_on_card(small, cuda_device, slots):
    """Same float32 operations, no fused multiply-add: identical results."""
    geom, cfg = small
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             persistent_slots=slots)
    assert tp._LIB is not None   # built and bound by Simulator.__init__
    cells = np.arange(3 * M * N)
    rays_in, rng_in = sim._device_ray_blocks(cells, slots)
    ctrl = sim._pers_ctrl(512)
    tr = sim.tracer
    args = (tr.cell_params, tr.geom_row, rays_in, rng_in, ctrl)
    kw = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
              eyebox_bins=tr.eyebox_bins, max_iters=tr.max_iters)
    n0 = tp.launch_counts["persistent_trace"]
    hk, nbk = tp.persistent_trace(*args, **kw)
    torch.cuda.synchronize()
    assert tp.launch_counts["persistent_trace"] == n0 + 1
    hr, nbr = tp.persistent_trace_reference(*args, **kw)
    assert hk.sum() > 0
    assert torch.equal(hk, hr)
    assert torch.equal(nbk, nbr)


@pytest.mark.cuda
def test_simulator_on_card_equals_cpu(small, cuda_device):
    """The kernel on the card and the plain version on the CPU give the same
    histogram (IEEE float32 without contraction on both)."""
    geom, cfg = small
    rg = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                            persistent_slots=128).run(cells_per_batch=16)
    rc = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                            persistent_slots=128).run(cells_per_batch=16)
    np.testing.assert_array_equal(rg.histogram, rc.histogram)
    assert rg.total_bounces == rc.total_bounces
    assert rg.rays_traced == rc.rays_traced
    assert rg.efficiencies == rc.efficiencies
