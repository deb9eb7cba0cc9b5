"""PyTorch port: the device mesh's construction (``parallel/shard.py``),
the multi-rank dry run (``parallel/dryrun.py``), a world whose rank dies
(``parallel/spawn.py``) and ``simulate --mesh`` under torchrun, on the CPU
over gloo.  The sharded traces themselves: ``tests/test_torch_shard.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel import (
    dryrun, shard,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel.spawn import (
    run_ranks,
)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0
PORT = "gpu_ray_tracing_for_waveguide_based_ar_display_torch"

def test_choose_backend():
    assert shard.choose_backend("cpu", 4, 0) == "gloo"
    assert shard.choose_backend("cuda", 4, 4) == "nccl"
    assert shard.choose_backend("cuda", 1, 1) == "nccl"
    assert shard.choose_backend("cuda", 2, 1) == "gloo"
    with pytest.raises(ValueError, match="cpu or cuda"):
        shard.choose_backend("xpu", 1, 1)


def test_make_mesh_needs_a_process_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        shard.make_mesh((2,), ("cells",), "cpu")


def test_dryrun_multichip_two_ranks():
    lines = dryrun.dryrun_multichip(2, timeout_s=TIMEOUT_S)
    assert [ln.split(":")[0] for ln in lines] == ["cells", "sweep", "samples",
                                                 "rays"]


def test_a_dead_rank_fails_the_world(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1"):
        run_ranks(_die_on_rank_1, 2, timeout_s=30.0, workdir=str(tmp_path))


def _die_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 stops")
    x = torch.ones(1)
    torch.distributed.all_reduce(x)   # rank 0 waits for the dead rank
    return float(x)


SIM_ARGS = ["simulate", "--device", "cpu", "--fov-x", "2", "--fov-y", "2",
            "--rays-per-fov", "128", "--num-iter", "1", "--slots", "128",
            "--max-bounces", "500", "--image", ""]


def _metric_lines(text):
    keep = ("Rays traced", "Total ray bounces", "Efficiency", "Color",
            "FoV uniformity", "Eyebox uniformity")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_cli_mesh_under_torchrun_prints_the_one_rank_metrics(tmp_path,
                                                             capsys):
    """``simulate --mesh 2`` over 2 torchrun ranks on the CPU prints the
    metric lines of ``--mesh 0``."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", PORT, *SIM_ARGS, "--mesh", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert two.returncode == 0, two.stderr
    assert cli.main([*SIM_ARGS, "--mesh", "0"]) == 0
    one = capsys.readouterr().out
    assert len(_metric_lines(one)) == 8
    assert _metric_lines(two.stdout) == _metric_lines(one)
    # rank 0 alone reports, and names the backend and the device
    assert two.stdout.count("Rays traced") == 1
    assert "mesh: 2 ranks (cells=2), backend gloo, device cpu" in two.stdout


def test_cli_mesh_refusals(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="--engine persistent"):
        cli.main([*SIM_ARGS, "--engine", "vector", "--mesh", "2"])
    with pytest.raises(SystemExit, match="torch.distributed.run "
                                         "--standalone --nproc-per-node 2"):
        cli.main([*SIM_ARGS, "--mesh", "2"])
    with pytest.raises(SystemExit, match="does not compose with --mesh"):
        cli.main([*SIM_ARGS, "--mesh", "2", "--tail-boost"])
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="world has 3 ranks"):
        cli.main([*SIM_ARGS, "--mesh", "2"])
