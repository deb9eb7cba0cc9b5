"""A multi-rank dry run of the sharded traces on small inputs.

The port's counterpart of ``__graft_entry__.dryrun_multichip`` of the JAX
package: ``dryrun_multichip(n)`` spawns ``n`` ranks over gloo
(:func:`.spawn.run_ranks`) and runs its checks on a 4 x 3 FoV grid of the
paper design, each against the same computation on one rank:

- the persistent trace with its cells sharded (a shardable subset), and the
  same call with one shared launch tile in place of per-cell copies;
- the 16-design count-spawn sweep over a mesh, bitwise the one-rank sweep;
- the sample-sharded trace, bitwise the sum of the ranks' one-rank runs;
- the ray-sharded vector trace on a 2-D mesh (1-D for an odd rank count or
  two ranks), bitwise the unsharded trace.

``device_type="cuda"`` runs the ranks' traces on the card (the CUDA kernel);
the ranks share it through gloo.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import TraceConfig, WaveguideDesign
from ..design.geometry import generate_geometry
from ..engine import seeding, trace_persistent, trace_rows, trace_vector
from ..engine.trace_geometry import build_trace_geometry
from ..luts.packing import build_cell_tables
from ..luts.synthetic import make_synthetic_luts
from . import shard
from .spawn import run_ranks


def _same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: the sharded result differs from the "
                             "one-rank result")


def _dryrun_rank(rank: int, world: int, device_type: str) -> list:
    lines = []
    cfg = TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=32,
                      max_bounces=64, seed=0)
    geom = generate_geometry(num_fov_x=4, num_fov_y=3)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    mesh1 = shard.make_mesh((world,), ("cells",), device_type)
    dev = shard.mesh_device(mesh1)

    # ---- the persistent trace, cells sharded over a shardable subset
    n_cells = 3 * cfg.num_fov_x * cfg.num_fov_y
    n_sub = (n_cells // world) * world
    tg = build_trace_geometry(geom, simplify_tol=0.05)
    cp = torch.from_numpy(trace_rows.build_kernel_cell_params(
        tables, geom.eyebox_range)).to(dev)
    gr = torch.from_numpy(trace_rows.build_kernel_geom(tg)[None]).to(dev)
    cfg128 = dataclasses.replace(cfg, rays_per_fov=trace_rows.LANES)
    rays_np, rng_np = trace_rows.pack_ray_blocks(
        seeding.build_ray_batch(geom, cfg128), n_cells, trace_rows.LANES, 1)
    rays_in, rng_in = trace_rows.blocks_to_device(rays_np, rng_np, dev)
    pers = functools.partial(
        trace_persistent.persistent_trace, num_fc=tg.num_fc,
        num_oc=tg.num_oc, edge_counts=trace_rows.edge_counts(tg),
        eyebox_bins=cfg.eyebox_bins, max_iters=256, spawn_mode="gens")
    ctrl = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    sharded = shard.make_sharded_cell_trace_fn(pers, mesh1, axis="cells")
    tiles, nb = sharded(cp[:n_sub], gr, rays_in[:n_sub], rng_in[:n_sub], ctrl)
    t1, nb1 = pers(cp[:n_sub], gr, rays_in[:n_sub], rng_in[:n_sub], ctrl)
    _same(tiles, t1, "cell-sharded tiles")
    _same(nb, nb1, "cell-sharded nb")
    # one shared launch tile replicates; with shared pupil samples it is
    # every cell's tile
    tiles_sh, nb_sh = sharded(cp[:n_sub], gr, rays_in[:1], rng_in[:n_sub],
                              ctrl)
    _same(tiles_sh, tiles, "shared-tile tiles")
    _same(nb_sh, nb, "shared-tile nb")
    lines.append(f"cells: {n_sub} cells over {world} ranks equal one rank; "
                 f"the shared tile equals per-cell copies "
                 f"({float(tiles.sum()):.0f} deposits)")

    # ---- the mesh-parallel design sweep: whole designs per rank
    if world >= 2:
        from ..sweep import run_design_sweep_persistent

        designs = [dataclasses.replace(WaveguideDesign(), lambda_ic=float(p),
                                       lambda_oc=float(p))
                   for p in np.linspace(370.0, 400.0, 16)]
        sweep_cfg = dataclasses.replace(cfg, rays_per_fov=trace_rows.LANES,
                                        max_bounces=48)
        mesh_sw = shard.make_mesh((world,), ("designs",), device_type)
        kw = dict(cfg=sweep_cfg, spawn_iters=0, spawn_mode="count",
                  slots=trace_rows.LANES, designs_per_batch=16, device=dev)
        res_1 = run_design_sweep_persistent(designs, **kw)
        res_m = run_design_sweep_persistent(designs, mesh=mesh_sw, **kw)
        if not (np.array_equal(res_m.efficiencies, res_1.efficiencies)
                and np.array_equal(res_m.bounces, res_1.bounces)):
            raise AssertionError("the mesh-parallel sweep diverged from the "
                                 "one-rank sweep")
        lines.append(f"sweep: 16 designs over {world} ranks equal one rank "
                     f"(mean efficiency {res_m.efficiencies.mean():.6f})")

    # ---- sample axis: every rank all cells with its own seed block
    if world >= 2:
        rng_dev = np.stack([rng_np + np.uint32(1 + d) for d in range(world)])
        rng_dev = torch.from_numpy(rng_dev.view(np.int32)).to(dev)
        mesh_s = shard.make_mesh((world,), ("samples",), device_type)
        sampled = shard.make_sample_sharded_cell_trace_fn(pers, mesh_s,
                                                          axis="samples")
        tiles_s, nb_s = sampled(cp, gr, rays_in, rng_dev, ctrl)
        parts = [pers(cp, gr, rays_in, rng_dev[d], ctrl)
                 for d in range(world)]
        _same(tiles_s, sum(p[0] for p in parts), "sample-sharded tiles")
        _same(nb_s, sum(p[1] for p in parts), "sample-sharded nb")
        lines.append(f"samples: {world} seed blocks summed over {world} "
                     "ranks equal the one-rank runs' sum")

    # ---- the ray axis over a 2-D mesh, histograms summed
    if world % 2 == 0 and world > 2:
        mesh = shard.make_mesh((2, world // 2), ("dp", "rays"), device_type)
    else:
        mesh = shard.make_mesh((world,), ("rays",), device_type)
    tgeom = build_trace_geometry(geom)
    batch = seeding.build_ray_batch(geom, cfg)
    padded = shard.pad_rays_to(batch, mesh.size())
    rays = trace_vector.make_ray_state(
        padded["x"], padded["y"], padded["te"], padded["tm"], padded["cid"],
        padded["idx"], padded["rng"], device=dev)
    trace = shard.make_sharded_trace_fn(tables, tgeom, cfg, mesh)
    hist, bounces = trace(shard.shard_ray_batch(rays, mesh))
    whole = trace_vector.make_ray_state(
        batch["x"], batch["y"], batch["te"], batch["tm"], batch["cid"],
        batch["idx"], batch["rng"], device=dev)
    rays_f, bounces1 = trace_vector.make_trace_fn(tables, tgeom, cfg,
                                                  device=dev)(whole)
    ny, nx = cfg.eyebox_bins
    hist1 = trace_vector.deposits_to_histogram(
        rays_f["dep"], rays_f["cid"], 3, cfg.num_fov_x, cfg.num_fov_y, ny, nx)
    _same(hist, hist1, "ray-sharded histogram")
    _same(bounces, bounces1, "ray-sharded bounces")
    lines.append(f"rays: {len(batch['x'])} rays over the mesh "
                 f"{tuple(mesh.shape)} equal one rank ({int(bounces):,} "
                 "bounces)")
    return lines


def dryrun_multichip(n_devices: int, device_type: str = "cpu",
                     timeout_s: float = 300.0) -> list:
    """Run the dry run's checks on ``n_devices`` spawned ranks; raises if a
    rank fails or a sharded result differs from one rank's.  Prints and
    returns rank 0's report lines."""
    lines = run_ranks(_dryrun_rank, n_devices, (device_type,),
                      timeout_s=timeout_s,
                      threads=1 if device_type == "cpu" else None)[0]
    for ln in lines:
        print(ln)
    return lines
