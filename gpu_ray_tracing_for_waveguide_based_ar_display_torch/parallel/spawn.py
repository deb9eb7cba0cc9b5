"""A world of ranks in local processes: one spawned process per rank, joined
by a gloo default process group over a ``FileStore`` (no network port), as
the tests, :func:`.dryrun.dryrun_multichip` and the card's smoke test run
them.

    results = run_ranks(fn, world, args)

calls ``fn(rank, world, *args)`` in every rank (``fn`` is a module-level
function: it is pickled by its import path) and returns the ranks' return
values in rank order.  A rank that raises, dies or outlives ``timeout_s``
fails the call with every rank's traceback; no process outlives it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist


def _rank_main(fn, rank: int, world: int, workdir: str, args: tuple,
               timeout_s: float, threads: Optional[int]) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    out = Path(workdir)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(out / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(out / f"result-{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"error-{rank}.txt").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world: int, args: tuple = (), timeout_s: float = 120.0,
              threads: Optional[int] = 1,
              workdir: Optional[str] = None) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    their results in rank order.  ``timeout_s`` bounds the process group's
    collectives and the whole call; ``threads`` sets each rank's torch
    threads (None leaves torch's default); ``workdir`` holds the store and
    the results (default: a fresh temporary directory)."""
    with tempfile.TemporaryDirectory(prefix="grt-ranks-",
                                     dir=workdir) as tmp:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, tmp, args, timeout_s,
                                   threads),
                             name=f"rank-{r}") for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = {r: (Path(tmp) / f"error-{r}.txt").read_text()
                  for r in range(world)
                  if (Path(tmp) / f"error-{r}.txt").is_file()}
        codes = {r: p.exitcode for r, p in enumerate(procs)}
        if hung or errors or any(codes.values()):
            detail = "".join(f"\n--- rank {r}:\n{tb}"
                             for r, tb in sorted(errors.items()))
            what = (f"ranks {hung} outlived {timeout_s:g} s" if hung
                    else f"exit codes {codes}")
            raise RuntimeError(f"run_ranks({fn.__name__}, {world}): "
                               f"{what}{detail}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
