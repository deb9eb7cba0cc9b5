"""Profiling helpers: wall-clock scopes and an optional ``torch.profiler``
trace.

Port of ``utils/profiling.py`` of the JAX package: :class:`Timers` is its
copy; :func:`torch_trace` takes the place of its ``xla_trace`` (a
``jax.profiler`` trace for TensorBoard).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Iterator, Optional


class Timers:
    """Named accumulating wall-clock timers."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:30s} {self.totals[name]:9.3f} s  x{self.counts[name]}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str], cuda: bool = False) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` trace when ``log_dir`` is set:
    host activity, and the card's (kernels, copies) when ``cuda``; the
    Chrome / TensorBoard trace ``<host>_<pid>.<ms>.pt.trace.json`` is
    written into ``log_dir`` when the region ends."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    name = (f"{socket.gethostname()}_{os.getpid()}."
            f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(os.path.join(log_dir, name))
