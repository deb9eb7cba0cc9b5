"""Device time of named spans, by CUDA events."""

from __future__ import annotations

import contextlib

import torch


class EventTimer:
    """Sums the device time of named spans.  A span records one CUDA event
    before and one after the work it wraps, on the current stream, and does
    not synchronise; on a CPU device it records nothing."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self._spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._spans.setdefault(name, []).append((start, end))

    def ms(self) -> dict:
        """Milliseconds per span name; call after the work has finished
        (``torch.cuda.synchronize()`` or a copy to the host)."""
        return {name: sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self._spans.items()}
