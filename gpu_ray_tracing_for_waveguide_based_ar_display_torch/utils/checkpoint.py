"""Checkpoint/resume for long Monte-Carlo accumulation runs.

The reference has no checkpointing (SURVEY.md section 5.4); since the eyebox
histogram is additive across batches, resumable state is just (histogram,
iterations-completed, config fingerprint).  Stored as a single ``.npz``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..config import TraceConfig, WaveguideDesign


def _fingerprint(design: WaveguideDesign, cfg: TraceConfig) -> str:
    payload = json.dumps(
        [dataclasses.asdict(design), dataclasses.asdict(cfg)], sort_keys=True
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save_checkpoint(
    path: str,
    histogram: np.ndarray,
    iterations_done: int,
    design: WaveguideDesign,
    cfg: TraceConfig,
    total_bounces: int = 0,
    extras: Optional[dict] = None,
) -> None:
    """``extras``: optional int counters (e.g. rays spawned) restored verbatim."""
    # the temp name ends in .npz so savez_compressed doesn't append another
    # suffix; os.replace publishes atomically
    tmp = path + ".tmp.npz"
    extra_arrs = {f"extra_{k}": np.int64(v) for k, v in (extras or {}).items()}
    np.savez_compressed(
        tmp,
        histogram=histogram,
        iterations_done=np.int64(iterations_done),
        total_bounces=np.int64(total_bounces),
        fingerprint=np.bytes_(_fingerprint(design, cfg).encode()),
        **extra_arrs,
    )
    os.replace(tmp, path)


def load_checkpoint(
    path: str, design: WaveguideDesign, cfg: TraceConfig,
    with_extras: bool = False,
):
    """Returns (histogram, iterations_done, total_bounces[, extras]) or None on
    a fingerprint mismatch / missing file."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        fp = bytes(data["fingerprint"]).decode()
        if fp != _fingerprint(design, cfg):
            return None
        out = (
            data["histogram"],
            int(data["iterations_done"]),
            int(data["total_bounces"]),
        )
        if with_extras:
            extras = {k[len("extra_"):]: int(data[k])
                      for k in data.files if k.startswith("extra_")}
            return out + (extras,)
        return out
