"""Loading RCWA LUTs from disk (the reference's ``lut_*_fullColor.npy`` files).

File naming follows download_lut.py:13-19 and the loads at
gpu_ray_tracing_pro_fullColor.py:28-34.  Falls back to synthetic LUTs
when files are absent (see :mod:`.synthetic`).  :func:`save_luts` writes
them.  Copied from the JAX package's ``luts/io.py`` without its
``fetch_luts`` download (the port fetches nothing: LUT files go into
``--luts-dir`` by hand).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..design.geometry import DesignGeometry
from .schema import RcwaLuts
from .synthetic import make_synthetic_luts

_FILES = {
    "ic1": "lut_ic1_fullColor.npy",
    "ic2": "lut_ic2_fullColor.npy",
    "ic3": "lut_ic3_fullColor.npy",
    "fc1": "lut_fc1_fullColor.npy",
    "fc2": "lut_fc2_fullColor.npy",
    "oc1": "lut_oc1_fullColor.npy",
    "oc2": "lut_oc2_fullColor.npy",
}


def save_luts(luts: RcwaLuts, directory: str) -> None:
    """Write the seven LUTs to ``directory`` in the reference's exact on-disk
    layout: one ``lut_*_fullColor.npy`` per table (names of download_lut.py:
    13-19), complex dtype, axis order (L, M, N, C) / (S, L, M, N, C) — the
    layout ``np.load``-ed verbatim by the reference's main script
    (gpu_ray_tracing_pro_fullColor.py:28-34).  Round-trips bitwise with
    :func:`load_luts`."""
    os.makedirs(directory, exist_ok=True)
    for key, fname in _FILES.items():
        arr = np.asarray(getattr(luts, key))
        if not np.iscomplexobj(arr):
            raise ValueError(f"lut_{key} must be complex valued")
        np.save(os.path.join(directory, fname), arr, allow_pickle=False)


def load_luts(directory: str, validate: bool = True) -> RcwaLuts:
    """Load the seven full-color LUT files from ``directory``.

    ``validate=True`` (default) runs the standalone file manifest check
    (:func:`validate_lut_manifest`): every wrong-layout file is rejected with
    an error naming the offending file and the expected layout, BEFORE any
    tracing consumes it.  The real Google-Drive RCWA files have never been
    reachable from this environment (download_lut.py:13-19 ids; README.md:80
    says the RCWA content is 'currently unavailable' upstream), so the
    channel/axis contract is inferred from every kernel access (SURVEY §2.5,
    luts/schema.py) — loud validation here is the guard for the day real
    files arrive."""
    arrays = {}
    for key, fname in _FILES.items():
        path = os.path.join(directory, fname)
        try:
            arrays[key] = np.load(path, allow_pickle=False)
        except Exception as e:
            raise ValueError(
                f"{path}: not a loadable .npy file ({e}) — expected the "
                f"reference LUT layout: complex array, "
                f"{_expected_layout(key)}") from e
    if validate:
        validate_lut_manifest(arrays, directory)
    return RcwaLuts(**arrays)


def _expected_layout(key: str) -> str:
    from .schema import CHANNELS

    if key.startswith("ic"):
        return (f"4-D (wavelength L, FoV_x M, FoV_y N, channels >= "
                f"{CHANNELS[key]})")
    return (f"5-D (strip S, wavelength L, FoV_x M, FoV_y N, channels >= "
            f"{CHANNELS[key]})")


def validate_lut_manifest(arrays: dict, directory: str = "<memory>") -> None:
    """Standalone structural validation of a seven-LUT file set.

    Checks, per file: complex dtype, finite values, axis count, channel
    minimum (SURVEY §2.5 / schema.CHANNELS — the max channel each kernel
    access reads, GPU_ray_tracing_functions.py:833-1247); across files:
    one consistent (L, M, N) grid, fc1/fc2 strip counts equal, oc1/oc2
    strip counts equal.  Raises ValueError naming the file and the expected
    layout.  Unlike :meth:`RcwaLuts.validate` this needs no design geometry,
    so it runs at load time on any directory."""
    from .schema import CHANNELS

    grids = {}
    strips = {}
    for key, arr in arrays.items():
        fname = os.path.join(directory, _FILES[key])
        want_nd = 4 if key.startswith("ic") else 5
        if arr.ndim != want_nd:
            raise ValueError(
                f"{fname}: {arr.ndim}-D shape {arr.shape}; expected "
                f"{_expected_layout(key)}"
                + (" — a 3-D array is missing the full-color wavelength "
                   "axis" if key.startswith("ic") and arr.ndim == 3 else ""))
        if not np.iscomplexobj(arr):
            raise ValueError(
                f"{fname}: dtype {arr.dtype} is not complex — LUT channels "
                "hold complex Jones-matrix entries and complex outgoing "
                f"angles; expected {_expected_layout(key)}")
        if arr.shape[-1] < CHANNELS[key]:
            raise ValueError(
                f"{fname}: only {arr.shape[-1]} channels; the tracer reads "
                f"channel {CHANNELS[key] - 1} of lut_{key} "
                f"(schema.CHANNELS — see luts/schema.py for the per-site "
                f"channel map); expected {_expected_layout(key)}")
        if not np.isfinite(arr).all():
            bad = int(np.count_nonzero(~np.isfinite(arr)))
            raise ValueError(
                f"{fname}: {bad} non-finite entries — refusing to trace "
                "with NaN/inf diffraction efficiencies")
        grids[key] = arr.shape[-4:-1]
        if want_nd == 5:
            strips[key] = arr.shape[0]
    if len(set(grids.values())) > 1:
        detail = ", ".join(f"lut_{k}: (L,M,N)={v}" for k, v in grids.items())
        raise ValueError(
            f"inconsistent (wavelength, FoV_x, FoV_y) grids across the LUT "
            f"set in {directory}: {detail} — all seven files must share one "
            "grid")
    for a, b in (("fc1", "fc2"), ("oc1", "oc2")):
        if strips[a] != strips[b]:
            raise ValueError(
                f"strip-count mismatch in {directory}: lut_{a} has "
                f"{strips[a]} strips but lut_{b} has {strips[b]} — the "
                "pre/post-fold (and forward/reversed) tables describe the "
                "same physical strips")


def luts_available(directory: str) -> bool:
    return all(os.path.exists(os.path.join(directory, f)) for f in _FILES.values())


def load_or_synthesize(
    geom: DesignGeometry, directory: Optional[str] = None, seed: int = 1234,
) -> RcwaLuts:
    """Prefer real LUT files when present; otherwise synthesize from the design.

    The port has no download step: the LUT files are placed in ``directory``
    by hand."""
    if directory is not None and luts_available(directory):
        luts = load_luts(directory)
        L, M, N = geom.th_out_ic.shape
        luts.validate(len(geom.fc_strips), len(geom.oc_strips), L, M, N)
        return luts
    return make_synthetic_luts(geom, seed=seed)
