"""PyTorch + CUDA port of the waveguide AR display ray tracer.

The JAX package beside this one (the ``..._tpu`` package) is the
reference; this package runs its paths on an NVIDIA GPU: the persistent
trace (``simulate``, ``sweep``) and the per-cell trace (``simulate --engine
cell``) through hand-written CUDA kernels (``csrc/``), the vector tracer
(``simulate`` / ``sweep --engine vector``) and the exact splitting engine
(``simulate --engine splitting``) in plain PyTorch.  Module names mirror the
JAX package's, so each port has an obvious counterpart.  The host
modules (config, presets, design geometry, LUTs, cell tables, trace geometry,
colorimetry, host metrics, image output) are the port's own copies of the
JAX package's numpy code, bitwise equal in what they compute; the package
imports neither ``jax`` nor the JAX package.

Importing the package opts the process out of transparent huge pages (see
:func:`_disable_thp_first_touch`; set ``GRT_KEEP_THP=1`` to keep them), as the
JAX package does: the port's host timings are taken under that setting.
"""

__version__ = "0.2.0"


def _disable_thp_first_touch() -> None:
    """Opt this process out of transparent huge pages (Linux).

    On shared-hypervisor hosts the *first touch* of a fresh anonymous 2 MB
    huge page can cost tens of milliseconds, so touching a few hundred MB of
    new numpy host buffers (geometry, tables, seeds) costs seconds.  With THP
    disabled the same first touch runs at 4 KB-page speed.  Set
    ``GRT_KEEP_THP=1`` to keep THP (e.g. on hosts with healthy huge-page
    allocation).
    """
    import os
    import sys

    if os.environ.get("GRT_KEEP_THP") == "1" or not sys.platform.startswith(
            "linux"):
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(41, 1, 0, 0, 0)  # PR_SET_THP_DISABLE
    except Exception:  # pragma: no cover - best effort
        pass


_disable_thp_first_touch()
