"""Configuration dataclasses of the port.

The JAX package's ``config`` holds plain dataclasses and imports no JAX, so
the port uses the same classes: a ``TraceConfig`` made for one package is
valid in the other.
"""

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (  # noqa: F401
    EvalConfig,
    TraceConfig,
    WaveguideDesign,
)

__all__ = ["EvalConfig", "TraceConfig", "WaveguideDesign"]
