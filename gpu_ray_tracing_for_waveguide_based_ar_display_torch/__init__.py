"""PyTorch + CUDA port of the waveguide AR display ray tracer.

The JAX package ``gpu_ray_tracing_for_waveguide_based_ar_display_tpu`` is the
reference; this package runs its main path (the persistent count-spawn trace
of the paper design) on an NVIDIA GPU through one hand-written CUDA kernel
(``csrc/persistent_trace.cu``).  Module names mirror the JAX package's, so each
port has an obvious counterpart.  The numpy-only parts of the JAX package
(design geometry, LUTs, cell tables, trace geometry, host metrics) are imported
from it unchanged; nothing here imports ``jax``.  Importing those modules runs
the JAX package's ``__init__``, which opts the process out of transparent huge
pages (set ``GRT_KEEP_THP=1`` to keep them); the port's host timings are taken
under that setting.
"""

__version__ = "0.1.0"
