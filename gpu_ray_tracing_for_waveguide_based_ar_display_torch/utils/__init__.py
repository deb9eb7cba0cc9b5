from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .profiling import Timers, torch_trace  # noqa: F401
