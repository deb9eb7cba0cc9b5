from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
