from .presets import PRESETS, get, paper_default  # noqa: F401
