from .metrics import (  # noqa: F401
    EvalResult, evaluate, evaluate_batch, evaluate_torch, efficiencies,
)
from . import color  # noqa: F401
