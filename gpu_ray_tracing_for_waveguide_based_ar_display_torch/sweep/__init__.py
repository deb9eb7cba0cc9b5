from .design_sweep import (  # noqa: F401
    SweepResult, run_design_sweep, run_design_sweep_persistent,
)
