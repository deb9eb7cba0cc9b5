from .design_sweep import SweepResult, run_design_sweep_persistent  # noqa: F401
