from .grating_opt import (  # noqa: F401
    ApodizationResult,
    GratingOptResult,
    apply_apodization,
    make_apodization_loss,
    make_grating_loss,
    optimize_apodization,
    optimize_grating,
)
