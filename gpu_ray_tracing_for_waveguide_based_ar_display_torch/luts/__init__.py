from .schema import RcwaLuts, CHANNELS  # noqa: F401
from .synthetic import make_synthetic_luts  # noqa: F401
from .io import load_luts, load_or_synthesize, luts_available  # noqa: F401
