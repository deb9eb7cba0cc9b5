from .geometry import DesignGeometry, generate_geometry  # noqa: F401
from . import convex  # noqa: F401
