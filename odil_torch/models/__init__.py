"""Model operators of the port: the flagship velocity_from_tracer, heat
inverse conductivity (the ODIL solver) and wave data assimilation."""

from . import heat, veltracer, wave

__all__ = ["heat", "veltracer", "wave"]
