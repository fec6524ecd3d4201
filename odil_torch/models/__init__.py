"""Model operators of the port (the flagship velocity_from_tracer so far)."""

from . import veltracer

__all__ = ["veltracer"]
