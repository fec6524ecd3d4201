"""Model operators of the port: the flagship velocity_from_tracer, heat
(inverse conductivity by the ODIL and PINN solvers, and tmax inference),
wave data assimilation, Poisson source inversion and advection-diffusion
coefficient inference."""

from . import advection, heat, poisson, veltracer, wave

__all__ = ["advection", "heat", "poisson", "veltracer", "wave"]
