"""Optimizers of the port (device Adam so far)."""

from .adam import Adam
from .base import plan_chunks

__all__ = ["Adam", "plan_chunks"]
