"""Optimizers of the port: the registry (``make_optimizer``), Adam (device
loop), gradient descent and L-BFGS-B (host, scipy)."""

from .adam import Adam, AdamOptimizer
from .base import EarlyStopError, Optimizer, make_optimizer, plan_chunks

__all__ = ["Adam", "AdamOptimizer", "EarlyStopError", "Optimizer", "make_optimizer", "plan_chunks"]
