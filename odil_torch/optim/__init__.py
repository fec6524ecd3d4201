"""Optimizers of the port: the registry (``make_optimizer``), Adam (device
loop), gradient descent, L-BFGS with a zoom line search (device memory and
iterate, the search's branches on the host) and L-BFGS-B (host, scipy)."""

from .adam import Adam, AdamOptimizer
from .base import EarlyStopError, Optimizer, make_optimizer, plan_chunks
from .lbfgs import LbfgsOptimizer

__all__ = ["Adam", "AdamOptimizer", "EarlyStopError", "LbfgsOptimizer", "Optimizer", "make_optimizer", "plan_chunks"]
