"""Core re-exports (mirrors ``odil_tpu/core.py``)."""

from .checkpoint import checkpoint_load, checkpoint_save
from .context import Context
from .fields import Array, Field, MultigridField, NeuralNet, State
from .grid import Domain
from .problem import Problem

__all__ = [
    "Array", "Context", "Domain", "Field", "MultigridField", "NeuralNet", "Problem", "State", "checkpoint_load",
    "checkpoint_save",
]
