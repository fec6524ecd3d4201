"""odil_torch: the PyTorch/CUDA port of odil_tpu for one NVIDIA H100.

``import odil_torch as odil`` gives the same surface as the JAX package for
the ported slice.  Tensors live on the card unless the caller asks for the
CPU (``Domain(..., device="cpu")``); on the CPU the kernels run their plain
PyTorch versions.
"""

from . import runtime
from .core import Array, Context, Domain, Field, MultigridField, NeuralNet, Problem, State
from .transfer import interp_to_finer, restrict_to_coarser

__all__ = [
    "Array",
    "Context",
    "Domain",
    "Field",
    "MultigridField",
    "NeuralNet",
    "Problem",
    "State",
    "interp_to_finer",
    "restrict_to_coarser",
    "runtime",
]
