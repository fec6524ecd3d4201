"""odil_torch: the PyTorch/CUDA port of odil_tpu for one NVIDIA H100.

``import odil_torch as odil`` gives the same surface as the JAX package for
the ported slice, the training harness included (``optimize``,
``make_callback``, ``setup_outdir``, ``History``).  Tensors live on the card
unless the caller asks for the CPU (``Domain(..., device="cpu")``, or
``--device cpu`` on the command line); on the CPU the kernels run their
plain PyTorch versions.
"""

from . import runtime
from . import backend, cache, linsolver, parallel
from .core import Array, Context, Domain, Field, MultigridField, NeuralNet, Problem, State
from .grid import latin_hypercube
from .history import History
from .io import parse_raw_xmf, read_raw, read_raw_with_xmf, write_raw_with_xmf, write_raw_xmf, write_vtk_poly
from .optim import EarlyStopError
from .stencil import Approx, struct_to_numpy
from .transfer import interp_to_finer, restrict_to_coarser
from .util import make_callback, optimize, printlog, set_log_file, setup_outdir
from . import util

__all__ = [
    "Approx",
    "Array",
    "Context",
    "Domain",
    "EarlyStopError",
    "Field",
    "History",
    "MultigridField",
    "NeuralNet",
    "Problem",
    "State",
    "backend",
    "cache",
    "interp_to_finer",
    "latin_hypercube",
    "linsolver",
    "make_callback",
    "optimize",
    "parallel",
    "parse_raw_xmf",
    "printlog",
    "read_raw",
    "read_raw_with_xmf",
    "restrict_to_coarser",
    "runtime",
    "set_log_file",
    "setup_outdir",
    "struct_to_numpy",
    "util",
    "write_raw_with_xmf",
    "write_raw_xmf",
    "write_vtk_poly",
]
