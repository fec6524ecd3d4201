"""Optimizer base class, registry and the chunk planner of the epoch loop.

PyTorch counterpart of ``odil_tpu/optim/base.py``: ``Optimizer.bind``
installs the loss function and the callback schedule (the "task epochs",
where the callback has work), ``_chunks`` plans runs of epochs that end at
each task epoch, and ``_emit`` feeds the callback once a chunk ends.  The
per-epoch losses of a chunk stay on the device until then, so the host
waits for the card once per chunk.
"""

from argparse import Namespace

import numpy as np
import torch

__all__ = ["Optimizer", "EarlyStopError", "make_optimizer", "plan_chunks"]


class EarlyStopError(Exception):
    """Raised when an optimizer converges before the epoch budget."""

    def __init__(self, msg, optinfo):
        super().__init__(msg)
        self.optinfo = optinfo


def _host(x):
    """A tensor (or anything array-like) as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def autograd_loss_grad_fn(loss_fn):
    """``fn(arrays, tracers) -> ((loss, (terms, norms)), grads)`` by autograd
    of ``loss_fn(arrays, tracers) -> (loss, (terms, norms))``, the results
    detached."""

    def fn(arrays, tracers):
        leaves = [a.detach().requires_grad_(True) for a in arrays]
        with torch.enable_grad():
            loss, (terms, norms) = loss_fn(leaves, tracers)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, grads)]
        return (loss.detach(), ([t.detach() for t in terms], [n.detach() for n in norms])), grads

    return fn


class Optimizer:

    def __init__(self, name=None, displayname=None, dtype=None, mod=None):
        self.name = name
        self.displayname = displayname if displayname is not None else name
        self.dtype = dtype
        self.mod = mod
        self.pinfo = None
        self.evals = 0
        self.slots = None  # Slot state (Adam moments, ...) for checkpoints.
        # Device-loop context, installed by util.optimize_grad via bind().
        self.loss_fn = None  # (arrays, tracers) -> (loss, (terms, norms)), differentiable by autograd.
        self.loss_grad_fn = None  # Optional fused loss+grad (see bind()).
        self.tracers = None  # Tracer template; 'epoch' is set in the loop.
        self.task_epochs = None  # Sorted epochs at which the callback must run.
        # The arrays whole from this process's blocks and back (identities
        # unless the state is held in blocks over several processes).
        self.whole = self.blocks = list

    def bind(self, loss_fn, tracers=None, task_epochs=None, names=None, max_chunk=512, loss_grad_fn=None,
             whole=None, blocks=None):
        """Installs the loss function and the callback schedule.

        loss_grad_fn: optional fused (arrays, tracers) ->
        ((loss, (terms, norms)), grads), e.g. ``Problem.make_loss_grad_fn``;
        gradient optimizers use it when set, and autograd of loss_fn
        otherwise.  whole, blocks: where the arrays are this process's
        blocks of a state over several processes, the maps from the blocks
        to the whole arrays (a collective, ``parallel.gather_state_arrays``)
        and back (``parallel.shard_state_arrays``); the optimizers that work
        on whole vectors (L-BFGS) use them."""
        self.loss_fn = loss_fn
        self.whole = whole or list
        self.blocks = blocks or list
        self.loss_grad_fn = loss_grad_fn
        self.tracers = dict(tracers) if tracers else dict()
        self.task_epochs = task_epochs
        self._task_set = set(task_epochs) if task_epochs is not None else None
        self._names = names
        self._max_chunk = max_chunk
        return self

    def run(self, x0, loss_grad=None, epochs=None, callback=None, epoch_start=0, **kwargs):
        optinfo = Namespace()
        optinfo.evals = 0
        optinfo.epochs = 0
        return x0, optinfo

    # -- Shared helpers -----------------------------------------------------

    def _grad_fn(self):
        return self.loss_grad_fn or autograd_loss_grad_fn(self.loss_fn)

    def _chunks(self, epoch_start, epochs, max_chunk=None):
        if max_chunk is None:
            max_chunk = getattr(self, "_max_chunk", 512)
        return plan_chunks(epoch_start, epochs, self.task_epochs, max_chunk)

    def _emit(self, callback, arrays, epoch_lo, stacked, nsteps):
        """Feeds the callback for the task epoch that ends a finished chunk.

        stacked: (losses, terms, norms); losses of shape (nsteps,), terms
        and norms of shape (k, nterms) whose last row is the chunk's last
        step (k = nsteps in the JAX package's scan outputs, 1 where the loop
        keeps only that row).  Only the final epoch of a chunk is a task
        epoch by construction, so the state `arrays` is exact for it."""
        if callback is None:
            return
        epoch = epoch_lo + nsteps
        if self._task_set is not None and epoch not in self._task_set:
            return
        losses, terms, norms = stacked
        pinfo = {
            "loss": _host(losses)[nsteps - 1],
            "terms": list(_host(terms)[-1]),
            "norms": list(_host(norms)[-1]),
            "names": self._names,
        }
        self.pinfo = pinfo
        callback(arrays, epoch, pinfo)


def plan_chunks(epoch_start, epochs, task_epochs, max_chunk=512):
    """Yields chunk lengths so that every task epoch ends a chunk.

    task_epochs: sorted iterable of absolute epochs in
    (epoch_start, epoch_start + epochs] needing the host; None means every
    epoch does (chunk size 1)."""
    end = epoch_start + epochs
    e = epoch_start
    if task_epochs is None:
        while e < end:
            yield 1
            e += 1
        return
    tasks = [t for t in task_epochs if epoch_start < t <= end]
    for t in tasks:
        while e < t:
            n = min(t - e, max_chunk)
            yield n
            e += n
    while e < end:
        n = min(end - e, max_chunk)
        yield n
        e += n


def make_optimizer(name, dtype=None, mod=None, **kwargs):
    from .adam import AdamOptimizer
    from .gd import GdOptimizer
    from .lbfgs import LbfgsOptimizer
    from .lbfgsb import LbfgsbOptimizer

    if name == "lbfgsb":
        return LbfgsbOptimizer(dtype=dtype, mod=mod, **kwargs)
    if name == "lbfgs":
        return LbfgsOptimizer(dtype=dtype, mod=mod, **kwargs)
    if name in ("adam", "adamn", "adam_tf"):
        return AdamOptimizer(dtype=dtype, mod=mod, **kwargs)
    if name == "gd":
        return GdOptimizer(dtype=dtype, mod=mod, **kwargs)
    # newton, gn and newton_mf are drivers of util.optimize, not registry entries.
    raise ValueError(f"Unknown optimizer '{name}'")
