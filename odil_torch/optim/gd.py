"""Plain gradient descent (``odil_tpu/optim/gd.py``): the chunked device
loop when a loss function is bound, an eager loop over ``loss_grad``
otherwise."""

from argparse import Namespace

import torch

from .base import Optimizer

__all__ = ["GdOptimizer"]


class GdOptimizer(Optimizer):

    def __init__(self, dtype=None, mod=None, **kwargs):
        super().__init__(name="gd", displayname="GD", dtype=dtype, mod=mod)

    def run(self, x0, loss_grad=None, epochs=None, callback=None, lr=1e-3, epoch_start=0, **kwargs):
        if self.loss_fn is None:
            x = [a.detach().clone() for a in x0]
            for epoch in range(epoch_start + 1, epoch_start + epochs + 1):
                self.evals += 1
                loss, grads, pinfo = loss_grad(x)
                x = [xi - g * lr for xi, g in zip(x, grads)]
                if callback is not None:
                    callback(x, epoch, pinfo)
            return x, Namespace(epochs=epochs, evals=self.evals)

        grad_fn = self._grad_fn()
        x = [a.detach().clone() for a in x0]
        dev = x[0].device
        tracers = dict(self.tracers)
        epoch = epoch_start
        for n in self._chunks(epoch_start, epochs):
            losses = torch.empty((n,), dtype=x[0].dtype, device=dev)
            for i in range(n):
                tracers["epoch"] = epoch + i
                (loss, (terms, norms)), grads = grad_fn(x, tracers)
                losses[i] = loss
                torch._foreach_add_(x, [g.contiguous() for g in grads], alpha=-lr)
            self.evals += n
            stacked = (losses, torch.stack(list(terms))[None], torch.stack(list(norms))[None])
            self._emit(callback, x, epoch, stacked, n)
            epoch += n
        return x, Namespace(epochs=epochs, evals=self.evals)
