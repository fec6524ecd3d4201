"""Device Adam: chunks of epochs run without a host sync per epoch.

The update is the one of ``bench.py:116-126`` and ``odil_tpu/optim/adam.py``
(the reference AdamNative): ``alpha = lr * sqrt(1 - b2^t) / (1 - b1^t)``,
``m += (g - m) * (1 - b1)``, ``v += (g^2 - v) * (1 - b2)``,
``x -= m * alpha / (sqrt(v) + eps)``, with the moments stored in
``slot_dtype`` (e.g. ``torch.bfloat16``) and updated in the parameter
dtype.  The parameters and slots are updated in place.  Per-epoch losses
stay on the device until the chunk ends, so the host waits for the card
once per chunk.

With slots in the parameter dtype the update is one pass of PyTorch's
fused Adam (``torch._fused_adam_``), which computes
``x -= lr/(1-b1^t) * m / (sqrt(v)/sqrt(1-b2^t) + eps')``; with
``eps' = eps / sqrt(1-b2^t)`` that is the update above, reassociated.  The
one pass replaces six multi-tensor passes, which took the card longer than
the fused row kernel (``chip_smoke.py``'s profile).  Narrower slots (bf16)
take the multi-tensor form, which widens them.
"""

import math

import numpy as np
import torch

from .base import plan_chunks

__all__ = ["Adam"]


def _alpha(lr, b1, b2, t):
    """The bias-corrected step in float32, as the JAX loop computes it."""
    f = np.float32
    tt = f(t)
    return float(f(lr) * np.sqrt(f(1) - f(b2) ** tt) / (f(1) - f(b1) ** tt))


class Adam:

    def __init__(self, grad_fn, arrays, lr=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7, slot_dtype=None):
        """grad_fn(arrays, tracers) -> ((loss, (terms, norms)), grads), e.g.
        ``Problem.make_loss_grad_fn``; arrays: the initial parameters (copied
        into ``self.x``, which the updates change in place)."""
        self.grad_fn = grad_fn
        self.x = [a.detach().clone() for a in arrays]
        self.lr, self.b1, self.b2, self.eps = lr, beta_1, beta_2, epsilon
        self.slot_dtype = slot_dtype or self.x[0].dtype
        self.m = [torch.zeros_like(a, dtype=self.slot_dtype) for a in self.x]
        self.v = [torch.zeros_like(a, dtype=self.slot_dtype) for a in self.x]
        self.step = 0
        self._steps = torch.zeros((), dtype=torch.float32, device=self.x[0].device)

    def _update(self, grads):
        self.step += 1
        # The fused kernel takes gradients of the parameters' layout; autograd
        # may give a transposed one (a net's square weight).
        grads = [g.contiguous() for g in grads]
        if self.slot_dtype == self.x[0].dtype:
            self._steps += 1
            torch._fused_adam_(
                self.x, list(grads), self.m, self.v, [], [self._steps] * len(self.x),
                lr=self.lr, beta1=self.b1, beta2=self.b2, weight_decay=0.0,
                eps=self.eps / math.sqrt(1 - self.b2**self.step), amsgrad=False, maximize=False,
            )
            return
        alpha = _alpha(self.lr, self.b1, self.b2, self.step)
        m = [a.to(self.x[0].dtype) for a in self.m]
        v = [a.to(self.x[0].dtype) for a in self.v]
        torch._foreach_lerp_(m, grads, 1 - self.b1)
        torch._foreach_lerp_(v, torch._foreach_mul(grads, grads), 1 - self.b2)
        den = torch._foreach_sqrt(v)
        torch._foreach_add_(den, self.eps)
        torch._foreach_addcdiv_(self.x, m, den, value=-alpha)
        torch._foreach_copy_(self.m + self.v, m + v)

    def run_chunk(self, n, tracers=None):
        """Runs n epochs; returns the (n,) losses on the device (loss i is
        evaluated before update i, like the JAX loop's scan outputs)."""
        tracers = dict(tracers or {})
        losses = torch.empty((n,), dtype=self.x[0].dtype, device=self.x[0].device)
        for i in range(n):
            tracers["epoch"] = self.step
            (loss, _), grads = self.grad_fn(self.x, tracers)
            losses[i] = loss
            self._update(grads)
        return losses

    def run(self, epochs, task_epochs=None, max_chunk=512, tracers=None):
        """Runs `epochs` epochs in chunks ending at each task epoch; yields
        (epoch at the chunk's end, its (n,) device losses)."""
        epoch = self.step
        for n in plan_chunks(epoch, epochs, task_epochs, max_chunk):
            losses = self.run_chunk(n, tracers)
            epoch += n
            yield epoch, losses
