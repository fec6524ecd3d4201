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

``AdamOptimizer`` is the registry's optimizer over ``Adam``, with the
semantics of ``odil_tpu/optim/adam.py``: the chunked device loop when a loss
function is bound (``util.optimize_grad``), an eager loop over a
``loss_grad`` callable otherwise, and slots that resume.
"""

import math
from argparse import Namespace

import numpy as np
import torch

from .base import Optimizer, plan_chunks

__all__ = ["Adam", "AdamOptimizer"]


def _alpha(lr, b1, b2, t):
    """The bias-corrected step in float32, as the JAX loop computes it."""
    f = np.float32
    tt = f(t)
    return float(f(lr) * np.sqrt(f(1) - f(b2) ** tt) / (f(1) - f(b1) ** tt))


class Adam:

    def __init__(
        self, grad_fn, arrays, lr=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7, slot_dtype=None, epoch=0
    ):
        """grad_fn(arrays, tracers) -> ((loss, (terms, norms)), grads), e.g.
        ``Problem.make_loss_grad_fn``; arrays: the initial parameters (copied
        into ``self.x``, which the updates change in place); epoch: the
        absolute epoch before the first update (the operator sees it as
        ``tracers["epoch"]``)."""
        self.grad_fn = grad_fn
        self.x = [a.detach().clone() for a in arrays]
        self.lr, self.b1, self.b2, self.eps = lr, beta_1, beta_2, epsilon
        self.slot_dtype = slot_dtype or self.x[0].dtype
        self.m = [torch.zeros_like(a, dtype=self.slot_dtype) for a in self.x]
        self.v = [torch.zeros_like(a, dtype=self.slot_dtype) for a in self.x]
        self.step = 0  # updates done, for the bias correction
        self.epoch = epoch
        self.last = None  # (terms, norms) of the last step, stacked, on the device
        self._steps = torch.zeros((), dtype=torch.float32, device=self.x[0].device)

    def resume(self, step, m=None, v=None):
        """Continues the bias correction after `step` updates and, where
        given, the moments (tensors or numpy arrays) of a checkpoint."""
        self.step = int(step)
        self._steps.fill_(self.step)
        for mine, saved in ((self.m, m), (self.v, v)):
            if saved is not None:
                for a, b in zip(mine, saved):
                    a.copy_(_as_tensor(b, a))

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
            tracers["epoch"] = self.epoch
            (loss, (terms, norms)), grads = self.grad_fn(self.x, tracers)
            losses[i] = loss
            self._update(grads)
            self.epoch += 1
        if n:
            self.last = (torch.stack(list(terms)), torch.stack(list(norms)))
        return losses

    def run(self, epochs, task_epochs=None, max_chunk=512, tracers=None):
        """Runs `epochs` epochs in chunks ending at each task epoch; yields
        (epoch at the chunk's end, its (n,) device losses)."""
        epoch = self.epoch
        for n in plan_chunks(epoch, epochs, task_epochs, max_chunk):
            losses = self.run_chunk(n, tracers)
            epoch += n
            yield epoch, losses


def _as_tensor(a, like):
    """`a` (a tensor or a numpy array, a bfloat16 one included) on the
    device and in the dtype of `like`."""
    if not torch.is_tensor(a):
        a = np.asarray(a)
        if a.dtype.kind != "f" or a.dtype.itemsize < 4:  # bfloat16 and other narrow types
            a = a.astype(np.float32)
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=like.device, dtype=like.dtype)


class AdamOptimizer(Optimizer):

    def __init__(self, dtype=None, mod=None, slot_dtype=None, **kwargs):
        """slot_dtype: storage dtype of the m/v slots (e.g. torch.bfloat16);
        the updates compute in the parameter dtype.  Default: the parameter
        dtype."""
        super().__init__(name="adamn", displayname="AdamNative", dtype=dtype, mod=mod)
        self.slot_dtype = slot_dtype

    def run(
        self, x0, loss_grad=None, epochs=None, callback=None, lr=1e-3, epoch_start=0, beta_1=0.9, beta_2=0.999,
        epsilon=1e-7, init_slots=None, **kwargs,
    ):
        if self.loss_fn is not None:
            return self._run_device(x0, epochs, callback, lr, epoch_start, beta_1, beta_2, epsilon, init_slots)
        return self._run_eager(x0, loss_grad, epochs, callback, lr, epoch_start, beta_1, beta_2, epsilon)

    def _run_device(self, x0, epochs, callback, lr, epoch_start, beta_1, beta_2, epsilon, init_slots=None):
        """Chunks of epochs, each ending at a task epoch; the callback sees
        the last step's loss, terms and norms.  The bias correction
        continues from the checkpoint's step count."""
        opt = Adam(self._grad_fn(), x0, lr, beta_1, beta_2, epsilon, slot_dtype=self.slot_dtype, epoch=epoch_start)
        slots = init_slots or {}
        step0 = int(slots.get("step", 0))
        opt.resume(step0, slots.get("m"), slots.get("v"))
        epoch = epoch_start
        for n in self._chunks(epoch_start, epochs):
            losses = opt.run_chunk(n, self.tracers)
            self.evals += n
            self.slots = {"m": opt.m, "v": opt.v, "step": step0 + (epoch + n - epoch_start)}
            terms, norms = opt.last
            self._emit(callback, opt.x, epoch, (losses, terms[None], norms[None]), n)
            epoch += n
        return opt.x, Namespace(epochs=epochs, evals=self.evals)

    def _run_eager(self, x0, loss_grad, epochs, callback, lr, epoch_start, beta_1, beta_2, epsilon):
        """The reference's loop over a user loss_grad(arrays) -> (loss,
        grads, pinfo), with the callback after every update (it sees the
        parameters, which the updates change in place).  The moments start
        at zero in the parameter dtype, as the reference's do."""
        opt = Adam(None, x0, lr, beta_1, beta_2, epsilon)
        for epoch in range(epoch_start + 1, epoch_start + epochs + 1):
            self.evals += 1
            loss, grads, pinfo = loss_grad(opt.x)
            opt._update(grads)
            if callback is not None:
                callback(opt.x, epoch, pinfo)
        return opt.x, Namespace(epochs=epochs, evals=self.evals)
