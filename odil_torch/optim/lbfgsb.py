"""L-BFGS-B on the host through scipy (``odil_tpu/optim/lbfgsb.py``, the
reference's default second-order optimizer): the state goes to one float64
numpy vector for ``scipy.optimize.fmin_l_bfgs_b``, and each point it asks
for comes back to the domain's device and dtype for the loss and gradients.
Every iteration crosses between the host and the card."""

from argparse import Namespace

import numpy as np
import torch

from ..runtime import torch_dtype
from .base import EarlyStopError, Optimizer

__all__ = ["LbfgsbOptimizer"]


class LbfgsbOptimizer(Optimizer):

    def __init__(self, pgtol=1e-16, m=50, maxls=50, factr=0, dtype=None, mod=None, **kwargs):
        super().__init__(name="lbfgsb", displayname="L-BFGS-B", dtype=dtype, mod=mod)
        self.pgtol = pgtol if pgtol is not None else 1e-16
        self.m = m
        self.maxls = maxls
        self.factr = factr
        self.epoch = 0

    def run(self, x0, loss_grad=None, epochs=None, callback=None, epoch_start=0, **kwargs):
        from scipy import optimize

        self.epoch = epoch_start
        shapes = [tuple(a.shape) for a in x0]
        sizes = [int(np.prod(s)) for s in shapes]
        bounds = np.cumsum(sizes)[:-1]
        dtype = np.dtype(self.dtype) if self.dtype is not None else x0[0].detach().cpu().numpy().dtype
        device = x0[0].device if torch.is_tensor(x0[0]) else torch.device("cpu")

        def to_arrays(flat):
            parts = np.split(np.asarray(flat, dtype=dtype), bounds)
            return [torch.tensor(p.reshape(s), dtype=torch_dtype(dtype), device=device) for p, s in zip(parts, shapes)]

        def to_flat(arrays):
            return np.concatenate([
                (a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)).astype(np.float64).reshape(-1)
                for a in arrays
            ])

        def objective(flat):
            self.evals += 1
            loss, grads, pinfo = loss_grad(to_arrays(flat))
            self.pinfo = pinfo
            return np.asarray(loss, dtype=np.float64), to_flat(grads)

        def iteration_callback(flat):
            self.epoch += 1
            if callback:
                callback(to_arrays(flat), self.epoch, self.pinfo)

        x, f, sinfo = optimize.fmin_l_bfgs_b(
            func=objective,
            x0=to_flat(x0),
            maxiter=epochs,
            pgtol=self.pgtol,
            m=self.m,
            maxls=self.maxls,
            factr=self.factr,
            maxfun=np.inf,
            callback=iteration_callback,
        )
        optinfo = Namespace(
            warnflag=sinfo["warnflag"],
            task=sinfo["task"],
            evals=sinfo["funcalls"],
            epochs=sinfo["nit"],
        )
        if optinfo.warnflag not in (0, 1) or optinfo.epochs < epochs:
            detail = ", ".join(f"{k}={sinfo.get(k, '')}" for k in ("warnflag", "task", "funcalls", "nit"))
            raise EarlyStopError(detail, optinfo)
        return to_arrays(x), optinfo
