"""Helpers of the row-wise kernels shared with the multigrid-fused kernel
(``odil_tpu/ops/rowwise.py:58-69``), as plain torch.  The generic row-wise
kernels themselves are a later slice of the port."""

import torch

__all__ = ["_sumsq_vec", "_weights_of"]


def _sumsq_vec(res):
    """(nterms,) per-term sums of squares."""
    return torch.stack([torch.sum(r * r) for r in res])


def _weights_of(gvec, res, nterms):
    """w[k] = 2 * g[k] * res[k]: the cotangents of sum_k g[k] * sum(res[k]^2)."""
    return tuple(2.0 * gvec[k] * res[k] for k in range(nterms))
