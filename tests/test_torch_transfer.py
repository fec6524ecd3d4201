"""The port's multigrid transfer operators against the JAX package's, on the
CPU: same numpy inputs through both, fp64 to rtol 1e-10 and fp32 to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch import interp_to_finer, restrict_to_coarser
from odil_torch.transfer import _interp_matrix
from odil_tpu import transfer as jtransfer

CASES = [
    ("c", (8,)),
    ("n", (9,)),
    ("cc", (6, 4)),
    ("ncc", (5, 8, 6)),
    (".cc", (3, 4, 6)),
    ("n.c", (5, 3, 4)),
]


@pytest.mark.parametrize("loc,shape", CASES)
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-6)])
@pytest.mark.parametrize("method", ["conv", "matmul"])
def test_interp_matches_jax(loc, shape, dtype, rtol, method):
    """The dense per-axis products, under each method name the JAX package
    takes, against the JAX package's stencils."""
    u = np.random.default_rng(3).normal(size=shape).astype(dtype)
    want = np.asarray(jtransfer.interp_to_finer(jnp.asarray(u), loc))
    got = interp_to_finer(torch.as_tensor(u), loc, method=method).numpy()
    assert got.shape == want.shape and got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def _fine_shape(shape, loc):
    return tuple(2 * n if l == "c" else 2 * (n - 1) + 1 if l == "n" else n for n, l in zip(shape, loc))


@pytest.mark.parametrize("loc,shape", CASES)
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-6)])
def test_restrict_matches_jax(loc, shape, dtype, rtol):
    u = np.random.default_rng(4).normal(size=_fine_shape(shape, loc)).astype(dtype)
    want = np.asarray(jtransfer.restrict_to_coarser(jnp.asarray(u), loc))
    got = restrict_to_coarser(torch.as_tensor(u), loc).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("loc", ["c", "n"])
def test_exact_on_linear_fields(loc):
    """Both transfers are exact on linear fields, edges included (the
    linear-extrapolation ghosts), as in the JAX package's test_transfer."""
    n = 8 if loc == "c" else 9
    xc = (np.arange(n) + 0.5) / n if loc == "c" else np.arange(n) / (n - 1)
    nf = 2 * n if loc == "c" else 2 * (n - 1) + 1
    xf = (np.arange(nf) + 0.5) / nf if loc == "c" else np.arange(nf) / (nf - 1)
    lin = lambda x: 0.3 + 1.7 * x
    fine = interp_to_finer(torch.as_tensor(lin(xc)), loc).numpy()
    np.testing.assert_allclose(fine, lin(xf), rtol=1e-12, atol=1e-12)
    coarse = restrict_to_coarser(torch.as_tensor(lin(xf)), loc).numpy()
    np.testing.assert_allclose(coarse, lin(xc), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,loc", [(4, "c"), (16, "c"), (5, "n")])
def test_interp_matrix_matches_jax(n, loc):
    np.testing.assert_array_equal(_interp_matrix(n, loc), jtransfer._interp_matrix(n, loc, np.float64))
