"""The port's CUDA kernels and its card-only route against their plain
PyTorch versions.  These tests need an NVIDIA card and skip without one.
This file imports neither JAX nor the JAX package, so that it runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: sums rtol 1e-5; gradients rtol 1e-4 with atol 1e-6 * max|ref|
(fp32, different summation order)."""

import numpy as np
import pytest
import torch

from odil_torch.convert import arrays_from_numpy
from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowwise_mg as trmg

pytestmark = pytest.mark.gpu

STEP = (1.0 / 8, 1.0 / 64, 1.0 / 48)
K = dict(kimp=10.0, kxreg=0.01, ktreg=1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol, atol_frac):
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * max(1.0, float(np.abs(want).max())))


def _model(flags):
    dt, dx, dy = STEP
    return trmg.RowModel(
        tvt._make_row_fn(dt, dx, dy, **flags), tvt._make_row_vjp(dt, dx, dy, **flags),
        cuda_model="veltracer", scalars=dict(dt=dt, dx=dx, dy=dy, **flags),
    )


def _inputs(device, T=17, X=64, Y=48, seed=11):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=device)
    t0s = tuple(mk(T, X, Y) for _ in range(3))
    coarse = tuple(mk(T // 2 + 1, X // 2, Y // 2) for _ in range(3))
    consts = tuple(mk(X, Y) for _ in range(2))
    return t0s, coarse, consts


@pytest.mark.parametrize("with_sums", [True, False])
@pytest.mark.parametrize("flags", [K, dict(kimp=3.0, kxreg=0.0, ktreg=0.0)], ids=["all_terms", "no_reg"])
def test_cuda_kernels_match_plain(cuda, with_sums, flags):
    model = _model(flags)
    nterms = 2 + (2 if flags["kxreg"] else 0) + (2 if flags["ktreg"] else 0)
    t0s, coarse, consts = _inputs(cuda)
    f0s = (0.7, 1.1, 0.9)
    cells = t0s[0].numel()
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / cells
    k = trmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, with_sums)
    p = trmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, with_sums)
    for a, b in zip(k[0] + k[1], p[0] + p[1]):
        _close(a, b, 1e-4, 1e-6)
    if with_sums:
        _close(k[2], p[2], 1e-5, 0.0)
    fk = trmg.forward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts)
    fp = trmg._forward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts)
    _close(fk, fp, 1e-5, 0.0)


@pytest.mark.parametrize("shape", [(9, 16, 16), (5, 4, 4), (7, 8, 36)])
def test_cuda_kernels_match_plain_small_planes(cuda, shape):
    """Planes narrower than a tile (8 x 32 cells plus a halo of 2): the halo
    wraps more than once around the plane."""
    model = _model(K)
    t0s, coarse, consts = _inputs(cuda, *shape)
    f0s = (0.7, 1.1, 0.9)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / t0s[0].numel()
    k = trmg.backward_mg_cuda(model, 6, 1, f0s, t0s, coarse, consts, g, True)
    p = trmg._backward_mg_plain(model, 6, 1, f0s, t0s, coarse, consts, g, True)
    for a, b in zip(k[0] + k[1], p[0] + p[1]):
        _close(a, b, 1e-4, 1e-6)
    _close(k[2], p[2], 1e-5, 0.0)
    _close(trmg.forward_mg_cuda(model, 6, 1, f0s, t0s, coarse, consts),
           trmg._forward_mg_plain(model, 6, 1, f0s, t0s, coarse, consts), 1e-5, 0.0)


def test_cuda_loss_terms_autograd_match_plain(cuda):
    """rowwise_loss_terms_mg on the card (forward kernel, backward kernel with
    the sums off) against the same function on the CPU (plain versions)."""
    model = _model(K)
    results = []
    for device in (cuda, torch.device("cpu")):
        t0s, coarse, consts = _inputs(device, seed=3)
        leaves = [t.clone().requires_grad_(True) for t in t0s + coarse]
        terms = trmg.rowwise_loss_terms_mg(model, leaves[:3], leaves[3:], (1.0, 0.5, 2.0), consts, nterms=6, hist=1)
        loss = sum(w * t for w, t in zip((1.0, 0.5, 2.0, 1.0, 0.3, 0.7), terms))
        results.append((terms, torch.autograd.grad(loss, leaves)))
    (kt, kg), (pt, pg) = results
    for a, b in zip(kt, pt):
        _close(a, b, 1e-5, 0.0)
    for a, b in zip(kg, pg):
        _close(a, b, 1e-4, 1e-6)


def test_cuda_wrappers_refuse_other_models_and_types(cuda):
    t0s, coarse, consts = _inputs(cuda)
    with pytest.raises(NotImplementedError):
        trmg.forward_mg_cuda(trmg.RowModel(_model(K).row_fn), 6, 1, (1.0,) * 3, t0s, coarse, consts)
    with pytest.raises(TypeError):
        trmg.forward_mg_cuda(_model(K), 6, 1, (1.0,) * 3, tuple(t.double() for t in t0s), coarse, consts)
    t0s, coarse, consts = _inputs(cuda, 5, 2, 4)
    with pytest.raises(ValueError):
        trmg.forward_mg_cuda(_model(K), 6, 1, (1.0,) * 3, t0s, coarse, consts)


def test_cuda_route_matches_cpu_route(cuda):
    """On the card, make_loss_grad_fn runs the CUDA backward kernel once per
    call and the CUDA-graph prologue; it gives the CPU route's terms and
    gradients call after call (the graph's buffers are copied out)."""
    size = dict(nt=8, nx=32, ny=32)
    cp, cs, _ = tvt.build(kernel="pallas_mg", device="cpu", **size)
    gp, gs, _ = tvt.build(kernel="pallas_mg", device=cuda, **size)
    rng = np.random.default_rng(5)
    shapes = [tuple(a.shape) for a in cp.domain.arrays_from_state(cs)]
    states = [[(0.3 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(2)]
    cfn, gfn = cp.make_loss_grad_fn(cs), gp.make_loss_grad_fn(gs)
    launches = trmg.backward_mg_cuda.launches
    outs = [gfn(arrays_from_numpy(a, device=cuda), gp.tracers) for a in states]
    assert trmg.backward_mg_cuda.launches == launches + 2
    for arrays, ((_, (gterms, _)), ggrads) in zip(states, outs):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), cp.tracers)
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)
