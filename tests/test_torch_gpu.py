"""The port's CUDA kernels and its card-only route against their plain
PyTorch versions.  These tests need an NVIDIA card and skip without one.
This file imports neither JAX nor the JAX package, so that it runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: sums rtol 1e-5; gradients rtol 1e-4 with atol 1e-6 * max|ref|
(fp32, different summation order)."""

import hashlib

import numpy as np
import pytest
import torch

from odil_torch.context import Context
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import heat as tht
from odil_torch.models import veltracer as tvt
from odil_torch.models import wave as twv
from odil_torch.ops import rowwise as trw
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


# -- The generic row-wise kernels (csrc/rowwise.cu) -----------------------------


def _fields(device, T, X, Y, seed=13):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=device)
    return tuple(mk(T, X, Y) for _ in range(3)), tuple(mk(X, Y) for _ in range(2))


@pytest.mark.parametrize("flags", [K, dict(kimp=3.0, kxreg=0.0, ktreg=0.0)], ids=["all_terms", "no_reg"])
@pytest.mark.parametrize("shape", [(9, 16, 16), (8, 16, 16), (5, 4, 4), (6, 4, 4), (7, 8, 36), (2, 3, 5), (17, 64, 48)])
def test_generic_kernels_match_plain(cuda, shape, flags):
    """Forward, backward+sums and backward against their plain versions: T
    even and odd (down to 2), planes narrower than a tile (the halo wraps
    more than once) and wider than one."""
    model = _model(flags)
    nterms = 2 + (2 if flags["kxreg"] else 0) + (2 if flags["ktreg"] else 0)
    fields, consts = _fields(cuda, *shape)
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / fields[0].numel()
    for with_sums in (True, False):
        kd, kp, ks = trw.backward_cuda(model, nterms, 1, fields, (), (), consts, g, with_sums)
        pd, pp, ps = trw._backward_plain(model, nterms, 1, fields, (), (), consts, g, with_sums)
        assert kp == pp == ()
        for a, b in zip(kd, pd):
            _close(a, b, 1e-4, 1e-6)
        if with_sums:
            _close(ks, ps, 1e-5, 0.0)
        else:
            assert ks is None
    _close(trw.forward_cuda(model, nterms, 1, fields, (), (), consts),
           trw._forward_plain(model, nterms, 1, fields, (), (), consts), 1e-5, 0.0)


def test_generic_loss_terms_autograd_match_plain(cuda):
    """rowwise_loss_terms on the card (forward kernel, backward kernel with
    the sums off, through autograd) against the same function on the CPU."""
    model = _model(K)
    results = []
    for device in (cuda, torch.device("cpu")):
        fields, consts = _fields(device, 9, 32, 40, seed=3)
        leaves = [f.clone().requires_grad_(True) for f in fields]
        terms = trw.rowwise_loss_terms(model, leaves, consts=consts, nterms=6, hist=1)
        loss = sum(w * t for w, t in zip((1.0, 0.5, 2.0, 1.0, 0.3, 0.7), terms))
        results.append((terms, torch.autograd.grad(loss, leaves)))
    (kt, kg), (pt, pg) = results
    for a, b in zip(kt, pt):
        _close(a, b, 1e-5, 0.0)
    for a, b in zip(kg, pg):
        _close(a, b, 1e-4, 1e-6)


def test_generic_wrappers_refuse_other_models_and_types(cuda):
    fields, consts = _fields(cuda, 8, 16, 16)
    with pytest.raises(NotImplementedError):
        trw.forward_cuda(trw.RowModel(_model(K).row_fn), 6, 1, fields, (), (), consts)
    with pytest.raises(TypeError):
        trw.forward_cuda(_model(K), 6, 1, tuple(f.double() for f in fields), (), (), consts)
    with pytest.raises(TypeError):
        trw.forward_cuda(_model(K), 6, 1, tuple(f.transpose(1, 2) for f in fields), (), (), consts)
    with pytest.raises(ValueError):
        trw.forward_cuda(_model(K), 6, 1, tuple(f[:1].contiguous() for f in fields), (), (), consts)


def test_cuda_pallas_route_matches_cpu_route(cuda):
    """On the card, the one-pass route of kernel='pallas' runs the generic
    backward kernel once per call behind the graphed multigrid flatten; it
    gives the CPU route's terms and gradients call after call."""
    size = dict(nt=8, nx=32, ny=32)
    cp, cs, _ = tvt.build(kernel="pallas", device="cpu", **size)
    gp, gs, _ = tvt.build(kernel="pallas", device=cuda, **size)
    rng = np.random.default_rng(5)
    shapes = [tuple(a.shape) for a in cp.domain.arrays_from_state(cs)]
    states = [[(0.3 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(2)]
    cfn, gfn = cp.make_loss_grad_fn(cs), gp.make_loss_grad_fn(gs)
    launches = (trw.backward_cuda.launches, trw.forward_cuda.launches, trmg.backward_mg_cuda.launches)
    outs = [gfn(arrays_from_numpy(a, device=cuda), gp.tracers) for a in states]
    assert (trw.backward_cuda.launches, trw.forward_cuda.launches, trmg.backward_mg_cuda.launches) == (
        launches[0] + 2, launches[1], launches[2]
    )
    for arrays, ((_, (gterms, _)), ggrads) in zip(states, outs):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), cp.tracers)
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)


def test_cuda_fp64_takes_the_plain_route(cuda):
    """64-bit fields on the card: pallas_mg falls back to operator_fused, whose
    wrapper takes the plain version (the JAX package's rule); no kernel is
    launched and the loss and gradients are the CPU's."""
    size = dict(nt=8, nx=16, ny=16, dtype=np.float64)
    results = []
    launches = (trw.backward_cuda.launches, trw.forward_cuda.launches, trmg.backward_mg_cuda.launches,
                trmg.forward_mg_cuda.launches)
    rng = np.random.default_rng(8)
    for device in (cuda, torch.device("cpu")):
        p, s, _ = tvt.build(kernel="pallas_mg", device=device, **size)
        assert p.make_loss_grad_fn(s) is None
        if not results:
            arrays = [0.3 * rng.normal(size=tuple(a.shape)) for a in p.domain.arrays_from_state(s)]
        x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device=device)]
        loss_fn, _ = p.make_loss_fn(s)
        loss, _ = loss_fn(x, p.tracers)
        results.append((loss, torch.autograd.grad(loss, x)))
    assert (trw.backward_cuda.launches, trw.forward_cuda.launches, trmg.backward_mg_cuda.launches,
            trmg.forward_mg_cuda.launches) == launches
    (kl, kg), (pl, pg) = results
    _close(kl, pl, 1e-10, 0.0)
    for a, b in zip(kg, pg):
        _close(a, b, 1e-10, 1e-12)


# -- The mg kernels after the header split ---------------------------------------

# sha256 (first 16 hex digits) of the mg kernels' outputs at the flagship
# shapes, from csrc/rowwise_mg.cu before its row model moved into
# veltracer_row.cuh (NVIDIA H100 80GB HBM3): the split changes no bit.
MG_DIGESTS = {
    "all_terms": {"backward_sums": "c7cd0b6ada3a103a", "backward": "df90380a98398377", "forward": "bc82c36b273aece4"},
    "no_reg": {"backward_sums": "b215127635ac6b22", "backward": "3f5af3cb79637a5a", "forward": "1574713d4207f4f8"},
}


def _digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("flags", [K, dict(kimp=3.0, kxreg=0.0, ktreg=0.0)], ids=["all_terms", "no_reg"])
def test_mg_kernels_unchanged_by_header_split(cuda, flags):
    rng = np.random.default_rng(2)
    mk = lambda *shape, s=0.3: torch.as_tensor((s * rng.normal(size=shape)).astype(np.float32), device=cuda)
    t0s = tuple(mk(65, 256, 256) for _ in range(3))
    coarse = tuple(mk(33, 128, 128) for _ in range(3))
    consts = tuple(mk(256, 256, s=1.0) for _ in range(2))
    step = (1 / 64, 1 / 256, 1 / 256)
    model = trmg.RowModel(
        tvt._make_row_fn(*step, **flags), tvt._make_row_vjp(*step, **flags), cuda_model="veltracer",
        scalars=dict(dt=step[0], dx=step[1], dy=step[2], **flags),
    )
    nterms = 2 + (2 if flags["kxreg"] else 0) + (2 if flags["ktreg"] else 0)
    f0s = (0.7, 1.1, 0.9)
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / t0s[0].numel()
    want = MG_DIGESTS["all_terms" if flags["kxreg"] else "no_reg"]
    dt0, dP, sums = trmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, True)
    assert _digest(list(dt0) + list(dP) + [sums]) == want["backward_sums"]
    dt0, dP, _ = trmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, False)
    assert _digest(list(dt0) + list(dP)) == want["backward"]
    assert _digest([trmg.forward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts)]) == want["forward"]


# -- The 1-D row models of the generic kernels (heat, wave) ---------------------

HEAT_CASES = {
    "heat": dict(infer_k=True, imposed="random", nimp=40, kxreg=0.3, ktreg=0.2),
    "heat_lane": dict(infer_k=True, imposed="stripe", nimp=200),
    "heat_true_k": dict(infer_k=False, ktreg=0.5),
}


def _row_case(name, device, T, N, seed=17):
    """(model, nterms, hist, fields, params, data, consts) of a heat or wave
    row model at (T, N), with seeded random fields, params and consts."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=device)
    ix = torch.arange(N, dtype=torch.float32, device=device)
    if name == "wave":
        p, s, e = twv.build(nt=T, nx=N, dtype=np.float32, multigrid=False, kernel="pallas", device=device)
        model = twv._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
        return model, 1, 2, (mk(T, N),), (), (mk(T, 1), mk(T, 1)), (mk(N), mk(N), ix)
    p, s, e = tht.build(nt=T, nx=N, dtype=np.float32, multigrid=False, kernel="pallas", device=device,
                        **HEAT_CASES[name])
    model, names, params = tht._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
    params = tuple(3 * mk(*q.shape) for q in params)
    data = (e.imp_mask, mk(T, N)) if e.imp_size else ()
    consts = (mk(N), mk(N), mk(N), ix, mk(1, 1), mk(1, 1))
    return model, len(names), 1, (mk(T, N) + 0.5,), params, data, consts


@pytest.mark.parametrize("name", ["heat", "heat_lane", "heat_true_k", "wave"])
@pytest.mark.parametrize("shape", [(64, 64), (7, 5), (5, 1), (2, 3), (40, 300), (33, 257)])
def test_1d_kernels_match_plain(cuda, name, shape):
    """Forward, backward+sums and backward of the heat and wave row models
    (1-D planes; params and their cotangents; per-row data; hist 1 and 2)
    against their plain versions: planes narrower than a tile (the wrap),
    several tiles and slabs, T down to 2."""
    model, nterms, hist, fields, params, data, consts = _row_case(name, cuda, *shape)
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / fields[0].numel()
    for with_sums in (True, False):
        kd, kp, ks = trw.backward_cuda(model, nterms, hist, fields, params, data, consts, g, with_sums)
        pd, pp, ps = trw._backward_plain(model, nterms, hist, fields, params, data, consts, g, with_sums)
        assert len(kp) == len(pp) == len(params)
        for a, b in zip(list(kd) + list(kp), list(pd) + list(pp)):
            _close(a, b, 1e-4, 1e-6)
        if with_sums:
            _close(ks, ps, 1e-5, 0.0)
        else:
            assert ks is None
    _close(trw.forward_cuda(model, nterms, hist, fields, params, data, consts),
           trw._forward_plain(model, nterms, hist, fields, params, data, consts), 1e-5, 0.0)


def test_1d_kernels_repeat_their_bits(cuda):
    """No atomics: the heat backward+sums (dfields, dparams, sums) gives the
    same bits call after call."""
    model, nterms, hist, fields, params, data, consts = _row_case("heat", cuda, 256, 512)
    g = torch.full((nterms,), 1.0 / fields[0].numel(), device=cuda)
    outs = []
    for _ in range(3):
        kd, kp, ks = trw.backward_cuda(model, nterms, hist, fields, params, data, consts, g, True)
        outs.append(_digest(list(kd) + list(kp) + [ks]))
    assert outs[0] == outs[1] == outs[2]


def test_1d_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    model, nterms, hist, fields, params, data, consts = _row_case("heat", cuda, 8, 16)
    with pytest.raises(ValueError):
        trw.forward_cuda(model, nterms, 2, fields, params, data, consts)
    with pytest.raises(NotImplementedError):
        trw.forward_cuda(model, nterms, hist, fields, params[:3] + tuple(p[:1] for p in params[3:]), data, consts)
    with pytest.raises(ValueError):
        trw.forward_cuda(model, nterms, hist, fields, params, data, consts[:5])
    wmodel, wn, wh, wf, _, wd, wc = _row_case("wave", cuda, 8, 16)
    with pytest.raises(ValueError):
        trw.forward_cuda(wmodel, wn, wh, wf, (), (wd[0][:, :1][:4],) * 2, wc)


@pytest.mark.parametrize("which", ["heat", "wave"])
def test_cuda_1d_route_matches_cpu_route(cuda, which):
    """The one-pass route of heat (conductivity net as kernel params, its
    gradient from dparams) and wave on the card: one generic backward+sums
    per call and no other row-wise kernel, behind the graphed multigrid
    flatten; the CPU route's terms and gradients call after call."""
    size = dict(nt=16, nx=16)
    build = (lambda d: tht.build(kernel="pallas", device=d, kxreg=0.1, **HEAT_CASES["heat_lane"], **size)) if (
        which == "heat") else (lambda d: twv.build(kernel="pallas", dtype=np.float32, device=d, **size))
    cp, cs, _ = build("cpu")
    gp, gs, _ = build(cuda)
    rng = np.random.default_rng(5)
    shapes = [tuple(a.shape) for a in cp.domain.arrays_from_state(cs)]
    states = [[(0.3 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(2)]
    cfn, gfn = cp.make_loss_grad_fn(cs), gp.make_loss_grad_fn(gs)
    launches = (trw.backward_cuda.launches, trw.forward_cuda.launches)
    outs = [gfn(arrays_from_numpy(a, device=cuda), dict(gp.tracers, epoch=e)) for e, a in enumerate(states)]
    assert (trw.backward_cuda.launches, trw.forward_cuda.launches) == (launches[0] + 2, launches[1])
    for e, (arrays, ((_, (gterms, _)), ggrads)) in enumerate(zip(states, outs)):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), dict(cp.tracers, epoch=e))
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)
