"""The port's CUDA kernels and its card-only route against their plain
PyTorch versions.  These tests need an NVIDIA card and skip without one.
This file imports neither JAX nor the JAX package, so that it runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: sums rtol 1e-5; gradients rtol 1e-4 with atol 1e-6 * max|ref|
(fp32, different summation order); the per-shard kernels' gradients against
the fp64 plain version within that plus 4 times the fp32 plain version's
own distance from it (``_close_floor``).  User row functions on 1-D
planes take the traced kernels (``ops/rowtrace.py``), held to the plain
version and to the hand kernels of the same function; the others run
their plain versions on the card (``rowwise.plain_on_card``) and give the
CPU route's numbers; every heat
configuration takes the row kernels (``csrc/heat_net.cu`` beyond the
default net).  The probes (``csrc/probes.cu``): copy3 the bits of three
clones, fma within rtol 1e-5 (both round each step once); the mg kernel's
ablation builds (``ops/mg_ablation.py``) against their own plain versions
with the mg gates."""

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


def _close_floor(got, want, want64, rtol=1e-4, atol_frac=1e-6):
    """got within the tolerance of the fp64 plain version plus 4 times the
    fp32 plain version's own distance from it, cell by cell: random inputs
    put a few cells of a million where a gradient is a cancellation that
    fp32 resolves to 0.3% only."""
    got, want, want64 = got.detach().double(), want.detach().double(), want64.detach()
    floor = (want - want64).abs()
    tol = rtol * want64.abs() + atol_frac * max(1.0, float(want64.abs().max())) + 4 * floor
    dist = (got - want64).abs()
    i = int((dist - tol).reshape(-1).argmax())
    assert bool((dist <= tol).all()), (float(dist.reshape(-1)[i]), float(floor.reshape(-1)[i]))


def _wide(ts):
    return tuple(t.double() for t in ts)


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
    launches = trmg.backward_mg_cuda.launches, trmg.backward_mg_cuda.launches_with_sums
    outs = [gfn(arrays_from_numpy(a, device=cuda), gp.tracers) for a in states]
    assert (trmg.backward_mg_cuda.launches, trmg.backward_mg_cuda.launches_with_sums) == (
        launches[0] + 2, launches[1] + 2)
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
@pytest.mark.parametrize("shape", [(9, 16, 16), (8, 16, 16), (5, 4, 4), (6, 4, 4), (7, 8, 36), (2, 3, 5), (17, 64, 48),
                                   (6, 130, 36), (5, 18, 36), (4, 4, 36)])
def test_generic_kernels_match_plain(cuda, shape, flags):
    """Forward, backward+sums and backward against their plain versions: T
    even and odd (down to 2), planes narrower than a tile (the halo wraps
    more than once) and wider than one, and 16-row tiles that own only part
    of their rows (X = 130, 18, 4) beside a y tile that is 16-byte staged and
    one that is not (Y = 36)."""
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
# shapes (NVIDIA H100 80GB HBM3).  First pinned when the row model moved
# into veltracer_row.cuh (the split changed no bit); pinned anew when dP
# moved into the row walk (the blocks' windows and their gather sum the
# coarse cotangent in another order), the sums into warp shuffles and the
# walk to two cells a thread, after the kernel held to its plain version and
# the trajectory gates.
MG_DIGESTS = {
    "all_terms": {"backward_sums": "fc6eeae32cd94634", "backward": "dc9f6596a0fb2bc9", "forward": "bc82c36b273aece4"},
    "no_reg": {"backward_sums": "3efe70e779943e92", "backward": "15c94896b11ad30d", "forward": "1574713d4207f4f8"},
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


# Planes narrower than a tile (the wrap), tiles cut unevenly in t and x,
# T down to 2.
SHAPES_1D = [(64, 64), (7, 5), (5, 1), (2, 3), (40, 300), (33, 257), (65, 97), (3, 300), (1024, 1024)]


@pytest.mark.parametrize("name", ["heat", "heat_lane", "heat_true_k", "wave"])
@pytest.mark.parametrize("shape", SHAPES_1D)
def test_1d_kernels_match_plain(cuda, name, shape):
    """Forward, backward+sums and backward of the heat and wave row models
    (1-D planes; params and their cotangents; per-row data; hist 1 and 2)
    against their plain versions evaluated in fp64 on the same inputs."""
    model, nterms, hist, fields, params, data, consts = _row_case(name, cuda, *shape)
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / fields[0].numel()
    wide = (model, nterms, hist, _wide(fields), _wide(params), _wide(data), _wide(consts))
    for with_sums in (True, False):
        kd, kp, ks = trw.backward_cuda(model, nterms, hist, fields, params, data, consts, g, with_sums)
        pd, pp, ps = trw._backward_plain(*wide, g.double(), with_sums)
        assert len(kp) == len(pp) == len(params)
        for a, b in zip(list(kd) + list(kp), list(pd) + list(pp)):
            _close(a, b, 1e-4, 1e-6)
        if with_sums:
            _close(ks, ps, 1e-5, 0.0)
        else:
            assert ks is None
    _close(trw.forward_cuda(model, nterms, hist, fields, params, data, consts), trw._forward_plain(*wide), 1e-5, 0.0)


@pytest.mark.parametrize("name", ["heat", "wave"])
def test_1d_kernels_repeat_their_bits(cuda, name):
    """No atomics: the heat and wave backward+sums (dfields, dparams, sums)
    give the same bits call after call."""
    model, nterms, hist, fields, params, data, consts = _row_case(name, cuda, 256, 512)
    g = torch.full((nterms,), 1.0 / fields[0].numel(), device=cuda)
    outs = []
    for _ in range(3):
        kd, kp, ks = trw.backward_cuda(model, nterms, hist, fields, params, data, consts, g, True)
        outs.append(_digest(list(kd) + list(kp) + [ks]))
    assert outs[0] == outs[1] == outs[2]


def _kernel_count(fn, reps):
    """The device kernels that `reps` calls of fn launch (torch.profiler), by
    name with their counts.  A session that follows many others in one
    process can lose events, the first kernel's or all of them: a session
    that recorded none is taken again (up to three times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                counts[e.name] = counts.get(e.name, 0) + 1
        if counts:
            break
    return counts


@pytest.mark.parametrize("name", ["heat", "wave", "veltracer"])
@pytest.mark.parametrize("stream", [False, True])
def test_backward_with_sums_is_one_launch(cuda, name, stream):
    """A backward+sums (heat with its params' cotangents, wave, veltracer),
    slabbed or streaming, launches one kernel: the blocks reduce the sums
    and param cotangents themselves, the last one in a fixed order."""
    if name == "veltracer":
        model, nterms, hist, params, data = _model(K), 6, 1, (), ()
        fields, consts = _fields(cuda, 33, 64, 96)
    else:
        model, nterms, hist, fields, params, data, consts = _row_case(name, cuda, 256, 512)
    g = torch.full((nterms,), 1.0 / fields[0].numel(), device=cuda)
    call = trw.backward_stream_cuda if stream else trw.backward_cuda
    reps = 5
    counts = _kernel_count(lambda: call(model, nterms, hist, fields, params, data, consts, g, True), reps)
    # One kernel name, and never more launches than calls (the profiler may
    # lose an event, never add one).
    assert len(counts) == 1 and 1 <= sum(counts.values()) <= reps, counts
    assert any(k in n for n in counts for k in ("rows1d_kernel", "rows_kernel")), counts


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


# -- The streaming pair (stream=True) ---------------------------------------------


def _counts():
    return dict(fwd=trw.forward_cuda.launches, bwd=trw.backward_cuda.launches,
                sfwd=trw.forward_stream_cuda.launches, sbwd=trw.backward_stream_cuda.launches)


def _check_kernels(fwd, bwd, plain_fwd, plain_bwd, nterms, nparams):
    """A forward and a backward (sums on and off) against their plain versions."""
    for with_sums in (True, False):
        kd, kp, ks = bwd(with_sums)
        pd, pp, ps = plain_bwd(with_sums)
        assert len(kp) == len(pp) == nparams
        for a, b in zip(list(kd) + list(kp), list(pd) + list(pp)):
            _close(a, b, 1e-4, 1e-6)
        if with_sums:
            _close(ks, ps, 1e-5, 0.0)
        else:
            assert ks is None
    _close(fwd(), plain_fwd(), 1e-5, 0.0)


@pytest.mark.parametrize("shape", [(9, 16, 16), (8, 16, 16), (5, 4, 4), (2, 3, 5), (7, 8, 36), (65, 64, 64)])
def test_stream_kernels_match_plain(cuda, shape):
    """The veltracer streaming kernels (the slabbed launch, counted apart) against their
    plain versions: T even and odd down to 2, narrow and wide planes."""
    model = _model(K)
    fields, consts = _fields(cuda, *shape)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / fields[0].numel()
    before = _counts()
    _check_kernels(
        lambda: trw.forward_stream_cuda(model, 6, 1, fields, (), (), consts),
        lambda s: trw.backward_stream_cuda(model, 6, 1, fields, (), (), consts, g, s),
        lambda: trw._forward_plain(model, 6, 1, fields, (), (), consts),
        lambda s: trw._backward_plain(model, 6, 1, fields, (), (), consts, g, s), 6, 0,
    )
    after = _counts()
    assert (after["sfwd"] - before["sfwd"], after["sbwd"] - before["sbwd"]) == (1, 2)
    assert (after["fwd"], after["bwd"]) == (before["fwd"], before["bwd"])


@pytest.mark.parametrize("name", ["heat", "heat_lane", "heat_true_k", "wave"])
@pytest.mark.parametrize("shape", [(64, 64), (7, 5), (2, 3), (40, 300), (33, 257), (65, 97), (3, 300), (1024, 1024)])
def test_1d_stream_kernels_match_plain(cuda, name, shape):
    """The heat and wave streaming kernels (the slabbed tile launch, counted
    apart) against their plain versions evaluated in fp64."""
    model, nterms, hist, fields, params, data, consts = _row_case(name, cuda, *shape)
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / fields[0].numel()
    wide = (model, nterms, hist, _wide(fields), _wide(params), _wide(data), _wide(consts))
    _check_kernels(
        lambda: trw.forward_stream_cuda(model, nterms, hist, fields, params, data, consts),
        lambda s: trw.backward_stream_cuda(model, nterms, hist, fields, params, data, consts, g, s),
        lambda: trw._forward_plain(*wide),
        lambda s: trw._backward_plain(*wide, g.double(), s), nterms, len(params),
    )


@pytest.mark.parametrize("name", ["heat", "wave", "veltracer"])
def test_stream_and_slabbed_launches_give_the_same_bits(cuda, name):
    """The streaming pair is the slabbed launch on the card: forward,
    backward+sums and backward give the same bits either way."""
    if name == "veltracer":
        model, nterms, hist, params, data = _model(K), 6, 1, (), ()
        fields, consts = _fields(cuda, 65, 64, 96)
    else:
        model, nterms, hist, fields, params, data, consts = _row_case(name, cuda, 65, 97)
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / fields[0].numel()
    args = (model, nterms, hist, fields, params, data, consts)
    slabbed = [trw.forward_cuda(*args)] + [trw.backward_cuda(*args, g, s) for s in (True, False)]
    streamed = [trw.forward_stream_cuda(*args)] + [trw.backward_stream_cuda(*args, g, s) for s in (True, False)]
    flat = lambda out: [out[0]] + [t for b in out[1:] for t in list(b[0]) + list(b[1]) + ([b[2]] if b[2] is not None else [])]
    assert _digest(flat(slabbed)) == _digest(flat(streamed))


def test_stream_kernels_repeat_their_bits(cuda):
    """No atomics: the streaming backward+sums of veltracer, heat and wave
    give the same bits call after call."""
    fields, consts = _fields(cuda, 33, 64, 96)
    g = torch.full((6,), 1.0 / fields[0].numel(), device=cuda)
    cases = [_row_case(name, cuda, 256, 512) for name in ("heat", "wave")]
    outs = []
    for _ in range(3):
        kd, _, ks = trw.backward_stream_cuda(_model(K), 6, 1, fields, (), (), consts, g, True)
        out = list(kd) + [ks]
        for m, n, h, f, p, d, c in cases:
            gd, gp, gs = trw.backward_stream_cuda(m, n, h, f, p, d, c, torch.full((n,), 1.0 / f[0].numel(), device=cuda),
                                                  True)
            out += list(gd) + list(gp) + [gs]
        outs.append(_digest(out))
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("which", ["veltracer", "heat", "wave"])
def test_cuda_stream_route_matches_cpu_route(cuda, which):
    """rowwise_loss_terms(stream=True) through autograd on the card: one
    stream forward and one stream backward (sums off), no slabbed row
    kernel; the CPU route's terms and gradients."""
    results = []
    for device in (cuda, torch.device("cpu")):
        if which == "veltracer":
            model, nterms, hist, (fields, consts), params, data = _model(K), 6, 1, _fields(device, 17, 32, 40), (), ()
        else:
            model, nterms, hist, fields, params, data, consts = _row_case(which, device, 48, 70)
        leaves = [t.clone().requires_grad_(True) for t in tuple(fields) + tuple(params)]
        before = _counts()
        terms = trw.rowwise_loss_terms(model, leaves[: len(fields)], params=leaves[len(fields):], data=data,
                                       consts=consts, nterms=nterms, hist=hist, stream=True)
        grads = torch.autograd.grad(sum(terms), leaves)
        after = _counts()
        want = (1, 1) if device.type == "cuda" else (0, 0)
        assert (after["sfwd"] - before["sfwd"], after["sbwd"] - before["sbwd"]) == want
        assert (after["fwd"], after["bwd"]) == (before["fwd"], before["bwd"])
        results.append((terms, grads))
    (kt, kg), (pt, pg) = results
    for a, b in zip(kt, pt):
        _close(a, b, 1e-5, 0.0)
    for a, b in zip(kg, pg):
        _close(a, b, 1e-4, 1e-6)


# -- Two-level fusion (the lvl2 form of _backward_mg) ------------------------------


def _inputs2(device, T=17, X=64, Y=48, seed=19):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=device)
    Tc = T // 2 + 1
    t0s = tuple(mk(T, X, Y) for _ in range(3))
    t1s = tuple(mk(Tc, X // 2, Y // 2) for _ in range(3))
    P2 = tuple(mk(Tc // 2 + 1, X // 4, Y // 4) for _ in range(3))
    consts = tuple(mk(X, Y) for _ in range(2))
    return t0s, t1s, P2, consts


F1 = (1.3, 0.6, 0.8)


@pytest.mark.parametrize("flags", [K, dict(kimp=3.0, kxreg=0.0, ktreg=0.0)], ids=["all_terms", "no_reg"])
@pytest.mark.parametrize("shape", [(17, 64, 48), (9, 16, 16), (5, 8, 8), (9, 8, 36), (13, 16, 40), (65, 256, 256)])
def test_lvl2_kernel_matches_plain(cuda, shape, flags):
    """The two-level backward (with and without the sums; dt0, dt1 and dP2)
    against the plain lvl2 backward with the split of dP1, on planes down to
    8 x 8 (two level-2 cells: every tap is an edge extrapolation) and at the
    flagship shapes."""
    model = _model(flags)
    nterms = 2 + (2 if flags["kxreg"] else 0) + (2 if flags["ktreg"] else 0)
    t0s, t1s, P2, consts = _inputs2(cuda, *shape)
    f0s = (0.7, 1.1, 0.9)
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / t0s[0].numel()
    for with_sums in (True, False):
        before = (trmg.backward_mg2_cuda.launches, trmg.backward_mg_cuda.launches)
        k = trmg.backward_mg2_cuda(model, nterms, 1, f0s, F1, t0s, t1s, P2, consts, g, with_sums)
        assert (trmg.backward_mg2_cuda.launches, trmg.backward_mg_cuda.launches) == (before[0] + 1, before[1])
        d0, dP1, ps = trmg._backward_mg_plain(model, nterms, 1, f0s, t0s, P2, consts, g, with_sums, lvl2=(t1s, F1))
        W1x, W1y = trmg._interp_matrices(shape[1] // 4, shape[2] // 4, torch.float32, cuda)
        d1, d2 = trmg._split_dp1(dP1, F1, W1x, W1y)
        for a, b in zip(k[0] + k[1] + k[2], d0 + d1 + d2):
            _close(a, b, 1e-4, 1e-6)
        if with_sums:
            _close(k[3], ps, 1e-5, 0.0)
        else:
            assert k[3] is None


def test_lvl2_kernel_repeats_its_bits(cuda):
    t0s, t1s, P2, consts = _inputs2(cuda, 33, 128, 96)
    g = torch.full((6,), 1.0 / t0s[0].numel(), device=cuda)
    outs = []
    for _ in range(3):
        d0, d1, d2, s = trmg.backward_mg2_cuda(_model(K), 6, 1, (0.7, 1.1, 0.9), F1, t0s, t1s, P2, consts, g, True)
        outs.append(_digest(list(d0) + list(d1) + list(d2) + [s]))
    assert outs[0] == outs[1] == outs[2]


def test_lvl2_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    t0s, t1s, P2, consts = _inputs2(cuda, 9, 16, 16)
    g = torch.ones(6, device=cuda)
    with pytest.raises(ValueError):
        trmg.backward_mg2_cuda(_model(K), 6, 1, (0.7,) * 3, F1, t0s, t1s, P2[:2], consts, g, True)
    with pytest.raises(ValueError):
        trmg.backward_mg2_cuda(_model(K), 6, 1, (0.7,) * 3, F1, t0s, t1s, tuple(p[:-1] for p in P2), consts, g, True)
    with pytest.raises(TypeError):
        trmg.backward_mg2_cuda(_model(K), 6, 1, (0.7,) * 3, F1, t0s, tuple(t.double() for t in t1s), P2, consts, g,
                               True)
    with pytest.raises(NotImplementedError):
        trmg.backward_mg2_cuda(trmg.RowModel(_model(K).row_fn), 6, 1, (0.7,) * 3, F1, t0s, t1s, P2, consts, g, True)


def test_cuda_depth2_route_matches_cpu_route(cuda, monkeypatch):
    """make_loss_grad_fn with the veltracer hook at depth 2 on the card: the
    two-level kernel once per call behind the graphed level-2 prologue, no
    depth-1 kernel; the CPU route's terms and gradients call after call."""
    monkeypatch.setattr(tvt._mg_loss_and_grads, "partial_depth", lambda *a: 2)
    size = dict(nt=16, nx=32, ny=32)
    cp, cs, _ = tvt.build(kernel="pallas_mg", device="cpu", **size)
    gp, gs, _ = tvt.build(kernel="pallas_mg", device=cuda, **size)
    rng = np.random.default_rng(6)
    shapes = [tuple(a.shape) for a in cp.domain.arrays_from_state(cs)]
    states = [[(0.3 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(2)]
    cfn, gfn = cp.make_loss_grad_fn(cs), gp.make_loss_grad_fn(gs)
    before = (trmg.backward_mg2_cuda.launches, trmg.backward_mg_cuda.launches)
    outs = [gfn(arrays_from_numpy(a, device=cuda), gp.tracers) for a in states]
    assert (trmg.backward_mg2_cuda.launches, trmg.backward_mg_cuda.launches) == (before[0] + 2, before[1])
    for arrays, ((_, (gterms, _)), ggrads) in zip(states, outs):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), cp.tracers)
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)


# -- The per-shard (halo) kernels ---------------------------------------------------

# (T, X, Y) of the block, global row offset, global T, own rows, x halo: a
# t-partitioned first shard (owner of its first row), a later shard (its
# first row is the left shard's ghost node), an x-only shard, and the
# flagship's t:2,x:2 shard shapes (ragged last x tile: 130 = 16 * 8 + 2).
HALO_CASES = {
    "t_first": ((10, 18, 16), -1, 17, 1, 10, 1),
    "t_later": ((10, 18, 16), 7, 17, 2, 10, 1),
    "x_only": ((9, 18, 40), 0, 9, 0, 9, 1),
    "flagship": ((34, 130, 256), 31, 65, 2, 34, 1),
}


# Blocks whose last 16-row x tile is only partly owned (X = 130, 18, 4), Y = 36
# (a 16-byte staged y tile and a ragged one): the kernel-vs-plain test only.
HALO_PARTIAL_CASES = {
    "x130_y36": ((6, 130, 36), 3, 17, 1, 6, 1),
    "x18_y36": ((7, 18, 36), 7, 17, 2, 7, 1),
    "x4_y36": ((5, 4, 36), 0, 5, 0, 5, 1),
}


def _halo_case(device, name, seed=12):
    (T, X, Y), off, Tg, r_lo, r_hi, hx = {**HALO_CASES, **HALO_PARTIAL_CASES}[name]
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=device)
    fields = tuple(mk(T, X, Y) for _ in range(3))
    consts = tuple(mk(X, Y) for _ in range(2))
    mask = torch.ones((X, Y), device=device)
    mask[:hx] = 0
    mask[X - hx :] = 0
    return trw.halo_model(_model(K), mask, off, Tg, r_lo, r_hi), fields, consts


@pytest.mark.parametrize("name", list(HALO_CASES) + list(HALO_PARTIAL_CASES))
def test_halo_kernels_match_plain(cuda, name):
    model, fields, consts = _halo_case(cuda, name)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / fields[0].numel()
    before = (trw.forward_halo_cuda.launches, trw.backward_halo_cuda.launches, trw.backward_cuda.launches)
    m64 = trw.halo_model(model.inner, model.halo[0].double(), *model.halo[1:])
    qd, _, _ = trw._backward_plain(m64, 6, 1, _wide(fields), (), (), _wide(consts), g.double(), False)
    for with_sums in (True, False):
        kd, _, ks = trw.backward_halo_cuda(model, 6, 1, fields, (), (), consts, g, with_sums)
        pd, _, ps = trw._backward_plain(model, 6, 1, fields, (), (), consts, g, with_sums)
        for a, b, c in zip(kd, pd, qd):
            _close_floor(a, b, c)
        if with_sums:
            _close(ks, ps, 1e-5, 0.0)
    _close(trw.forward_halo_cuda(model, 6, 1, fields, (), (), consts), trw._forward_plain(model, 6, 1, fields, (), (),
           consts), 1e-5, 0.0)
    assert (trw.forward_halo_cuda.launches, trw.backward_halo_cuda.launches, trw.backward_cuda.launches) == (
        before[0] + 1, before[1] + 2, before[2])


# Stack of the local-block mg kernel: (Tl, Xe, Y) of the block, global X, its
# first global column x0, first global row g0, global T, own rows from r_lo:
# odd and even x0 (tiles start at even global columns), the global seam, an
# x-unpartitioned block, and the flagship's t:2,x:2 shard shapes.
MG_LOCAL_CASES = {
    "seam_first": ((9, 18, 16), 32, -1, 0, 17, 0),
    "odd_later": ((9, 18, 16), 32, 15, 8, 17, 1),
    "even_x0": ((9, 20, 16), 32, 6, 8, 17, 1),
    "x_whole": ((17, 32, 16), 32, 0, 0, 17, 0),
    "flagship": ((33, 130, 256), 256, 127, 32, 65, 1),
}


def _mg_local_case(device, name, seed=13):
    (Tl, Xe, Y), X, x0, g0, Tg, r_lo = MG_LOCAL_CASES[name]
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=device)
    t0s = tuple(mk(Tl, Xe, Y) for _ in range(3))
    coarse = tuple(mk((Tl - 1) // 2 + 1, X // 2, Y // 2) for _ in range(3))
    heads = tuple(mk(1, Xe, Y) for _ in range(3))
    consts = tuple(mk(Xe, Y) for _ in range(2))
    mask = torch.ones((Xe, Y), device=device)
    if Xe < X:
        mask[:1] = 0
        mask[Xe - 1 :] = 0
    return trw.halo_model(_model(K), mask, g0, Tg, r_lo, Tl), t0s, coarse, heads, consts, x0


@pytest.mark.parametrize("name", list(MG_LOCAL_CASES))
def test_mg_local_kernel_matches_plain(cuda, name):
    model, t0s, coarse, heads, consts, x0 = _mg_local_case(cuda, name)
    f0s = (0.7, 1.1, 0.9)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / t0s[0].numel()
    before = (trmg.backward_mg_local_cuda.launches, trmg.backward_mg_cuda.launches)
    k = trmg.backward_mg_local_cuda(model, 6, 1, f0s, t0s, coarse, heads, x0, consts, g)
    p = trmg._backward_mg_local_plain(model, 6, 1, f0s, t0s, coarse, heads, x0, consts, g)
    m64 = trw.halo_model(model.inner, model.halo[0].double(), *model.halo[1:])
    q = trmg._backward_mg_local_plain(m64, 6, 1, f0s, _wide(t0s), _wide(coarse), _wide(heads), x0, _wide(consts),
                                      g.double())
    for a, b, c in zip(k[0] + k[1] + k[2], p[0] + p[1] + p[2], q[0] + q[1] + q[2]):
        _close_floor(a, b, c)
    _close(k[3], p[3], 1e-5, 0.0)
    assert (trmg.backward_mg_local_cuda.launches, trmg.backward_mg_cuda.launches) == (before[0] + 1, before[1])


def test_halo_kernels_repeat_their_bits(cuda):
    model, fields, consts = _halo_case(cuda, "flagship")
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / fields[0].numel()
    outs = []
    for _ in range(3):
        d, _, s = trw.backward_halo_cuda(model, 6, 1, fields, (), (), consts, g, True)
        outs.append(_digest(list(d) + [s, trw.forward_halo_cuda(model, 6, 1, fields, (), (), consts)]))
    model, t0s, coarse, heads, consts, x0 = _mg_local_case(cuda, "flagship")
    for _ in range(3):
        outs.append(_digest(trmg.backward_mg_local_cuda(model, 6, 1, (0.7, 1.1, 0.9), t0s, coarse, heads, x0, consts,
                                                          g)[1]))
    assert outs[0] == outs[1] == outs[2] and outs[3] == outs[4] == outs[5]


def test_halo_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    model, fields, consts = _halo_case(cuda, "t_first")
    g = torch.ones(6, device=cuda)
    with pytest.raises(ValueError):
        trw.backward_halo_cuda(model, 6, 1, fields, (), (), tuple(c[:-1] for c in consts), g, True)
    with pytest.raises(NotImplementedError):
        trw.backward_stream_cuda(model, 6, 1, fields, (), (), consts, g, False)
    model, t0s, coarse, heads, consts, x0 = _mg_local_case(cuda, "odd_later")
    with pytest.raises(ValueError):
        trmg.backward_mg_local_cuda(model, 6, 1, (0.7,) * 3, t0s, coarse, tuple(h[:, 1:] for h in heads), x0, consts, g)
    with pytest.raises(ValueError):
        trmg.backward_mg_local_cuda(model.inner, 6, 1, (0.7,) * 3, t0s, coarse, heads, x0, consts, g)


@pytest.mark.parametrize("route", ["generic", "mg"])
def test_cuda_halo_route_matches_cpu_route(cuda, route):
    """make_loss_grad_fn(halo=True) on a t:2,x:2 mesh of four shards of the
    card against the same mesh of CPU devices (the plain versions): the
    route asked for, one per-shard kernel launch a shard and call, the same
    terms and gradients call after call; and the loss-only route."""
    from odil_torch import parallel

    size = dict(nt=16, nx=32, ny=32)
    part = {"t": "t", "x": "x"}
    runs = {}
    for device in ("cpu", cuda):
        mesh = parallel.mesh_from_spec("t:2,x:2", devices=[torch.device(device)] * 4)
        runs[str(device)] = tvt.build(kernel="pallas_mg", device=device, mesh=mesh, partition=part, **size)
    cp, cs, _ = runs["cpu"]
    gp, gs, _ = runs[str(cuda)]
    rng = np.random.default_rng(7)
    shapes = [tuple(a.shape) for a in cp.domain.arrays_from_state(cs)]
    states = [[(0.3 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(2)]
    cfn = cp.make_loss_grad_fn(cs, halo=True, halo_fuse=route)
    gfn = gp.make_loss_grad_fn(gs, halo=True, halo_fuse=route)
    assert cfn.route == gfn.route == route
    counter = trw.backward_halo_cuda if route == "generic" else trmg.backward_mg_local_cuda
    before = counter.launches
    outs = [gfn(arrays_from_numpy(a, device=cuda), gp.tracers) for a in states]
    assert counter.launches == before + 2 * 4
    for arrays, ((_, (gterms, _)), ggrads) in zip(states, outs):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), cp.tracers)
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)
    loss_fn, _ = gp.make_loss_fn(gs, halo=True)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(states[0], device=cuda)]
    loss, _ = loss_fn(x, gp.tracers)
    grads = torch.autograd.grad(loss, x)
    for a, b in zip(grads, outs[0][1]):
        _close(a, b, 1e-4, 1e-6)


# sha256 (first 16 hex digits) of the generic veltracer kernels' outputs at
# the flagship shapes, from csrc/rowwise.cu before the per-shard (halo) layer
# was added to it and to veltracer_row.cuh (NVIDIA H100 80GB HBM3): the layer
# changes no bit of the plain launches.  The row kernel's redesign (16 x 32
# tiles, two cells a thread, rows staged by cp.async) kept every digest here
# and in HALO_DIGESTS: the dfields by the same per-cell arithmetic, the sums
# because their other order of addition rounds to the same fp32 values.
GEN_DIGESTS = {
    "all_terms": {"backward_sums": "37a1d9aae39fbc53", "backward": "629470acdfd3fcc5", "forward": "9dad241e6ba40afc"},
    "no_reg": {"backward_sums": "d563f202143ad5d1", "backward": "26c01e3c095541b1", "forward": "76de9486e41a2697"},
}


def _generic_digests(device, flags):
    rng = np.random.default_rng(3)
    mk = lambda *shape, s=0.3: torch.as_tensor((s * rng.normal(size=shape)).astype(np.float32), device=device)
    fields = tuple(mk(65, 256, 256) for _ in range(3))
    consts = tuple(mk(256, 256, s=1.0) for _ in range(2))
    step = (1 / 64, 1 / 256, 1 / 256)
    model = trw.RowModel(
        tvt._make_row_fn(*step, **flags), tvt._make_row_vjp(*step, **flags), cuda_model="veltracer",
        scalars=dict(dt=step[0], dx=step[1], dy=step[2], **flags),
    )
    nterms = 2 + (2 if flags["kxreg"] else 0) + (2 if flags["ktreg"] else 0)
    g = torch.linspace(0.5, 1.5, nterms, device=device) / fields[0].numel()
    d, _, s = trw.backward_cuda(model, nterms, 1, fields, (), (), consts, g, True)
    out = {"backward_sums": _digest(list(d) + [s])}
    d, _, _ = trw.backward_cuda(model, nterms, 1, fields, (), (), consts, g, False)
    out["backward"] = _digest(list(d))
    out["forward"] = _digest([trw.forward_cuda(model, nterms, 1, fields, (), (), consts)])
    return out


@pytest.mark.parametrize("flags", [K, dict(kimp=3.0, kxreg=0.0, ktreg=0.0)], ids=["all_terms", "no_reg"])
def test_generic_kernels_unchanged_by_halo_layer(cuda, flags):
    assert _generic_digests(cuda, flags) == GEN_DIGESTS["all_terms" if flags["kxreg"] else "no_reg"]


# sha256 (first 16 hex digits) of the per-shard kernels' outputs on the
# inputs of _halo_case (backward with the sums, without, forward) and
# _mg_local_case (dt0, dP, dheads, sums), from the masked kernels and the
# local mg kernel as first written, each its own kernel (NVIDIA H100 80GB
# HBM3): sharing the bodies of the plain launches changes no bit.  The
# local mg kernel's digests are pinned anew with the depth-1 ones above (dP
# in the walk: another summation order).  t_first's backward+sums and
# forward digests are pinned anew once, with the sums reduced inside the
# row kernel (finish_sums: warp shuffles, then the last block) and the slabs
# sized to whole waves: the sums' order changed, and its float sums with it;
# the dfields of every case kept their bits (the no-sums digests, and the
# dfields of the backward+sums, are the ones pinned before), and so did
# GEN_DIGESTS and the other cases' sums.
HALO_DIGESTS = {
    "t_first": ("f2852bbf30f2ffd7", "2d181f485cceb152", "6a79bd659742ef64"),
    "t_later": ("7e391e2e4b059287", "e9c7f10fee2fe5ea", "2066b9dc12f19794"),
    "x_only": ("e67fdd675c3a22d8", "4b09510e25daca31", "4ca8ff3bd0829ea5"),
    "flagship": ("8a67a3fc809a62a1", "f7b36100df68bef8", "b9567af5c45b490c"),
}
MG_LOCAL_DIGESTS = {
    "seam_first": "25efff8f9a808151",
    "odd_later": "8aeb990f9b3e8920",
    "even_x0": "d09a98747b93e54b",
    "x_whole": "50886bb0d2b9b354",
    "flagship": "e93ca628a9d47a6c",
}


@pytest.mark.parametrize("name", list(HALO_CASES))
def test_halo_kernels_keep_their_bits(cuda, name):
    model, fields, consts = _halo_case(cuda, name)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / fields[0].numel()
    d, _, s = trw.backward_halo_cuda(model, 6, 1, fields, (), (), consts, g, True)
    d2, _, _ = trw.backward_halo_cuda(model, 6, 1, fields, (), (), consts, g, False)
    f = trw.forward_halo_cuda(model, 6, 1, fields, (), (), consts)
    assert (_digest(list(d) + [s]), _digest(list(d2)), _digest([f])) == HALO_DIGESTS[name]


@pytest.mark.parametrize("case", ["plain_256", "plain_partial", "masked_flagship", "masked_partial"])
def test_backward_sums_keep_the_backward_dfields(cuda, case):
    """The dfields of a backward+sums are the backward's bit for bit, plain
    and masked, at the flagship's shapes and where a 16-row tile is only
    partly owned: the sums add to the row walk and change none of its
    cotangents."""
    if case.startswith("plain"):
        model, call = _model(K), trw.backward_cuda
        fields, consts = _fields(cuda, *((65, 256, 256) if case == "plain_256" else (6, 130, 36)))
    else:
        model, fields, consts = _halo_case(cuda, "flagship" if case == "masked_flagship" else "x130_y36")
        call = trw.backward_halo_cuda
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / fields[0].numel()
    d, _, s = call(model, 6, 1, fields, (), (), consts, g, True)
    d2, _, s2 = call(model, 6, 1, fields, (), (), consts, g, False)
    assert s is not None and s2 is None
    assert _digest(list(d)) == _digest(list(d2))


@pytest.mark.parametrize("name", list(MG_LOCAL_CASES))
def test_mg_local_kernel_keeps_its_bits(cuda, name):
    model, t0s, coarse, heads, consts, x0 = _mg_local_case(cuda, name)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / t0s[0].numel()
    k = trmg.backward_mg_local_cuda(model, 6, 1, (0.7, 1.1, 0.9), t0s, coarse, heads, x0, consts, g)
    assert _digest(list(k[0]) + list(k[1]) + list(k[2]) + [k[3]]) == MG_LOCAL_DIGESTS[name]


# -- The mg backward at the main path's shapes: dP inside the walk ----------------


def _close_max(got, want, rtol=1e-4, atol_frac=1e-6):
    """got within rtol * |want| + atol_frac * max|want| (no floor of 1: the
    gradients of a mean loss are small)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    tol = rtol * want.abs() + atol_frac * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


def _kernel_names(fn):
    """The device kernels that calls of fn launch (``_kernel_count`` over
    three calls)."""
    return set(_kernel_count(fn, 3))


@pytest.mark.parametrize("shape", [(65, 256, 256), (65, 512, 512)])
def test_mg_kernel_matches_plain_at_main_path_shapes(cuda, shape):
    """The mg backward (with and without the sums) and forward at the
    flagship's 256^2 and 512^2 shapes against their plain versions; the
    backward repeats its bits."""
    model = _model(K)
    t0s, coarse, consts = _inputs(cuda, *shape, seed=21)
    f0s = (0.7, 1.1, 0.9)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / t0s[0].numel()
    for with_sums in (True, False):
        k = trmg.backward_mg_cuda(model, 6, 1, f0s, t0s, coarse, consts, g, with_sums)
        p = trmg._backward_mg_plain(model, 6, 1, f0s, t0s, coarse, consts, g, with_sums)
        for a, b in zip(k[0] + k[1], p[0] + p[1]):
            _close_max(a, b)
        if with_sums:
            _close(k[2], p[2], 1e-5, 0.0)
            again = trmg.backward_mg_cuda(model, 6, 1, f0s, t0s, coarse, consts, g, True)
            assert _digest(list(k[0]) + list(k[1]) + [k[2]]) == _digest(list(again[0]) + list(again[1]) + [again[2]])
    _close(trmg.forward_mg_cuda(model, 6, 1, f0s, t0s, coarse, consts),
           trmg._forward_mg_plain(model, 6, 1, f0s, t0s, coarse, consts), 1e-5, 0.0)


# The local blocks of the flagship's four 256^2 t:2,x:2 shards and of one
# 512^2 shard: ((Tl, Xe, Y), X, x0, g0, Tg, r_lo) as in MG_LOCAL_CASES.
SHARD_CASES = {
    f"256_{i_t}{i_x}": ((33, 130, 256), 256, i_x * 128 - 1, i_t * 32, 65, int(i_t > 0))
    for i_t in range(2) for i_x in range(2)
}
SHARD_CASES["512_11"] = ((33, 258, 512), 512, 255, 32, 65, 1)


@pytest.mark.parametrize("name", list(SHARD_CASES))
def test_mg_local_kernel_matches_plain_at_shard_shapes(cuda, name, monkeypatch):
    monkeypatch.setitem(MG_LOCAL_CASES, name, SHARD_CASES[name])
    model, t0s, coarse, heads, consts, x0 = _mg_local_case(cuda, name)
    f0s = (0.7, 1.1, 0.9)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / t0s[0].numel()
    k = trmg.backward_mg_local_cuda(model, 6, 1, f0s, t0s, coarse, heads, x0, consts, g)
    p = trmg._backward_mg_local_plain(model, 6, 1, f0s, t0s, coarse, heads, x0, consts, g)
    m64 = trw.halo_model(model.inner, model.halo[0].double(), *model.halo[1:])
    q = trmg._backward_mg_local_plain(m64, 6, 1, f0s, _wide(t0s), _wide(coarse), _wide(heads), x0, _wide(consts),
                                      g.double())
    for a, b, c in zip(k[0] + k[1] + k[2], p[0] + p[1] + p[2], q[0] + q[1] + q[2]):
        _close_floor(a, b, c)
    _close(k[3], p[3], 1e-5, 0.0)
    again = trmg.backward_mg_local_cuda(model, 6, 1, f0s, t0s, coarse, heads, x0, consts, g)
    assert _digest(list(k[0]) + list(k[1]) + list(k[2]) + [k[3]]) == _digest(
        list(again[0]) + list(again[1]) + list(again[2]) + [again[3]])


def test_mg_backward_forms_dp_in_the_walk(cuda):
    """The depth-1 and local-block mg backward launch the row walk and the dP
    gather and no separate dP pass over dt0 (mg_coarse_grad_kernel); the
    two-level backward keeps that pass one level down, for dP2."""
    model = _model(K)
    t0s, coarse, consts = _inputs(cuda, 33, 64, 96)
    g = torch.full((6,), 1.0 / t0s[0].numel(), device=cuda)
    f0s = (0.7, 1.1, 0.9)
    depth1 = _kernel_names(lambda: trmg.backward_mg_cuda(model, 6, 1, f0s, t0s, coarse, consts, g, True))
    lm, lt0, lc, lh, lcs, x0 = _mg_local_case(cuda, "odd_later")
    local = _kernel_names(lambda: trmg.backward_mg_local_cuda(lm, 6, 1, f0s, lt0, lc, lh, x0, lcs, g))
    t0s2, t1s, P2, consts2 = _inputs2(cuda, 33, 64, 96)
    depth2 = _kernel_names(lambda: trmg.backward_mg2_cuda(model, 6, 1, f0s, F1, t0s2, t1s, P2, consts2, g, True))
    has = lambda names, k: any(k in n for n in names)
    for names in (depth1, local, depth2):
        assert has(names, "mg_rows_kernel") and has(names, "mg_dp_gather_kernel"), names
        assert not has(names, "reduce_sums_kernel"), names
    assert not has(depth1, "mg_coarse_grad_kernel") and not has(local, "mg_coarse_grad_kernel")
    assert has(depth2, "mg_coarse_grad_kernel")


# -- Row models without a CUDA counterpart: plain torch on the card --------------


def _heat_args(**kw):
    import argparse

    a = dict(infer_k=True, imposed="stripe", nimp=40, noise=0.0, seed=1000, kimp=2.0, kxreg=0.1, kxregdecay=0,
             ktreg=0.0, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=1, keep_init=0, solver="odil")
    a.update(kw)
    return argparse.Namespace(**a)


def _user_operator(ctx):
    """The flagship's kernel call with its row function as a user's: no
    CUDA model, no hand adjoint."""
    d = tvt._kernel_decl(ctx)
    return ctx.rowwise_terms(trw.RowModel(d["row_fn"].row_fn), d["keys"], consts=d["consts"], nterms=d["nterms"],
                             hist=1, halox=1)


@pytest.mark.parametrize("which", ["heat_keep_init_0", "user_row_fn"])
def test_plain_on_card_route_matches_cpu_route(cuda, which):
    """A user row function through ctx.rowwise_terms: the one-pass route
    runs its plain version on the card (plain_on_card once a call, no
    row-wise kernel); heat with keep_init=0, which declares its CUDA model,
    takes the kernel (one backward+sums a call, no plain_on_card).  Both
    give the CPU route's terms and gradients."""
    if which == "heat_keep_init_0":
        build = lambda d: tht.build(nt=16, nx=16, kernel="pallas", device=d, args=_heat_args())
    else:
        def build(d):
            p, s, e = tvt.build(nt=8, nx=32, ny=32, kernel="pallas", device=d)
            p.operator = _user_operator
            return p, s, e
    cp, cs, _ = build("cpu")
    gp, gs, _ = build(cuda)
    rng = np.random.default_rng(9)
    shapes = [tuple(a.shape) for a in cp.domain.arrays_from_state(cs)]
    states = [[(0.3 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(2)]
    cfn, gfn = cp.make_loss_grad_fn(cs), gp.make_loss_grad_fn(gs)
    before = (trw.plain_on_card.launches, trw.backward_cuda.launches, trw.forward_cuda.launches)
    outs = [gfn(arrays_from_numpy(a, device=cuda), dict(gp.tracers, epoch=e)) for e, a in enumerate(states)]
    plain, kernel = (0, 2) if which == "heat_keep_init_0" else (2, 0)
    assert (trw.plain_on_card.launches, trw.backward_cuda.launches, trw.forward_cuda.launches) == (
        before[0] + plain, before[1] + kernel, before[2])
    for e, (arrays, ((_, (gterms, _)), ggrads)) in enumerate(zip(states, outs)):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), dict(cp.tracers, epoch=e))
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)


def test_lbfgs_state_lives_on_the_card(cuda):
    """make_optimizer("lbfgs") keeps its iterate and its memory (the (s, y)
    ring and rho) on the card, and takes the CPU run's iterates (fp64, a
    quadratic, 10 iterations in chunks of 5) within rtol 1e-10."""
    from odil_torch.optim import make_optimizer

    rng = np.random.default_rng(0)
    a = rng.normal(size=(8, 8))
    a, b = a @ a.T + 0.5 * np.eye(8), rng.normal(size=8)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        a_, b_ = torch.tensor(a, device=dev), torch.tensor(b, device=dev)

        def fn(arrays, tracers, a_=a_, b_=b_):
            x = arrays[0]
            loss = 0.5 * torch.dot(x, a_ @ x) - torch.dot(b_, x)
            return loss, ([loss], [loss])

        opt = make_optimizer("lbfgs", dtype=np.float64)
        opt.bind(fn, tracers={"epoch": 0}, task_epochs=[5, 10], names=["q"])
        x, info = opt.run([torch.zeros(8, dtype=torch.float64, device=dev)], epochs=10)
        assert info.evals == 10 and x[0].device.type == dev.type
        assert {t.device.type for t in (opt.x, opt.memory.s, opt.memory.y, opt.memory.rho)} == {dev.type}
        out[dev.type] = x[0].cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-10)


# -- The per-shard 1-D kernels (heat and wave under --halo) and async checkpoints --

ROWS1D_HALO_CASES = {"heat": (64, 96), "wave": (64, 96), "heat_1024": (1024, 1024)}
# sha256 (first 16 hex digits) of the masked 1-D kernels' outputs over the
# four t:4 shards of _rows1d_halo_records (backward with the sums, without,
# forward), from rows1d.cuh's halo layer as first written (NVIDIA H100 80GB
# HBM3).
ROWS1D_HALO_DIGESTS = {
    "heat": ("4f769c0148f7504a", "96bf9a5f06a424be", "287a7cab8c70a5e8"),
    "wave": ("8d8d89a2a68ffd8b", "8715b0bbdcc364b0", "938743c032a3751e"),
    "heat_1024": ("6bd09299e82cdf5b", "729d79d691b6a251", "9856622ce93f1ac4"),
}


def _rows1d_halo_records(device, name, seed=14):
    """The recorded kernel calls of the four shards of a t:4 mesh on one
    device (heat with its net, measurements and both regularizations, or
    wave), fp32, at a seeded random state: the masked models, blocks, data
    and consts the per-shard kernels take."""
    from odil_torch import halo as thalo
    from odil_torch import parallel as tpar

    T, N = ROWS1D_HALO_CASES[name]
    mesh = tpar.mesh_from_spec("t:4", devices=[device] * 4)
    if name.startswith("heat"):
        p, s, _ = tht.build(nt=T, nx=N, infer_k=True, imposed="random", nimp=min(T * N // 8, 2000), kxreg=0.3,
                            ktreg=0.2, dtype=np.float32, kernel="pallas", device=device, mesh=mesh,
                            partition={"t": "t"})
    else:
        p, s, _ = twv.build(nt=T, nx=N, dtype=np.float32, kernel="pallas", device=device, mesh=mesh,
                            partition={"t": "t"})
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(np.float32) for a in p.domain.arrays_from_state(s)]
    plan = thalo._HaloPlan(p, s)
    grid, params = thalo._localize(p, plan, thalo._mg_metas(p, s, plan), arrays_from_numpy(arrays, device=device))
    results = thalo._run_operators(p, plan, thalo._extended(plan, grid), params, p.tracers)
    return [r for ctx, _ in results for r in ctx.rowwise_deferred]


def _record_args(r, dtype=None):
    return [tuple((x.detach().to(dtype) if dtype else x.detach()).contiguous() for x in r[k])
            for k in ("fields", "params", "data", "consts")]


@pytest.mark.parametrize("name", list(ROWS1D_HALO_CASES))
def test_rows1d_halo_kernels_match_plain(cuda, name):
    """The masked 1-D kernels (backward with and without the sums, forward)
    on every shard's block against the plain version of the wrapped model,
    gradients within _close_floor of the fp64 one; they repeat their bits
    and count apart from the veltracer per-shard kernels."""
    counts = (trw.backward_halo_rows1d_cuda.launches, trw.backward_halo_cuda.launches)
    for r in _rows1d_halo_records(cuda, name):
        m, nt, h = r["row_fn"], r["nterms"], r["hist"]
        assert m.halo is not None and m.cuda_model == name.split("_")[0]
        a, a64 = _record_args(r), _record_args(r, torch.float64)
        g = torch.linspace(0.5, 1.5, nt, device=cuda) / a[0][0].numel()
        for with_sums in (True, False):
            kd, kp, ks = trw.backward_halo_rows1d_cuda(m, nt, h, *a, g, with_sums)
            pd, pp, ps = trw._backward_plain(m, nt, h, *a, g, with_sums)
            wd, wp, _ = trw._backward_plain(m, nt, h, *a64, g.double(), with_sums)
            for k, p, w in zip(list(kd) + list(kp), list(pd) + list(pp), list(wd) + list(wp)):
                _close_floor(k, p, w)
            if with_sums:
                _close(ks, ps, 1e-5, 1e-7)
                again = trw.backward_halo_rows1d_cuda(m, nt, h, *a, g, True)
                assert _digest(list(kd) + list(kp) + [ks]) == _digest(list(again[0]) + list(again[1]) + [again[2]])
        _close(trw.forward_halo_rows1d_cuda(m, nt, h, *a), trw._forward_plain(m, nt, h, *a), 1e-5, 1e-7)
    assert trw.backward_halo_rows1d_cuda.launches - counts[0] == 4 * 3
    assert trw.backward_halo_cuda.launches == counts[1]


@pytest.mark.parametrize("name", list(ROWS1D_HALO_CASES))
def test_rows1d_halo_kernels_keep_their_bits(cuda, name):
    outs = [[], [], []]
    for r in _rows1d_halo_records(cuda, name):
        m, nt, h = r["row_fn"], r["nterms"], r["hist"]
        a = _record_args(r)
        g = torch.linspace(0.5, 1.5, nt, device=cuda) / a[0][0].numel()
        d, p, s = trw.backward_halo_rows1d_cuda(m, nt, h, *a, g, True)
        outs[0] += list(d) + list(p) + [s]
        d, p, _ = trw.backward_halo_rows1d_cuda(m, nt, h, *a, g, False)
        outs[1] += list(d) + list(p)
        outs[2].append(trw.forward_halo_rows1d_cuda(m, nt, h, *a))
    got = tuple(_digest(o) for o in outs)
    assert got == ROWS1D_HALO_DIGESTS[name], got


def test_async_checkpoint_is_not_reached_by_a_later_in_place_update(cuda, tmp_path):
    """On a side stream busy with earlier work, a save and, right after it,
    an in-place update of the field and of a slot on that stream: the saved
    step holds the values of the save (the pinned copies are enqueued on the
    stream before the update)."""
    from odil_torch import Domain, Field, State
    from odil_torch.checkpoint import AsyncCheckpointer

    domain = Domain(cshape=(512, 512), dimnames=["x", "y"], dtype=np.float32, device=cuda)
    state = domain.init_state(State(fields={"u": Field(np.zeros((512, 512)))}))
    stream = torch.cuda.Stream()
    ckpt = AsyncCheckpointer(tmp_path, max_to_keep=2)
    with torch.cuda.stream(stream):
        u = state.fields["u"].array
        slot = torch.full_like(u, 3.0)
        a = torch.randn(2048, 2048, device=cuda)
        for _ in range(20):  # keeps the stream busy past the save
            a = torch.tanh(a @ a)
        u.add_(a[:512, :512] * 0 + 1.0)
        want = u.clone()
        for step in (1, 2, 3):
            ckpt.save(domain, state, step, optstate={"m": [slot]})
            u.add_(1.0)
            slot.mul_(2.0)
    stream.synchronize()
    _ = domain.init_state(State(fields={"u": Field(np.zeros((512, 512)))}))
    slots = ckpt.restore(domain, state, step=2)
    _close(state.fields["u"].array, want + 1.0, 0.0, 0.0)
    np.testing.assert_array_equal(slots["m"][0], np.full((512, 512), 6.0, dtype=np.float32))
    assert ckpt.latest_step() == 3 and sorted(p.name for p in tmp_path.iterdir()) == ["2", "3"]
    ckpt.close()


# -- The mesh routes on one card: multi_start and the GSPMD route ------------------


def test_multi_start_kernel_route_on_the_card(cuda):
    """``parallel.multi_start`` on heat's kernel route (64^2, fp32, 4
    starts, 10 Adam epochs): ``loss_fn_b`` loops over the instances, so every
    epoch launches the row kernels' forward and backward once an instance;
    each instance follows its single-start run (the loss scaled by 1/4, so
    the updates are the batch's) within the fp32 floor."""
    from odil_torch import parallel
    from odil_torch.optim import Adam
    from odil_torch.optim.base import autograd_loss_grad_fn

    problem, state, _ = tht.build(nt=64, nx=64, kernel="pallas", infer_k=True, imposed="stripe", device=cuda)
    nstarts, epochs = 4, 10
    loss_b, stacked = parallel.multi_start(problem, state, nstarts=nstarts, seed=2, scale=0.05)
    assert loss_b.form == "loop" and all(a.is_cuda for a in stacked)
    before = (trw.forward_cuda.launches, trw.backward_cuda.launches)
    batched = Adam(autograd_loss_grad_fn(loss_b), stacked, lr=1e-3)
    losses = batched.run_chunk(epochs, problem.tracers)
    assert (trw.forward_cuda.launches - before[0], trw.backward_cuda.launches - before[1]) == (
        nstarts * epochs, nstarts * epochs)
    loss_fn, _ = problem.make_loss_fn(state)

    def scaled(arrays, tracers):
        loss, aux = loss_fn(arrays, tracers)
        return loss / nstarts, aux

    rows = []
    for i in range(nstarts):
        single = Adam(autograd_loss_grad_fn(scaled), [a[i] for a in stacked], lr=1e-3)
        rows.append(single.run_chunk(epochs, problem.tracers) * nstarts)
        for a, b in zip(batched.x, single.x):
            _close(a[i], b, 1e-5, 1e-6)
    _close(losses, torch.stack(rows).mean(0), 1e-5, 0.0)


@pytest.mark.parametrize("kernel", ["pallas_mg", "pallas"])
def test_gspmd_route_is_the_unsharded_route_on_the_card(cuda, kernel):
    """A Domain on the mesh t:2,x:2 of four shards of the card, evaluated
    without halo: the fused route (its CUDA graphs and kernels) and the
    loss-only path give the unsharded loss and gradients to the bit, the
    same launches, and the state's arrays stay the same tensors on the
    card."""
    from odil_torch import parallel

    mesh = parallel.mesh_from_spec("t:2,x:2", devices=[cuda] * 4)
    kw = dict(nt=16, nx=64, ny=64, kernel=kernel, device=cuda)
    p0, s0, _ = tvt.build(**kw)
    p1, s1, _ = tvt.build(**kw, mesh=mesh, partition={"t": "t", "x": "x"})
    arrays = p1.domain.arrays_from_state(s1)
    assert all(a.is_cuda for a in arrays)
    assert all(a is b for a, b in zip(parallel.shard_state_arrays(p1.domain, arrays), arrays))
    rng = np.random.default_rng(3)
    x = [torch.as_tensor((0.3 * rng.normal(size=tuple(a.shape))).astype(np.float32), device=cuda) for a in arrays]
    outs, launches = [], []
    for p, s in ((p0, s0), (p1, s1)):
        before = dict(mg=trmg.backward_mg_cuda.launches, rows=trw.backward_cuda.launches)
        (loss, (terms, _)), grads = p.make_loss_grad_fn(s)(x, p.tracers)
        leaves = [a.clone().requires_grad_(True) for a in x]
        l2, _ = p.make_loss_fn(s)[0](leaves, p.tracers)
        outs.append([loss, *terms, *grads, l2, *torch.autograd.grad(l2, leaves)])
        launches.append((trmg.backward_mg_cuda.launches - before["mg"], trw.backward_cuda.launches - before["rows"]))
    assert launches[0] == launches[1] and sum(launches[0]) >= 2
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# -- Every heat configuration on the row kernels ---------------------------------

# keep_init and keep_frozen on or off, the true conductivity, and nets of
# other widths and depths (heat_net.cu, a library per net; the default
# configuration stays in rowwise.cu): (hidden widths, args).  Nets of more
# than 48 params take the wide form (heat_wide.cuh): [1, 31, 7, 13, 1] no
# width a multiple of its 16-byte weight loads or its 2x2 param tiles,
# [1, 32, 32, 32, 1] the limit (2209 params).
HEAT_CONFIGS = {
    "ki0": ((5, 5), dict(keep_init=0)),
    "kf0": ((5, 5), dict(keep_frozen=0)),
    "ki0_kf0": ((5, 5), dict(keep_init=0, keep_frozen=0)),
    "true_k_ki0_kf0": ((5, 5), dict(infer_k=False, keep_init=0, keep_frozen=0)),
    "w3x4_ki0_kf0": ((3, 4), dict(keep_init=0, keep_frozen=0)),
    "w4x4x4_kf0": ((4, 4, 4), dict(keep_frozen=0)),
    "w32x32": ((32, 32), dict()),
    "w32x32_kf0": ((32, 32), dict(keep_frozen=0)),
    "w16x16x16_ki0_kf0": ((16, 16, 16), dict(keep_init=0, keep_frozen=0)),
    "w31x7x13_kf0": ((31, 7, 13), dict(keep_frozen=0)),
    "w32x32x32_ki0_kf0": ((32, 32, 32), dict(keep_init=0, keep_frozen=0)),
}


def _config_args(config, **kw):
    import argparse

    a = dict(infer_k=True, imposed="random", nimp=40, noise=0.0, seed=1000, kimp=2.0, kxreg=0.3, kxregdecay=0,
             ktreg=0.2, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=1, keep_init=1, solver="odil")
    a.update(HEAT_CONFIGS[config][1])
    a.update(kw)
    return argparse.Namespace(**a)


def _config_case(config, device, T, N, seed=17):
    """_row_case of a heat configuration of HEAT_CONFIGS."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor((0.3 * rng.normal(size=shape)).astype(np.float32), device=device)
    p, s, e = tht.build(nt=T, nx=N, dtype=np.float32, multigrid=False, kernel="pallas", device=device,
                        arch_k=HEAT_CONFIGS[config][0], args=_config_args(config))
    model, names, params = tht._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
    params = tuple(3 * mk(*q.shape) for q in params)
    data = (e.imp_mask, mk(T, N)) if e.imp_size else ()
    consts = (mk(N), mk(N), mk(N), torch.arange(N, dtype=torch.float32, device=device), mk(1, 1), mk(1, 1))
    return model, len(names), 1, (mk(T, N) + 0.5,), params, data, consts


@pytest.mark.parametrize("config", list(HEAT_CONFIGS))
@pytest.mark.parametrize("shape", [(64, 64), (7, 5), (2, 3), (33, 257), (1024, 1024)])
def test_heat_configurations_match_plain(cuda, config, shape):
    """Forward, backward+sums and backward of every heat configuration
    against the plain version (the hand adjoint) in fp64; the streaming
    launch gives the slabbed launch's bits."""
    model, nterms, hist, fields, params, data, consts = _config_case(config, cuda, *shape)
    assert model.cuda_model == "heat" and model.row_vjp is not None
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / fields[0].numel()
    args = (model, nterms, hist, fields, params, data, consts)
    wide = (model, nterms, hist, _wide(fields), _wide(params), _wide(data), _wide(consts))
    _check_kernels(lambda: trw.forward_cuda(*args), lambda s: trw.backward_cuda(*args, g, s),
                   lambda: trw._forward_plain(*wide), lambda s: trw._backward_plain(*wide, g.double(), s), nterms,
                   len(params))
    slabbed = [trw.forward_cuda(*args)] + [trw.backward_cuda(*args, g, s) for s in (True, False)]
    streamed = [trw.forward_stream_cuda(*args)] + [trw.backward_stream_cuda(*args, g, s) for s in (True, False)]
    flat = lambda out: [out[0]] + [t for b in out[1:] for t in list(b[0]) + list(b[1]) + ([b[2]] if b[2] is not None else [])]
    assert _digest(flat(slabbed)) == _digest(flat(streamed))


@pytest.mark.parametrize("config", list(HEAT_CONFIGS))
def test_heat_configurations_repeat_their_bits(cuda, config):
    """No atomics in the shared param form either: backward+sums (dfields,
    dparams, sums) the same bits call after call."""
    model, nterms, hist, fields, params, data, consts = _config_case(config, cuda, 256, 512)
    g = torch.full((nterms,), 1.0 / fields[0].numel(), device=cuda)
    outs = []
    for _ in range(3):
        kd, kp, ks = trw.backward_cuda(model, nterms, hist, fields, params, data, consts, g, True)
        outs.append(_digest(list(kd) + list(kp) + [ks]))
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("config", ["ki0_kf0", "w32x32_kf0", "w16x16x16_ki0_kf0", "w31x7x13_kf0"])
def test_heat_configurations_under_halo_match_plain(cuda, config):
    """The masked per-shard kernels of a heat configuration on the four t:4
    shards of 64x96 against the plain version of the wrapped model
    (_close_floor), one masked launch a call."""
    from odil_torch import halo as thalo
    from odil_torch import parallel as tpar

    mesh = tpar.mesh_from_spec("t:4", devices=[cuda] * 4)
    p, s, _ = tht.build(nt=64, nx=96, kernel="pallas", device=cuda, mesh=mesh, partition={"t": "t"},
                        arch_k=HEAT_CONFIGS[config][0], args=_config_args(config))
    rng = np.random.default_rng(14)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(np.float32) for a in p.domain.arrays_from_state(s)]
    plan = thalo._HaloPlan(p, s)
    grid, params = thalo._localize(p, plan, thalo._mg_metas(p, s, plan), arrays_from_numpy(arrays, device=cuda))
    results = thalo._run_operators(p, plan, thalo._extended(plan, grid), params, p.tracers)
    before = trw.backward_halo_rows1d_cuda.launches
    for r in [r for ctx, _ in results for r in ctx.rowwise_deferred]:
        m, nt, h = r["row_fn"], r["nterms"], r["hist"]
        a, a64 = _record_args(r), _record_args(r, torch.float64)
        g = torch.linspace(0.5, 1.5, nt, device=cuda) / a[0][0].numel()
        for with_sums in (True, False):
            kd, kp, ks = trw.backward_halo_rows1d_cuda(m, nt, h, *a, g, with_sums)
            pd, pp, ps = trw._backward_plain(m, nt, h, *a, g, with_sums)
            wd, wp, _ = trw._backward_plain(m, nt, h, *a64, g.double(), with_sums)
            for k, q, w in zip(list(kd) + list(kp), list(pd) + list(pp), list(wd) + list(wp)):
                _close_floor(k, q, w)
            if with_sums:
                _close(ks, ps, 1e-5, 1e-7)
        _close(trw.forward_halo_rows1d_cuda(m, nt, h, *a), trw._forward_plain(m, nt, h, *a), 1e-5, 1e-7)
    assert trw.backward_halo_rows1d_cuda.launches - before == 4 * 2


@pytest.mark.parametrize("config", ["ki0", "w32x32_kf0"])
def test_heat_configurations_take_the_kernel_route(cuda, config):
    """The one-pass route of a heat configuration on the card: one
    backward+sums a call, no plain_on_card; the CPU route's terms and
    gradients."""
    build = lambda d: tht.build(nt=16, nx=16, kernel="pallas", device=d, arch_k=HEAT_CONFIGS[config][0],
                                args=_config_args(config))
    cp, cs, _ = build("cpu")
    gp, gs, _ = build(cuda)
    rng = np.random.default_rng(9)
    states = [[(0.3 * rng.normal(size=tuple(a.shape))).astype(np.float32) for a in cp.domain.arrays_from_state(cs)]
              for _ in range(2)]
    cfn, gfn = cp.make_loss_grad_fn(cs), gp.make_loss_grad_fn(gs)
    before = (trw.plain_on_card.launches, trw.backward_cuda.launches)
    outs = [gfn(arrays_from_numpy(a, device=cuda), dict(gp.tracers, epoch=e)) for e, a in enumerate(states)]
    assert (trw.plain_on_card.launches, trw.backward_cuda.launches) == (before[0], before[1] + 2)
    for e, (arrays, ((_, (gterms, _)), ggrads)) in enumerate(zip(states, outs)):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), dict(cp.tracers, epoch=e))
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)


# SASS instructions (cuobjdump) and registers (ptxas) of the row kernels that
# the wide form leaves as they were: rowwise.cu's rows1d_kernel (the default
# heat net, wave) and rows_kernel, rowwise_mg.cu, and heat_net.cu's register
# form ([1, 5, 5, 1]); measured on an NVIDIA H100 80GB HBM3 for the builds
# before the wide form.
ROW_SASS = {
    "rowwise": {
        "rows1d::rows1d_kernel<rows1d::HeatRow, 1, 0>": 5376, "rows1d::rows1d_kernel<rows1d::HeatRow, 1, 1>": 5384,
        "rows1d::rows1d_kernel<rows1d::HeatRow, 2, 0>": 5984, "rows1d::rows1d_kernel<rows1d::HeatRow, 2, 1>": 6024,
        "rows1d::rows1d_kernel<rows1d::HeatRow, 3, 0>": 6448, "rows1d::rows1d_kernel<rows1d::HeatRow, 3, 1>": 6464,
        "rows1d::rows1d_kernel<rows1d::WaveRow, 1, 0>": 2744, "rows1d::rows1d_kernel<rows1d::WaveRow, 1, 1>": 2752,
        "rows1d::rows1d_kernel<rows1d::WaveRow, 2, 0>": 2456, "rows1d::rows1d_kernel<rows1d::WaveRow, 2, 1>": 2456,
        "rows1d::rows1d_kernel<rows1d::WaveRow, 3, 0>": 2904, "rows1d::rows1d_kernel<rows1d::WaveRow, 3, 1>": 2920,
        "rows_kernel<1, 0>": 3344, "rows_kernel<1, 1>": 3408, "rows_kernel<2, 0>": 3232, "rows_kernel<2, 1>": 3328,
        "rows_kernel<3, 0>": 3880, "rows_kernel<3, 1>": 3984, "empty_kernel": 16,
    },
    "rowwise_mg": {
        "mg_coarse_grad_kernel": 1016, "mg_dp_gather_kernel<Mg2Args>": 240, "mg_dp_gather_kernel<MgArgs>": 240,
        "mg_dp_gather_kernel<MgLocalArgs>": 256, "mg_rows_kernel<1, 0, MgArgs>": 3224,
        "mg_rows_kernel<2, 0, MgArgs>": 4408, "mg_rows_kernel<2, 1, Mg2Args>": 8112,
        "mg_rows_kernel<3, 0, MgArgs>": 5000, "mg_rows_kernel<3, 0, MgLocalArgs>": 5696,
        "mg_rows_kernel<3, 1, Mg2Args>": 8776,
    },
    "heat_net w5x5": {
        "rows1d::rows1d_kernel<HeatNetRow, 1, 0>": 5376, "rows1d::rows1d_kernel<HeatNetRow, 1, 1>": 5392,
        "rows1d::rows1d_kernel<HeatNetRow, 2, 0>": 6592, "rows1d::rows1d_kernel<HeatNetRow, 2, 1>": 6608,
        "rows1d::rows1d_kernel<HeatNetRow, 3, 0>": 7016, "rows1d::rows1d_kernel<HeatNetRow, 3, 1>": 7032,
    },
}
# Their registers, sorted.
ROW_REGISTERS = {
    "rowwise": [4, 40, 40, 40, 40, 43, 44, 63, 64, 80, 80, 80, 80, 128, 128, 128, 128, 128, 128],
    "rowwise_mg": [30, 30, 30, 40, 76, 78, 80, 80, 80, 80],
    "heat_net w5x5": [128, 128, 146, 146, 148, 152],
}


@pytest.mark.parametrize("build", list(ROW_SASS))
def test_row_kernels_keep_their_sass(cuda, build):
    """The builds the wide form must leave as they were: their SASS
    instruction counts and registers, instruction for instruction."""
    import chip_smoke
    from odil_torch.ops import _build

    job = (build,) if build in ("rowwise", "rowwise_mg") else trw.heat_net_source((5, 5))
    path, _, log = _build.compile_source(*job)
    counts = chip_smoke.sass_counts(path)
    assert counts, "cuobjdump found no kernel"
    assert counts == ROW_SASS[build]
    regs = sorted(int(line.split("Used ")[1].split()[0]) for line in log.splitlines() if "Used " in line)
    assert regs == ROW_REGISTERS[build]


def test_heat_net_beyond_the_limit_raises(cuda):
    """A conductivity net beyond the kernels' limit (33 units, four hidden
    layers) raises with the limit on the card: no route picks itself."""
    for arch in ((33,), (4, 4, 4, 4)):
        p, s, e = tht.build(nt=8, nx=16, kernel="pallas", device=cuda, arch_k=arch, args=_config_args("w32x32"))
        model, names, params = tht._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
        fields = (torch.zeros((8, 16), device=cuda),)
        consts = (torch.zeros(16, device=cuda),) * 4 + (torch.zeros((1, 1), device=cuda),) * 2
        with pytest.raises(NotImplementedError, match="at most 3|1 to 32"):
            trw.forward_cuda(model, len(names), 1, fields, params, (e.imp_mask, e.imp_u), consts)


# -- The probes and the mg kernel's ablation builds --------------------------------


@pytest.mark.parametrize("shape", [(65, 256, 256), (65, 512, 512), (5, 16, 16), (3, 5, 7)])
def test_probes_match_plain(cuda, shape):
    """copy3 gives the bits of three clones, fma its plain version within
    rtol 1e-5 (one rounding a step against two, 128 steps), each launch
    counted; an array whose start is not 16-byte aligned takes the scalar
    loop and gives the same numbers."""
    from odil_torch.ops import probes

    rng = np.random.default_rng(4)
    abc = tuple(torch.as_tensor(rng.random(shape).astype(np.float32), device=cuda) for _ in range(3))
    before = (probes.copy3_cuda.launches, probes.fma_cuda.launches)
    for got, want in zip(probes.copy3(*abc), probes._copy3_plain(*abc)):
        assert torch.equal(got, want)
    for k in (probes.FMA_K, 5):
        _close(probes.fma(abc[0], k), probes._fma_plain(abc[0], k), 1e-5, 0.0)
    assert (probes.copy3_cuda.launches, probes.fma_cuda.launches) == (before[0] + 1, before[1] + 2)
    odd = tuple(torch.cat([x.reshape(-1), x.reshape(-1)[:1]])[1:] for x in abc)  # one float past a 16-byte start
    assert odd[0].data_ptr() % 16 != 0
    for got, want in zip(probes.copy3_cuda(*odd), odd):
        assert torch.equal(got, want)
    _close(probes.fma_cuda(odd[0]), probes._fma_plain(odd[0]), 1e-5, 0.0)


def test_probes_refuse_what_they_do_not_take(cuda):
    from odil_torch.ops import probes

    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        probes.copy3_cuda(x, x, x.double())
    with pytest.raises(ValueError):
        probes.copy3_cuda(x, x, x[:2])
    with pytest.raises(TypeError):
        probes.fma_cuda(x.t())


@pytest.mark.parametrize("variant", ["trivial-row", "no-matmul"])
@pytest.mark.parametrize("shape", [(65, 256, 256), (65, 512, 512), (9, 16, 16), (17, 64, 48)])
def test_mg_ablation_builds_match_plain(cuda, variant, shape):
    """Each ablation build of the mg kernel against its own plain version
    (the mg gates), with and without the sums; the two-level and local-block
    entry points refuse an ablation build."""
    from odil_torch.ops import mg_ablation

    T, X, Y = shape
    t0s, coarse, consts = _inputs(cuda, T, X, Y, seed=6)
    model = _model(K)
    g = torch.linspace(0.5, 1.5, 6, device=cuda) / t0s[0].numel()
    f0s = (0.7, 1.1, 0.9)
    kernel = {"trivial-row": mg_ablation.backward_trivial_row_cuda,
              "no-matmul": mg_ablation.backward_no_matmul_cuda}[variant]
    plain = {"trivial-row": mg_ablation._backward_trivial_row_plain,
             "no-matmul": mg_ablation._backward_no_matmul_plain}[variant]
    for with_sums in (True, False):
        before = kernel.launches
        kd, kP, ks = kernel(model, 6, 1, f0s, t0s, coarse, consts, g, with_sums)
        pd, pP, ps = plain(model, 6, 1, f0s, t0s, coarse, consts, g, with_sums)
        assert kernel.launches == before + 1
        for a, b in zip(kd + kP, pd + pP):
            _close(a, b, 1e-4, 1e-6)
        if with_sums:
            _close(ks, ps, 1e-5, 0.0)
    lib = mg_ablation._library(variant)
    assert lib.odil_mg_backward2(None, 1, None) != 0 and lib.odil_mg_backward_local(None, 1, None) != 0


# -- User row functions on 1-D planes: the traced kernels (ops/rowtrace.py) ---------


def _traced_case(name, device, T, N, seed=17):
    """_row_case's heat or wave inputs with the bare row function (a user's:
    no CUDA model, no hand adjoint) beside the hand model."""
    model, nterms, hist, fields, params, data, consts = _row_case(name, device, T, N, seed)
    user = trw.RowModel(model.row_fn)
    return user, model, (nterms, hist, fields, params, data, consts)


# A model's literals (its steps, its last cell) follow its grid, so each
# shape builds a library of its own.
TRACED_SHAPES = [(64, 64), (7, 5), (33, 257), (1024, 1024)]
TRACED_NAMES = ["heat", "heat_lane", "heat_true_k", "wave"]


@pytest.fixture(scope="module")
def traced_builds():
    """Every traced case's library, built together (one nvcc each)."""
    import concurrent.futures

    from odil_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    cases = [(n, s) for n in TRACED_NAMES for s in TRACED_SHAPES] + [("heat_lane", (256, 512)), ("wave", (256, 512)),
                                                                     ("wave", (8, 16))]
    sources = set()
    for name, shape in cases:
        user, _, call = _traced_case(name, "cuda", *shape)
        sources.add(trw._traced(user, *call)[0].trace.source)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(lambda src: _build.compile_generated("rows1d_traced", src), sources))


@pytest.mark.parametrize("name", TRACED_NAMES)
@pytest.mark.parametrize("shape", TRACED_SHAPES)
def test_traced_kernels_match_plain_and_hand(cuda, traced_builds, name, shape):
    """A bare heat or wave row function takes the traced kernels: forward,
    backward+sums, backward and the streaming pair, each against the plain
    version (autograd of the row function) in fp64 and against the hand
    kernel on the same inputs; no plain_on_card."""
    user, hand, call = _traced_case(name, cuda, *shape)
    nterms, hist, fields, params, data, consts = call
    assert trw._kernel_route(user, fields[0], call) and trw._traced(user, *call)[0] is not None
    g = torch.linspace(0.5, 1.5, nterms, device=cuda) / fields[0].numel()
    wide = (user, nterms, hist, _wide(fields), _wide(params), _wide(data), _wide(consts))
    before, plain = _counts(), trw.plain_on_card.launches
    for fwd, bwd in ((trw.forward_cuda, trw.backward_cuda), (trw.forward_stream_cuda, trw.backward_stream_cuda)):
        for with_sums in (True, False):
            kd, kp, ks = bwd(user, *call, g, with_sums)
            hd, hp, hs = bwd(hand, *call, g, with_sums)
            pd, pp, ps = trw._backward_plain(*wide, g.double(), with_sums)
            assert len(kp) == len(pp) == len(params)
            for a, b, c in zip(list(kd) + list(kp), list(pd) + list(pp), list(hd) + list(hp)):
                _close(a, b, 1e-4, 1e-6)
                _close(a, c, 1e-4, 1e-6)
            if with_sums:
                _close(ks, ps, 1e-5, 0.0)
                _close(ks, hs, 1e-5, 0.0)
        kf = fwd(user, *call)
        _close(kf, trw._forward_plain(*wide), 1e-5, 0.0)
        _close(kf, fwd(hand, *call), 1e-5, 0.0)
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == dict(fwd=2, bwd=4, sfwd=2, sbwd=4)
    assert trw.plain_on_card.launches == plain


@pytest.mark.parametrize("name", ["heat_lane", "wave"])
def test_traced_kernels_repeat_their_bits(cuda, traced_builds, name):
    """No atomics: the traced backward+sums gives the same bits call after
    call, and the streaming launch the slabbed one's."""
    user, _, call = _traced_case(name, cuda, 256, 512)
    g = torch.full((call[0],), 1.0 / call[2][0].numel(), device=cuda)
    outs = []
    for bwd in (trw.backward_cuda, trw.backward_cuda, trw.backward_stream_cuda):
        kd, kp, ks = bwd(user, *call, g, True)
        outs.append(_digest(list(kd) + list(kp) + [ks]))
    assert outs[0] == outs[1] == outs[2]


def test_traced_build_without_nvcc_raises(cuda, monkeypatch, tmp_path):
    """A traced row function whose library cannot build (nvcc hidden, an
    empty build directory) raises on the card: no fallback to the plain
    version."""
    from odil_torch.ops import _build

    user, _, call = _traced_case("wave", cuda, 8, 16)
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    trw._traced_library.cache_clear()
    _build.load_generated.cache_clear()
    before = trw.plain_on_card.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        trw.forward_cuda(user, *call)
    assert trw.plain_on_card.launches == before
    monkeypatch.undo()
    trw._traced_library.cache_clear()
    _build.load_generated.cache_clear()


def test_traced_route_matches_cpu_route(cuda):
    """Heat with keep_init=0 (the [1, 5, 5, 1] net, stripe measurements)
    whose row function reaches ctx.rowwise_terms bare: one traced
    backward+sums a call on the card and no plain_on_card; the CPU route's
    terms and gradients."""
    import argparse

    args = argparse.Namespace(infer_k=True, imposed="stripe", nimp=200, noise=0.0, seed=1000, kimp=2.0, kxreg=0.0,
                              kxregdecay=0, ktreg=0.0, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1,
                              keep_frozen=1, keep_init=0, solver="odil")

    def build(d):
        p, s, e = tht.build(nt=16, nx=16, kernel="pallas", device=d, args=args)
        base = p.operator

        def operator(ctx):
            call = ctx.rowwise_terms
            ctx.rowwise_terms = lambda model, *a, **k: call(trw.RowModel(model.row_fn), *a, **k)
            return base(ctx)

        p.operator = operator
        return p, s

    cp, cs = build("cpu")
    gp, gs = build(cuda)
    rng = np.random.default_rng(8)
    states = [[(0.3 * rng.normal(size=tuple(a.shape))).astype(np.float32) for a in cp.domain.arrays_from_state(cs)]
              for _ in range(2)]
    cfn, gfn = cp.make_loss_grad_fn(cs), gp.make_loss_grad_fn(gs)
    before = (trw.plain_on_card.launches, trw.backward_cuda.launches)
    outs = [gfn(arrays_from_numpy(a, device=cuda), dict(gp.tracers, epoch=e)) for e, a in enumerate(states)]
    assert (trw.plain_on_card.launches, trw.backward_cuda.launches) == (before[0], before[1] + 2)
    for e, (arrays, ((_, (gterms, _)), ggrads)) in enumerate(zip(states, outs)):
        (_, (cterms, _)), cgrads = cfn(arrays_from_numpy(arrays, device="cpu"), dict(cp.tracers, epoch=e))
        for a, b in zip(gterms, cterms):
            _close(a, b, 1e-5, 0.0)
        for a, b in zip(ggrads, cgrads):
            _close(a, b, 1e-4, 1e-6)
