"""The halo (per-shard) path of the port against the JAX package on the CPU.

The same velocity_from_tracer problem is built in both packages from one
numpy seed, fp64: the JAX package on the conftest's 8 virtual host devices
(its Pallas kernels in interpret mode, or its plain XLA route), the port on
a mesh of CPU devices running the plain versions of its kernels.  Held at
rtol 1e-10 (atol 1e-12 * max|ref| for gradients): the loss-only route and
the generic one-pass route (specs x:4, t:4,x:2, t:2,x:2, x:2,y:2, multigrid
on and off), the x-padded form (the JAX package's ``_FORCE_TILE``), the
MG-fused route (x:4, t:4,x:2, t:8, t:2,x:4 with all six terms, and the
JAX package's MG-fused route through its local-tiled kernel at nx=64), the
local-block mg kernel directly, the cases where the builders return None, and Adam through the
halo routes against the port's unsharded route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odil_torch import halo as thalo
from odil_torch import parallel as tpar
from odil_torch.convert import arrays_from_numpy
from odil_torch.models import veltracer as tvt
from odil_torch.ops import rowwise as trw
from odil_torch.ops import rowwise_mg as trmg
from odil_torch.optim import Adam
from odil_tpu import halo as jhalo
from odil_tpu import parallel as jpar
from odil_tpu.models import veltracer as jvt

CPU8 = [torch.device("cpu")] * 8
RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _unoptimized_xla():
    """The JAX references compile with most XLA optimizations off: at these
    sizes their trace and compile, not their run, take the time."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _pair(spec, part, kernel="pallas", multigrid=True, nt=16, nx=16, ny=16, dtype=np.float64, seed=0, **kw):
    """The problem in both packages on the same mesh, and a random state."""
    jp, js, _ = jvt.build(nt=nt, nx=nx, ny=ny, kernel=kernel, multigrid=multigrid, dtype=dtype,
                          mesh=jpar.mesh_from_spec(spec, devices=jax.devices()[:8]), partition=part, **kw)
    tp, ts, _ = tvt.build(nt=nt, nx=nx, ny=ny, kernel=kernel, multigrid=multigrid, dtype=dtype, device="cpu",
                          mesh=tpar.mesh_from_spec(spec, devices=CPU8), partition=part, **kw)
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.normal(size=a.shape)).astype(dtype) for a in jp.domain.arrays_from_state(js)]
    return (jp, js), (tp, ts), arrays


def _jax_value_and_grad(jp, js, arrays):
    """value_and_grad of the JAX package's halo loss (its plain route on the
    CPU mesh), jitted."""
    loss_fn, _ = jhalo.make_halo_loss_fn(jp, js)
    (loss, (terms, _)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        [jnp.asarray(a) for a in arrays], jp.tracers
    )
    return loss, terms, grads


def _check(loss, terms, grads, jl, jterms, jg, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=rtol)
    assert len(terms) == len(jterms) and len(grads) == len(jg)
    for a, b in zip(terms, jterms):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=rtol)
    for a, b in zip(grads, jg):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=rtol, atol=atol * max(1.0, float(np.abs(b).max())))


def _port_loss_route(tp, ts, arrays):
    loss_fn, _ = tp.make_loss_fn(ts, halo=True)
    x = [a.requires_grad_(True) for a in arrays_from_numpy(arrays, device="cpu")]
    loss, (terms, _) = loss_fn(x, tp.tracers)
    return loss, terms, torch.autograd.grad(loss, x)


def _port_onepass(tp, ts, arrays, fuse):
    fn = tp.make_loss_grad_fn(ts, halo=True, halo_fuse=fuse)
    assert fn is not None and fn.route == fuse
    (loss, (terms, norms)), grads = fn(arrays_from_numpy(arrays, device="cpu"), tp.tracers)
    assert len(norms) == len(terms)
    return loss, terms, grads


SPECS = {
    "x4": ("x:4", {"x": "x"}),
    "t4x2": ("t:4,x:2", {"t": "t", "x": "x"}),
    "t2x2": ("t:2,x:2", {"t": "t", "x": "x"}),
    "x2y2": ("x:2,y:2", {"x": "x", "y": "y"}),
}


@pytest.mark.parametrize("multigrid", [False, True], ids=["plain", "multigrid"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_generic_route_matches_jax(spec, multigrid):
    """The loss-only route (autograd of make_loss_fn(halo=True)) and the
    generic one-pass route against the JAX package's halo loss at 16^3
    (as tests/test_halo.py:181-198)."""
    (jp, js), (tp, ts), arrays = _pair(*SPECS[spec], multigrid=multigrid)
    want = _jax_value_and_grad(jp, js, arrays)
    _check(*_port_loss_route(tp, ts, arrays), *want)
    _check(*_port_onepass(tp, ts, arrays, "generic"), *want)


@pytest.mark.parametrize("multigrid", [False, True], ids=["plain", "multigrid"])
@pytest.mark.parametrize("spec", ["x:2", "t:2,x:4", "t:4"])
def test_xpad_form_matches_jax(spec, multigrid, monkeypatch):
    """The per-shard kernels on x extents the TPU pads (18 -> 24, 10 -> 16;
    tests/test_halo.py:750-773): the JAX package through its x-tiled
    edge-padded kernels (``_FORCE_TILE = 8``, interpret mode), the port on
    the unpadded extent with the mask alone."""
    from odil_tpu.ops import rowwise as jrw

    monkeypatch.setattr(jrw, "_FORCE_TILE", 8)
    part = {a: a for a in ("t", "x") if a + ":" in spec}
    (jp, js), (tp, ts), arrays = _pair(spec, part, multigrid=multigrid, nt=8, nx=32, ny=16, seed=1)
    want = _jax_value_and_grad(jp, js, arrays)
    _check(*_port_loss_route(tp, ts, arrays), *want)
    _check(*_port_onepass(tp, ts, arrays, "generic"), *want)


MG_SPECS = {
    "x4": ("x:4", {"x": "x"}, {}),
    "t4x2": ("t:4,x:2", {"t": "t", "x": "x"}, {}),
    "t8": ("t:8", {"t": "t"}, {}),
    "t2x4_all_terms": ("t:2,x:4", {"t": "t", "x": "x"}, dict(nt=8, kxreg=0.01, ktreg=0.01)),
}


@pytest.mark.parametrize("spec", list(MG_SPECS))
def test_mg_route_matches_jax(spec):
    """The MG-fused route (local-block kernel per shard) against the JAX
    package's halo loss, and its loss-only route."""
    mesh, part, kw = MG_SPECS[spec]
    (jp, js), (tp, ts), arrays = _pair(mesh, part, kernel="pallas_mg", seed=2, **kw)
    want = _jax_value_and_grad(jp, js, arrays)
    loss, terms, grads = _port_onepass(tp, ts, arrays, "mg")
    assert len(terms) == 6
    _check(loss, terms, grads, *want)
    _check(*_port_loss_route(tp, ts, arrays), *want)


def test_mg_route_matches_jax_local_tiled(monkeypatch):
    """The JAX package's beyond-VMEM local kernel (``_loss_and_grads_local_tiled``,
    forced by ``MG_VMEM_LIMIT = 1`` at nx=64, tests/test_halo.py:848-885) is
    what the port's one local-block kernel also serves."""
    from odil_tpu.ops import rowwise_mg as jrmg

    monkeypatch.setattr(jrmg, "MG_VMEM_LIMIT", 1)
    (jp, js), (tp, ts), arrays = _pair("t:2,x:2", {"t": "t", "x": "x"}, kernel="pallas_mg", nt=8, nx=64, ny=16,
                                       seed=4)
    jfn = jp.make_loss_grad_fn(js, halo=True, halo_fuse="mg")
    assert jfn.route == "mg"
    (jl, (jterms, _)), jg = jax.jit(jfn)([jnp.asarray(a) for a in arrays], jp.tracers)
    _check(*_port_onepass(tp, ts, arrays, "mg"), jl, jterms, jg)


@pytest.mark.parametrize("case", [(-1, 0, 1, 0), (15, 8, 1, 1), (0, 0, 0, 0)], ids=["seam_first", "later", "x_whole"])
def test_local_mg_kernel_matches_jax(case):
    """The port's local-block mg backward (its plain version) against the JAX
    package's ``rowwise_mg_local_loss_and_grads`` (interpret mode) on random
    blocks, heads and coarse windows, with the JAX package's wrapped row
    function and the port's ``halo_model`` of the same masks and offsets."""
    from odil_tpu.ops import rowwise_mg as jrmg
    from odil_tpu.transfer import _interp_matrix

    x0, g0, hx, r_lo = case
    X, Y, Tl, T_glob = 32, 16, 9, 17
    Xe = X if not hx else 18
    rng = np.random.default_rng(5)
    mk = lambda *shape: 0.3 * rng.normal(size=shape)
    t0s = [mk(Tl, Xe, Y) for _ in range(3)]
    coarse = [mk((Tl - 1) // 2 + 1, X // 2, Y // 2) for _ in range(3)]
    heads = [mk(1, Xe, Y) for _ in range(3)]
    consts = [mk(Xe, Y) for _ in range(2)]
    f0s = (0.7, 1.1, 0.9)
    mask = np.ones((Xe, Y))
    if hx:
        mask[:hx] = 0
        mask[Xe - hx :] = 0
    step = (1 / 16, 1 / X, 1 / Y)
    k = dict(kimp=10.0, kxreg=0.01, ktreg=1.0)
    jrow = jvt._make_row_fn(jnp, *step, k["kimp"], k["kxreg"], k["ktreg"])

    def wrapped(it, _T, rows, data_rows, pv, cons):
        pm, mt = cons[2], cons[3]
        res = jrow(it + mt[0, 0], T_glob, rows, data_rows, pv, cons[:2])
        m = pm * ((it != 0) | (mt[0, 1] > 0)).astype(pm.dtype)
        return tuple(r * m for r in res)

    meta = np.array([[g0, int(r_lo == 0)]], dtype=np.int32)
    Wx = _interp_matrix(X // 2, "c", np.float64)[(x0 + np.arange(Xe)) % X]
    Wy = _interp_matrix(Y // 2, "c", np.float64)
    cells = T_glob * X * Y
    jsums, (jdt0, jdP, jdh, _) = jrmg.rowwise_mg_local_loss_and_grads(
        wrapped, t0s, coarse, Wx, Wy, f0s, heads, consts=tuple(consts) + (mask, meta), nterms=6, hist=1,
        gscale=1.0 / cells, interpret=True,
    )
    tt = lambda xs: [torch.as_tensor(x) for x in xs]
    dt, dx, dy = step
    model = trw.RowModel(tvt._make_row_fn(dt, dx, dy, **k), tvt._make_row_vjp(dt, dx, dy, **k), cuda_model="veltracer",
                         scalars=dict(dt=dt, dx=dx, dy=dy, **k))
    hm = trw.halo_model(model, torch.as_tensor(mask), g0, T_glob, r_lo, Tl)
    sums, (dt0, dP, dh, dpar) = trmg.rowwise_mg_local_loss_and_grads(
        hm, tt(t0s), tt(coarse), f0s, tt(heads), x0=x0, consts=tt(consts), nterms=6, hist=1, gscale=1.0 / cells
    )
    assert dpar == ()
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=RTOL)
    for a, b in zip(list(dt0) + list(dP) + list(dh), list(jdt0) + list(jdP) + list(jdh)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(b).max())))


DECLINES = {
    # (spec, partition, kernel, multigrid, nt): JAX test_halo_onepass_gates
    # and test_halo_mg_fuse_declines_lane_partition_to_generic, plus an odd
    # local t block.
    "mg_multigrid_off": ("t:4", {"t": "t"}, "pallas_mg", False, 16),
    "no_kernel_decl": ("t:4", {"t": "t"}, "pallas", True, 16),
    "lane_partition": ("x:2,y:2", {"x": "x", "y": "y"}, "pallas_mg", True, 8),
    "odd_t_block": ("t:4", {"t": "t"}, "pallas_mg", True, 12),  # B = 3, two levels
    "plain_operator": ("x:2", {"x": "x"}, "xla", True, 8),
    "mg_runs": ("t:2,x:2", {"t": "t", "x": "x"}, "pallas_mg", True, 8),
}


@pytest.mark.parametrize("case", list(DECLINES))
def test_builders_decline_where_jax_declines(case):
    """Each one-pass builder returns None exactly where the JAX package's
    returns None (its generic builder asked with interpret=True, the CPU
    counterpart of the port's plain versions), and make_loss_grad_fn picks
    the same route."""
    spec, part, kernel, multigrid, nt = DECLINES[case]
    kw = dict(mg_nlvl=2) if nt % 8 else {}
    (jp, js), (tp, ts), _ = _pair(spec, part, kernel=kernel, multigrid=multigrid, nt=nt, **kw)
    built = {}
    for route, jb, tb in (("generic", jhalo._make_halo_onepass_loss_grad_fn, thalo._make_halo_onepass_loss_grad_fn),
                          ("mg", jhalo._make_halo_mg_loss_grad_fn, thalo._make_halo_mg_loss_grad_fn)):
        built[route] = jb(jp, js, interpret=True) is not None
        assert built[route] == (tb(tp, ts) is not None), route
    for fuse, other in (("generic", "mg"), ("mg", "generic")):
        want = fuse if built[fuse] else other if built[other] else None
        tfn = tp.make_loss_grad_fn(ts, halo=True, halo_fuse=fuse)
        assert (None if tfn is None else tfn.route) == want


def test_default_route_is_generic(monkeypatch):
    (_, _), (tp, ts), _ = _pair("t:2,x:2", {"t": "t", "x": "x"}, kernel="pallas_mg", nt=8)
    assert tp.make_loss_grad_fn(ts, halo=True).route == "generic"
    monkeypatch.setenv("ODIL_HALO_FUSE", "mg")
    assert tp.make_loss_grad_fn(ts, halo=True).route == "mg"
    with pytest.raises(ValueError):
        tp.make_loss_grad_fn(ts, halo=True, halo_fuse="other")


def _autograd_grad_fn(loss_fn):
    def fn(arrays, tracers):
        x = [a.detach().requires_grad_(True) for a in arrays]
        loss, (terms, norms) = loss_fn(x, tracers)
        return (loss.detach(), ([t.detach() for t in terms], [n.detach() for n in norms])), torch.autograd.grad(loss, x)

    return fn


@pytest.mark.parametrize("fuse", ["generic", "mg"])
def test_adam_through_halo_matches_unsharded(fuse):
    """15 Adam epochs through a halo route equal the port's unsharded route
    (autograd of make_loss_fn: fp64 takes no kernel route) at rtol 1e-10."""
    (_, _), (tp, ts), arrays = _pair("t:2,x:2", {"t": "t", "x": "x"}, kernel="pallas_mg", nt=8, seed=6)
    up, us, _ = tvt.build(nt=8, nx=16, ny=16, kernel="pallas_mg", dtype=np.float64, device="cpu")
    assert up.make_loss_grad_fn(us) is None
    ref = Adam(_autograd_grad_fn(up.make_loss_fn(us)[0]), arrays_from_numpy(arrays, device="cpu"), lr=0.02)
    got = Adam(tp.make_loss_grad_fn(ts, halo=True, halo_fuse=fuse), arrays_from_numpy(arrays, device="cpu"), lr=0.02)
    np.testing.assert_allclose(got.run_chunk(15).numpy(), ref.run_chunk(15).numpy(), rtol=RTOL)
    for a, b in zip(got.x, ref.x):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL * max(1.0, float(b.abs().max())))


def test_fp32_routes_match_jax():
    """fp32: both one-pass routes against the JAX package's halo loss (rtol
    1e-5 for terms, 1e-4 with atol 1e-6 * max for gradients)."""
    (jp, js), (tp, ts), arrays = _pair("t:2,x:2", {"t": "t", "x": "x"}, kernel="pallas_mg", nt=8, dtype=np.float32,
                                       seed=7)
    want = _jax_value_and_grad(jp, js, arrays)
    for fuse in ("generic", "mg"):
        _check(*_port_onepass(tp, ts, arrays, fuse), *want, rtol=1e-5, atol=1e-6)


def test_halo_rejects_what_jax_rejects():
    """The plan's build-time validation: a block narrower than the stencil
    and hand-made Raw terms."""
    with pytest.raises(ValueError, match="exceeds the local block"):
        _, (tp, ts), _ = _pair("t:8", {"t": "t"}, kernel="pallas", nt=8)
        tp.make_loss_fn(ts, halo=True)
