"""The probes and the mg kernel's ablation builds (plain versions, on the
CPU) against the JAX package's tools, and the port's roofline and
kernel-ablation tools run end to end on the CPU (the CUDA kernels are held
to the plain versions in test_torch_gpu.py).

The JAX tools build their probes and stubs inside their ``main``, so the
probes here copy ``benchmarks/roofline.py:120-136`` (copy3: kernel body,
grid and BlockSpec) and ``benchmarks/kernel_ablation.py:167-185`` (fma),
and the stubs ``kernel_ablation.py:254-274`` (the trivial row function,
``up2d_nomm``/``down2d_nomm`` and the field-batched entry points routed
through them), all run in interpret mode.  Tolerances: copy3 the same bits;
fma rtol 1e-6 (both round each step once: XLA's CPU loop fuses the
multiply-add, as the kernel's FFMA does); the
ablation plain versions fp64 rtol 1e-10 (terms and gradients, atol 1e-10 x
max|ref| for the gradients) and fp32 as the mg kernels are held
(test_torch_rowwise_mg.py: terms rtol 1e-5, gradients rtol 1e-4 with atol
1e-6 x max|ref|)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from odil_torch.models import veltracer as tvt
from odil_torch.ops import mg_ablation, probes
from odil_torch.ops import rowwise_mg as trmg
from odil_torch.tools import kernel_ablation, roofline
from odil_tpu.backend import ModJax
from odil_tpu.models import veltracer as jvt
from odil_tpu.ops import rowwise_mg as jrmg

FACTORS0 = (0.7, 1.1, 0.9)
TOL = {np.float64: (1e-10, 1e-10, 1e-10), np.float32: (1e-5, 1e-4, 1e-6)}


def _jax_copy3(T, nx):
    """benchmarks/roofline.py:120-136's copy3, in interpret mode."""

    def copy_kernel(*refs):
        n = len(refs) // 2
        for i in range(n):
            refs[n + i][...] = refs[i][...]

    bx = nx if nx <= 256 else 128
    spec = pl.BlockSpec((1, bx, nx), lambda i, q: (i, q, 0))
    return pl.pallas_call(
        copy_kernel,
        grid=(T, nx // bx),
        in_specs=[spec] * 3,
        out_specs=[spec] * 3,
        out_shape=[jax.ShapeDtypeStruct((T, nx, nx), jnp.float32)] * 3,
        interpret=True,
    )


def _jax_fma(T, nx, K=128):
    """benchmarks/kernel_ablation.py:167-185's fma, in interpret mode."""

    def fma_kernel(x_ref, o_ref):
        x = x_ref[...]
        a = jnp.float32(1.0000001)
        b = jnp.float32(1e-7)
        for _ in range(K):
            x = x * a + b
        o_ref[...] = x

    spec = pl.BlockSpec((1, nx, nx), lambda i: (i, 0, 0))
    return pl.pallas_call(
        fma_kernel, grid=(T,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((T, nx, nx), jnp.float32), interpret=True,
    )


@pytest.mark.parametrize("shape", [(5, 16, 16), (2, 512, 512)])
def test_copy3_plain_matches_jax_probe(shape):
    """(2, 512, 512) takes the JAX probe's x-tiled branch (128-row blocks)."""
    T, nx, _ = shape
    rng = np.random.default_rng(1)
    arrays = [rng.random(shape).astype(np.float32) for _ in range(3)]
    want = _jax_copy3(T, nx)(*[jnp.asarray(a) for a in arrays])
    got = probes.copy3(*[torch.as_tensor(a) for a in arrays])
    for g, w, a in zip(got, want, arrays):
        assert np.array_equal(g.numpy(), np.asarray(w)) and np.array_equal(g.numpy(), a)


def test_fma_plain_matches_jax_probe():
    T, nx = 3, 16
    x = np.random.default_rng(2).random((T, nx, nx)).astype(np.float32)
    want = np.asarray(_jax_fma(T, nx)(jnp.asarray(x)))
    got = probes.fma(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert probes.fma(torch.as_tensor(x), 0).numpy().tolist() == x.tolist()


def _jax_trivial_row_fn(it, T, rows, data_rows, params, consts_v):
    """benchmarks/kernel_ablation.py:254-261 (nterms = 6)."""
    s = None
    for r in rows:
        for p in r:
            s = p if s is None else s + p
    for c in consts_v:
        s = s + c
    return tuple(s * (0.1 * (k + 1)) for k in range(6))


def _reshape_nomm(x, A, B):
    reps = (-(-A // x.shape[0]), -(-B // x.shape[1]))
    return jnp.tile(x, reps)[:A, :B]


def _no_matmul_stubs(monkeypatch):
    """kernel_ablation.py:263-274 and :298-310: the stubbed projections, the
    field-batched entry points routed through them."""
    up = lambda c, Wx, Wy: _reshape_nomm(c, Wx.shape[0], Wy.shape[0])
    down = lambda d, Wx, Wy: _reshape_nomm(d, Wx.shape[1], Wy.shape[1]) * 1.0
    monkeypatch.setattr(jrmg, "_up2d", up)
    monkeypatch.setattr(jrmg, "_down2d", down)
    monkeypatch.setattr(jrmg, "_up2d_fields", lambda cs, Wx, Wy: [jrmg._up2d(c, Wx, Wy) for c in cs])
    monkeypatch.setattr(jrmg, "_down2d_fields", lambda ds, Wx, Wy: [jrmg._down2d(d, Wx, Wy) for d in ds])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", ["trivial-row", "no-matmul"])
def test_ablation_plain_matches_jax_stubs(variant, dtype, monkeypatch):
    """The plain versions of the ablation builds against the JAX tool's
    stubs through ``odil_tpu.ops.rowwise_mg.rowwise_mg_loss_and_grads``
    (interpret mode) at (9, 16, 16): terms and gradients."""
    T, X, Y = 9, 16, 16
    rng = np.random.default_rng(17)
    t0s = [0.3 * rng.normal(size=(T, X, Y)).astype(dtype) for _ in range(3)]
    coarse = [0.3 * rng.normal(size=(T // 2 + 1, X // 2, Y // 2)).astype(dtype) for _ in range(3)]
    consts = [rng.normal(size=(X, Y)).astype(dtype) for _ in range(2)]
    step, k = (1.0 / 8, 1.0 / X, 1.0 / Y), dict(kimp=10.0, kxreg=0.01, ktreg=1.0)
    model = trmg.RowModel(tvt._make_row_fn(*step, **k), tvt._make_row_vjp(*step, **k), cuda_model="veltracer",
                          scalars=dict(dt=step[0], dx=step[1], dy=step[2], **k))
    if variant == "trivial-row":
        jfn, plain = _jax_trivial_row_fn, mg_ablation._backward_trivial_row_plain
    else:
        _no_matmul_stubs(monkeypatch)
        jfn, plain = jvt._make_row_fn(ModJax(), *step, **k), mg_ablation._backward_no_matmul_plain
    jterms, (jdt0, jdc, _) = jrmg.rowwise_mg_loss_and_grads(
        jfn, t0s=[jnp.asarray(a) for a in t0s], coarse=[jnp.asarray(a) for a in coarse], factors0=FACTORS0,
        consts=[jnp.asarray(a) for a in consts], nterms=6, hist=1, interpret=True,
    )
    tt = lambda xs: tuple(torch.as_tensor(a) for a in xs)
    cells = T * X * Y
    g = torch.full((6,), 1.0 / cells, dtype=torch.float64 if dtype == np.float64 else torch.float32)
    dt0, dc, sums = plain(model, 6, 1, FACTORS0, tt(t0s), tt(coarse), tt(consts), g, True)
    rt, rg, ag = TOL[dtype]
    np.testing.assert_allclose((sums / cells).numpy(), np.asarray(jterms), rtol=rt)
    for a, b in zip(dt0 + dc, list(jdt0) + list(jdc)):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=rg, atol=ag * max(1.0, np.abs(b).max()))


def test_ablated_routes_the_one_pass_loss_through_the_variant():
    """Within ``ablated``, the flagship's one-pass route on the CPU gives the
    variant's plain terms; outside it, the real ones again."""
    problem, state, extra = tvt.build(nt=4, nx=16, ny=16, kernel="pallas_mg", device="cpu")
    x = problem.domain.arrays_from_state(state)
    loss = lambda: float(problem.make_loss_grad_fn(state)(x, problem.tracers)[0][0])
    base = loss()
    with mg_ablation.ablated("trivial-row"):
        trivial = loss()
    assert loss() == base and trivial != base


TOOL_ARGV = ["--device", "cpu", "--nt", "4", "--nx", "16", "--length", "2", "--reps", "1"]
ROOFLINE_KEYS = ("epoch_ms", "lossgrad_ms", "copy_ms", "min_bytes_MB", "achieved_GBps", "copy_ceiling_GBps",
                 "pct_of_hbm_peak", "pct_of_copy_ceiling", "kernel_ops_per_eval_G", "arith_intensity_flops_per_byte",
                 "rep_times_ms")
ABLATION_KEYS = ("ms_per_iter", "row_math_bound_ms", "in_kernel_matmul_bound_ms", "xla_prologue_epilogue_ms",
                 "vpu_ceiling_tflops", "row_math_gflops_per_eval", "row_math_at_ceiling_ms")


def _finite(obj):
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite(v) for v in obj)
    return not isinstance(obj, float) or np.isfinite(obj)


@pytest.mark.parametrize("tool", ["roofline", "kernel_ablation"])
def test_tool_runs_on_the_cpu(tool, capsys):
    if tool == "roofline":
        out, keys = roofline.main(TOOL_ARGV), ROOFLINE_KEYS
        assert out["rep_times_ms"]["epoch"] and set(out["chunk_last_losses"]) == {"bf16", "fp32"}
    else:
        argv = TOOL_ARGV + ["--variants", "full,kernel-only,trivial-row,no-matmul,vpu,raw-bwd"]
        out, keys = kernel_ablation.main(argv), ABLATION_KEYS
        assert set(out["ms_per_iter"]) == {"full", "kernel-only", "trivial-row", "no-matmul"}
        assert set(out["no_counterpart"]) == {"raw-bwd"}
    assert out["device"].startswith("cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    missing = [k for k in keys if k not in out]
    assert not missing and _finite(out), (missing, out)
