#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths once on one NVIDIA card.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py            # the full check (400 training epochs at 256^2)
    python3 chip_smoke.py --epochs 40   # shorter flagship training phases

Phases, any failure exits non-zero and prints no result:

1. Build: the CUDA libraries of ``odil_torch/csrc/`` (``rowwise_mg.cu``,
   ``rowwise.cu``) compile with nvcc for sm_90a into ``build/odil_torch/``,
   one nvcc per source, started together.
2. Kernels vs their plain PyTorch versions, on seeded random fields and the
   real tracer planes (terms rtol 1e-5; gradients rtol 1e-4 with atol
   1e-6 * max|ref|):
   - the mg kernels at the flagship shapes -- t0 (65,256,256) x3, P
     (33,128,128) x3: backward+sums, forward, and the loss-only path
     (forward kernel + autograd) against autograd of the plain forward;
     backward+sums also at (65,512,512) x3 with P (33,256,256) x3;
   - the generic row-wise kernels (forward, backward+sums, backward) at
     (65,256,256), (65,64,64) and (65,512,512) x3, and their loss-only path
     at (65,256,256).
3. Paths, each with the launch counters zeroed just before it and read just
   after (Adam lr=0.01, fp32 slots):
   a. ``kernel="pallas_mg"`` at (64,256,256) against
      ``docs/parity_data/ref_velt_256.csv`` (epoch 0 within 1e-5, every row
      within 15%), the mg backward once per epoch; then its loss-only path.
   b. ``kernel="pallas"`` at (64,256,256) against the same reference, the
      generic backward+sums once per epoch and no other kernel; its
      loss-only path (one forward, one backward); the same loss and
      gradients as ``pallas_mg`` at a random and at the trained state.
   c. ``kernel="pallas"`` at (64,64,64), 350 epochs, against
      ``ref_velt_64.csv`` (epoch 0 within 1e-5, epoch 50 within 15%; the later
      rows are printed, not gated); its loss-only path.
   d. ``kernel="pallas_mg"`` and ``kernel="pallas"`` at (64,512,512), 40 epochs
      each, and the loss-only path of ``pallas``: epoch 0 within 1e-5 of the
      plain operator's loss on the zero state, computed on the card.
   e. heat inverse conductivity at 64^2 (``heat.build(kernel="pallas",
      infer_k=True, imposed="stripe")``, the converged lane of
      tests/test_converged.py:63-82): Adam lr 0.001, 1500 epochs from the
      JAX package's initial conductivity net
      (``odil_torch/data/heat_inverse_64.json``, written by
      tests/test_torch_heat.py); epoch 0 within 1e-5 of the JAX package's
      loss; the min of the last three history rows (every 100 epochs) of
      loss, error_u and error_k within 1.5, 1.3 and 1.25 times the medians of
      ``docs/parity_data/ref_heat_seeds.csv``; one generic backward+sums per
      epoch and no other kernel; its loss-only path.
   f. heat at 1024^2, 50 epochs: epoch 0 within 1e-5 of the plain operator
      (``kernel="xla"``) on the card; its loss-only path.
   g. wave at 64^2, fp32, Adam lr 0.001, 200 epochs, against the plain
      operator trained the same way on the card: epoch 0 within 1e-5 and
      every 20-epoch row within 1%; then wave at 1024^2, 40 epochs, epoch 0
      against the plain operator; their loss-only paths.
   The heat and wave kernels (forward, backward+sums, backward, with the
   conductivity net's params and their cotangents) are held first to their
   plain versions evaluated in fp64 on the same inputs at 64^2 and 1024^2,
   and at a narrow (7, 5) plane (the periodic wrap).
4. Timing: ms/epoch of the training loops with a profiler breakdown of the
   two 256^2 routes and the heat 64^2 route, and each kernel's time (a CUDA
   graph of 50 calls) beside its bound, its plain version's time and its
   launches on its path, every line tagged with the card's name and power
   limit.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import concurrent.futures
import csv
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PARITY = os.path.join(HERE, "docs", "parity_data")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
# fp32 operations per fine cell of each function, all three fields, counted
# from the formulas: the six residual terms (40), their adjoint (60), the mg
# rebuild of a fine value (blend of 4 coarse taps, two 2-tap contractions,
# f0*t0 + up: 23 per field) and its transposed prolongation (12).
OPS_ROWS_FORWARD = 40
OPS_ROWS_BACKWARD = OPS_ROWS_FORWARD + 60
OPS_FORWARD = 3 * 23 + OPS_ROWS_FORWARD
OPS_BACKWARD = OPS_FORWARD + 60 + 12
# The heat and wave row models (heat_row.cuh, wave_row.cuh), per residual
# cell, a tanhf or expf counted as one operation: heat's forward runs the
# conductivity net at both faces (2 x (70 multiply-adds and products + 11
# transcendentals + 3)) and the stencil (~30); its backward adds the
# stencil's adjoint (~30), the net's param adjoint at both faces (2 x 169)
# and the gather (6).  Wave: the stencil (16) and its adjoint (20).
OPS_HEAT_FORWARD = 200
OPS_HEAT_BACKWARD = OPS_HEAT_FORWARD + 30 + 2 * 169 + 6
OPS_WAVE_FORWARD = 16
OPS_WAVE_BACKWARD = OPS_WAVE_FORWARD + 20
DEVICE = "cuda"
# The grids in cells: the flagship (the whole-plane TPU kernels), 64^3 (the
# blocked ones) and 512^2 (the x-tiled ones).
SIZES = {"256": (64, 256, 256), "64": (64, 64, 64), "512": (64, 512, 512)}
# The 1-D grids (T, N) of the heat and wave paths, and the narrow plane.
SIZES_1D = {"64": (64, 64), "1024": (1024, 1024)}
NARROW_1D = (7, 5)
HEAT_DATA = os.path.join(HERE, "odil_torch", "data", "heat_inverse_64.json")
HEAT_EPOCHS, HEAT_EVERY = 1500, 100
# The converged lane's margins on the reference seeds' medians
# (tests/test_converged.py:81).
HEAT_MARGINS = {"loss": 1.5, "error_u": 1.3, "error_k": 1.25}
CHUNK = 10
TERMS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def close(a, b, rtol, atol_frac):
    """Max |a-b| and whether |a-b| <= rtol*|b| + atol_frac*max|b| everywhere."""
    a, b = a.detach(), b.detach()
    err = (a - b).abs()
    atol = atol_frac * float(b.abs().max())
    ok = bool((err <= rtol * b.abs() + atol).all())
    return float(err.max()), ok


def close_all(got, want):
    """(max |a-b|, all within the gradient tolerance) over pairs of tensors."""
    errs = [close(a, b, GRAD_RTOL, GRAD_ATOL) for a, b in zip(got, want)]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


def rel_err(a, b):
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def time_ms(torch, fn, reps):
    """Mean device time of fn over `reps` calls (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(torch, fn, reps):
    """Device time of one call of a kernel wrapper: `reps` calls captured in
    one CUDA graph and replayed between two CUDA events, so that the
    wrapper's host work (checks, allocation, ctypes) is not in the time --
    at (65,64,64) it exceeds the kernel's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_epochs(torch, opt, epoch_ms, tag, n=5):
    """Where an epoch's time goes: device kernels by name over n epochs
    (torch.profiler), their count per epoch and the card's busy share of the
    unprofiled ms/epoch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.run_chunk(n)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    if not by_name:
        print(f"profile: torch.profiler recorded no device kernels {tag}")
        return
    busy = sum(t for t, _ in by_name.values()) / n
    count = sum(c for _, c in by_name.values()) / n
    print(f"profile: {busy:.4f} ms of kernels per epoch in {count:.0f} launches; "
          f"card busy {100 * busy / epoch_ms:.1f}% of {epoch_ms:.4f} ms/epoch {tag}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t / n:.4f} ms/epoch in {c / n:.0f} launches: {name[:100]}")


def build_all(_build):
    """Compiles every CUDA source, one nvcc each, all started together."""
    names = ("rowwise_mg", "rowwise")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        results = dict(zip(names, ex.map(_build.compile_source, names)))
    for name, (path, seconds, log) in results.items():
        print(f"build: {os.path.relpath(path, HERE)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())


class Counters:
    """The launch counters of the four kernel wrappers."""

    def __init__(self, rmg, rw):
        self.wrappers = {
            "backward_mg": rmg.backward_mg_cuda, "forward_mg": rmg.forward_mg_cuda,
            "backward_rows": rw.backward_cuda, "forward_rows": rw.forward_cuda,
        }

    def zero(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self):
        return {k: w.launches for k, w in self.wrappers.items()}


def read_ref(name):
    with open(os.path.join(PARITY, name)) as fh:
        return {int(r["epoch"]): float(r["loss"]) for r in csv.DictReader(fh)}


def train(torch, Adam, grad_fn, arrays, epochs, lr=0.01, on_chunk=None):
    """Adam for `epochs` epochs in chunks of CHUNK: (optimizer, losses, host
    ms/epoch of each chunk).  on_chunk(epoch, optimizer) runs after each
    chunk, outside the timed region."""
    opt = Adam(grad_fn, arrays, lr=lr)
    losses, chunk_ms = [], []
    torch.cuda.synchronize()
    for _ in range(epochs // CHUNK):
        t_start = time.perf_counter()
        out = opt.run_chunk(CHUNK)
        losses += out.cpu().tolist()  # waits for the card once per chunk
        chunk_ms.append((time.perf_counter() - t_start) * 1e3 / CHUNK)
        if on_chunk is not None:
            on_chunk(len(losses), opt)
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        fail("non-finite training loss")
    return opt, losses, chunk_ms


def steady_ms(chunk_ms):
    steady = chunk_ms[1:] if len(chunk_ms) > 3 else chunk_ms
    return statistics.median(steady), len(steady)


def trajectory_rows(losses):
    """{epoch: loss} at epoch 0 and every CHUNK epochs, as the reference CSVs
    record them."""
    rows = {0: losses[0]}
    rows.update({e: losses[e - 1] for e in range(CHUNK, len(losses) + 1, CHUNK)})
    return rows


def expect_counts(counts, want, what):
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"{what}: the launch counters read {counts}, expected {want}")


def autograd_loss_grad_fn(torch, problem, state):
    """The plain route's training step: autograd of make_loss_fn."""
    loss_fn, _ = problem.make_loss_fn(state)

    def fn(arrays, tracers):
        x = [a.detach().requires_grad_(True) for a in arrays]
        loss, aux = loss_fn(x, tracers)
        return (loss.detach(), aux), torch.autograd.grad(loss, x)

    return fn


def row_case_1d(torch, np, th, tw, Context, which, T, N, rand, dev):
    """(model, nterms, hist, fields, params, data, consts) of the heat (the
    converged lane's configuration) or wave row model at (T, N): seeded
    random fields, the build's data and consts, the build's conductivity
    net plus seeded noise."""
    if which == "wave":
        p, s, e = tw.build(nt=T, nx=N, dtype=np.float32, multigrid=False, kernel="pallas", device=dev)
        model = tw._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
        consts = (e.init_u, e.init_ut, torch.arange(N, dtype=torch.float32, device=dev))
        return model, 1, 2, (rand(T, N),), (), (rand(T, 1), rand(T, 1)), consts
    p, s, e = th.build(nt=T, nx=N, infer_k=True, imposed="stripe", nimp=200, multigrid=False, kernel="pallas",
                       device=dev)
    model, names, params = th._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
    params = tuple(q + rand(*q.shape) for q in params)
    zero = torch.zeros((1, 1), device=dev)
    u0 = e.init_u
    consts = (u0, torch.roll(u0, 1, 0), torch.roll(u0, -1, 0), torch.arange(N, dtype=torch.float32, device=dev),
              zero, zero)
    return model, len(names), 1, (rand(T, N) + 0.5,), params, (e.imp_mask, e.imp_u + rand(T, N)), consts


def heat_errors(torch, th, problem, extra, x):
    """error_u and error_k of the heat example (examples/heat/heat.py::
    compute_error) at the flat arrays x."""
    st = problem.state_from_arrays(x)
    u = problem.domain.get_regular_array(st.fields["u"])
    err_u = float(torch.sqrt(torch.mean((u - extra.ref_u) ** 2)))
    uk = torch.as_tensor(extra.ref_uk, device=u.device)
    k = th.squash_k(problem.domain.neural_net(st, "k_net")(uk)[0], problem.domain.mod, extra.args.kmax)
    ref_k = torch.as_tensor(extra.ref_k, device=u.device, dtype=k.dtype)
    err_k = float(torch.sqrt(torch.mean((k - ref_k) ** 2)) / ref_k.max())
    return err_u, err_k


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=400, help="Flagship training epochs (multiple of 10)")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the random kernel inputs")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs only on the card")
    if not os.path.isdir(os.path.join(HERE, "odil_torch")):
        fail(f"no odil_torch package beside {__file__}: run from a checkout of the repository")
    sys.path.insert(0, HERE)

    from odil_torch.context import Context
    from odil_torch.models import heat as th
    from odil_torch.models import veltracer as vt
    from odil_torch.models import wave as tw
    from odil_torch.ops import _build
    from odil_torch.ops import rowwise as rw
    from odil_torch.ops import rowwise_mg as rmg
    from odil_torch.optim import Adam

    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}")

    # -- Phase 1: build --------------------------------------------------------
    build_all(_build)
    rmg._library()
    rw._library()
    counters = Counters(rmg, rw)

    # -- Phase 2: kernels vs plain versions -------------------------------------
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    report = {}  # kernel name -> max abs error against its plain version
    problems = {s: vt.build(nt=n, nx=x, ny=y, kernel="pallas_mg", device=dev) for s, (n, x, y) in SIZES.items()}

    def row_model(size):
        problem, state, extra = problems[size]
        model, nterms = vt._row_model(Context(problem.domain, state, extra=extra))
        return model, nterms, (extra.u_init, extra.u_final)

    model, nterms, consts = row_model("256")
    NT, NX, NY = SIZES["256"]
    T, X, Y, Tc = NT + 1, NX, NY, NT // 2 + 1
    t0s = tuple(rand(T, X, Y) for _ in range(3))
    coarse = tuple(rand(Tc, X // 2, Y // 2) for _ in range(3))
    t0s, coarse, f0s, cells = rmg._prepare_mg(t0s, coarse, (1.0, 1.0, 1.0), 1)
    Wx, Wy = rmg._interp_matrices(X // 2, Y // 2, torch.float32, dev)
    g = torch.full((nterms,), 1.0 / cells, device=dev)

    kd0, kP, ksums = rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, True)
    pd0, pP, psums = rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, True)
    torch.cuda.synchronize()
    e_s, ok_s = close(ksums.double() / cells, psums.double() / cells, TERMS_RTOL, 0.0)
    e_g, ok_g = close_all(kd0 + kP, pd0 + pP)
    print(f"backward+sums: max|d terms| {e_s:.3e} (max rel {rel_err(ksums, psums):.2e}), "
          f"max|d(dt0,dP)| {e_g:.3e} {tag}")
    if not (ok_s and ok_g):
        fail(f"backward+sums kernel disagrees with its plain version (sums ok={ok_s}, grads ok={ok_g})")
    report["backward_mg_sums"] = e_g

    fsums = rmg.forward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts)
    pf = rmg._forward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts)
    torch.cuda.synchronize()
    e_f, ok_f = close(fsums.double() / cells, pf.double() / cells, TERMS_RTOL, 0.0)
    print(f"forward: max|d terms| {e_f:.3e} (max rel {rel_err(fsums, pf):.2e}) {tag}")
    if not ok_f:
        fail(f"forward kernel disagrees with its plain version: {fsums} vs {pf}")
    report["forward_mg"] = e_f

    leaves_k = [t.clone().requires_grad_(True) for t in t0s + coarse]
    terms_k = rmg.rowwise_loss_terms_mg(model, leaves_k[:3], leaves_k[3:], f0s, consts, nterms, 1)
    grads_k = torch.autograd.grad(sum(terms_k), leaves_k)
    leaves_p = [t.clone().requires_grad_(True) for t in t0s + coarse]
    with torch.enable_grad():
        fines = [
            rmg._recon_rows(t, c, range(T), Wx, Wy, f) for t, c, f in zip(leaves_p[:3], leaves_p[3:], f0s)
        ]
        loss_p = rw._forward_plain(model, nterms, 1, fines, (), (), consts).sum() / cells
    grads_p = torch.autograd.grad(loss_p, leaves_p)
    torch.cuda.synchronize()
    e_lg, ok_lg = close_all(grads_k, grads_p)
    e_l, ok_l = close(torch.stack(terms_k).sum().double(), loss_p.double(), TERMS_RTOL, 0.0)
    print(f"loss-only path: max|dloss| {e_l:.3e}, max|dgrad| {e_lg:.3e} {tag}")
    if not (ok_l and ok_lg):
        fail(f"forward kernel + autograd disagrees with plain autograd (loss ok={ok_l}, grads ok={ok_lg})")
    report["backward_mg"] = e_lg
    del leaves_k, leaves_p, grads_k, grads_p, fines

    # The mg backward+sums at 512^2: the shapes of the TPU's x-tiled one-pass.
    model512, nterms512, consts512 = row_model("512")
    n, x, y = SIZES["512"]
    t0s512 = tuple(rand(n + 1, x, y) for _ in range(3))
    coarse512 = tuple(rand(n // 2 + 1, x // 2, y // 2) for _ in range(3))
    cells512 = t0s512[0].numel()
    g512 = torch.full((nterms512,), 1.0 / cells512, device=dev)
    k = rmg.backward_mg_cuda(model512, nterms512, 1, f0s, t0s512, coarse512, consts512, g512, True)
    p = rmg._backward_mg_plain(model512, nterms512, 1, f0s, t0s512, coarse512, consts512, g512, True)
    torch.cuda.synchronize()
    e_s, ok_s = close(k[2].double(), p[2].double(), TERMS_RTOL, 0.0)
    e_g, ok_g = close_all(k[0] + k[1], p[0] + p[1])
    print(f"backward+sums at {tuple(t0s512[0].shape)}: max|d terms| {e_s:.3e}, max|d(dt0,dP)| {e_g:.3e} {tag}")
    if not (ok_s and ok_g):
        fail(f"the mg backward+sums kernel disagrees with its plain version at {tuple(t0s512[0].shape)}")
    report["backward_mg_sums_512"] = e_g
    del k, p

    # The generic kernels at the shapes where the JAX package takes the
    # whole-plane (256^2), blocked (64^3) and x-tiled (512^2) TPU kernels.
    fields = {}
    for size in SIZES:
        m, nt_, cs = row_model(size)
        n, x, y = SIZES[size]
        fs = tuple(rand(n + 1, x, y) for _ in range(3))
        fields[size] = fs
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        kf = rw.forward_cuda(m, nt_, 1, fs, (), (), cs)
        pf = rw._forward_plain(m, nt_, 1, fs, (), (), cs)
        kd, _, ks = rw.backward_cuda(m, nt_, 1, fs, (), (), cs, gs, True)
        pd, _, ps = rw._backward_plain(m, nt_, 1, fs, (), (), cs, gs, True)
        kd2, _, _ = rw.backward_cuda(m, nt_, 1, fs, (), (), cs, gs, False)
        torch.cuda.synchronize()
        e_f, ok_f = close(kf.double(), pf.double(), TERMS_RTOL, 0.0)
        e_s, ok_s = close(ks.double(), ps.double(), TERMS_RTOL, 0.0)
        e_g, ok_g = close_all(kd, pd)
        e_g2, ok_g2 = close_all(kd2, pd)
        print(f"generic kernels at {tuple(fs[0].shape)}: forward max|d sums| {e_f:.3e} (rel {rel_err(kf, pf):.2e}), "
              f"backward+sums max|d sums| {e_s:.3e} max|d dfields| {e_g:.3e}, backward max|d dfields| "
              f"{e_g2:.3e} {tag}")
        if not (ok_f and ok_s and ok_g and ok_g2):
            fail(f"a generic kernel disagrees with its plain version at {tuple(fs[0].shape)}: forward {ok_f}, "
                 f"sums {ok_s}, backward+sums {ok_g}, backward {ok_g2}")
        report[f"forward_rows_{size}"] = e_f
        report[f"backward_rows_sums_{size}"] = e_g
        report[f"backward_rows_{size}"] = e_g2
        del kd, pd, kd2

    fs = fields["256"]
    leaves_k = [f.clone().requires_grad_(True) for f in fs]
    terms_k = rw.rowwise_loss_terms(model, leaves_k, consts=consts, nterms=nterms, hist=1)
    grads_k = torch.autograd.grad(sum(terms_k), leaves_k)
    leaves_p = [f.clone().requires_grad_(True) for f in fs]
    with torch.enable_grad():
        loss_p = rw._forward_plain(model, nterms, 1, leaves_p, (), (), consts).sum() / fs[0].numel()
    grads_p = torch.autograd.grad(loss_p, leaves_p)
    torch.cuda.synchronize()
    e_l, ok_l = close(torch.stack(terms_k).sum().double(), loss_p.double(), TERMS_RTOL, 0.0)
    e_lg, ok_lg = close_all(grads_k, grads_p)
    print(f"generic loss-only path: max|dloss| {e_l:.3e}, max|dgrad| {e_lg:.3e} {tag}")
    if not (ok_l and ok_lg):
        fail(f"generic forward kernel + autograd disagrees with plain autograd (loss {ok_l}, grads {ok_lg})")
    del leaves_k, leaves_p, grads_k, grads_p

    # The heat and wave row models (1-D planes) at their paths' shapes and at
    # a narrow plane, against their plain versions evaluated in fp64 on the
    # same inputs (the reference's own rounding stays out of the tolerance:
    # the param cotangents are sums over every cell).
    cases_1d = {}
    for which in ("heat", "wave"):
        for size, (n, x) in list(SIZES_1D.items()) + [("narrow", NARROW_1D)]:
            case = row_case_1d(torch, np, th, tw, Context, which, n, x, rand, dev)
            m, nt_, h, fs, ps, ds, cs = case
            wide = lambda ts: tuple(t.double() for t in ts)
            gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
            kf = rw.forward_cuda(m, nt_, h, fs, ps, ds, cs)
            kd, kp, ks = rw.backward_cuda(m, nt_, h, fs, ps, ds, cs, gs, True)
            kd2, kp2, _ = rw.backward_cuda(m, nt_, h, fs, ps, ds, cs, gs, False)
            pf = rw._forward_plain(m, nt_, h, wide(fs), wide(ps), wide(ds), wide(cs))
            pd, pp, ps_ = rw._backward_plain(m, nt_, h, wide(fs), wide(ps), wide(ds), wide(cs), gs.double(), True)
            torch.cuda.synchronize()
            e_f, ok_f = close(kf.double(), pf, TERMS_RTOL, 0.0)
            e_s, ok_s = close(ks.double(), ps_, TERMS_RTOL, 0.0)
            e_g, ok_g = close_all([a.double() for a in kd + kp], list(pd) + list(pp))
            e_g2, ok_g2 = close_all([a.double() for a in kd2 + kp2], list(pd) + list(pp))
            e_p = max([float((a.double() - b).abs().max()) for a, b in zip(kp, pp)], default=0.0)
            print(f"{which} kernels at {tuple(fs[0].shape)}: forward max|d sums| {e_f:.3e} (rel {rel_err(kf, pf):.2e}), "
                  f"backward+sums max|d sums| {e_s:.3e} max|d (dfields, dparams)| {e_g:.3e} (dparams {e_p:.3e}), "
                  f"backward {e_g2:.3e} {tag}")
            if not (ok_f and ok_s and ok_g and ok_g2):
                fail(f"a {which} kernel disagrees with its plain version at {tuple(fs[0].shape)}: forward {ok_f}, "
                     f"sums {ok_s}, backward+sums {ok_g}, backward {ok_g2}")
            if size != "narrow":
                cases_1d[(which, size)] = case
                report[f"forward_rows_{which}_{size}"] = e_f
                report[f"backward_rows_sums_{which}_{size}"] = e_g
                report[f"backward_rows_{which}_{size}"] = e_g2
            del kd, kp, kd2, kp2, pd, pp

    # -- Phase 3: the paths ----------------------------------------------------
    ref256, ref64 = read_ref("ref_velt_256.csv"), read_ref("ref_velt_64.csv")
    launches = {}  # kernel name -> launches on its path
    loops = {}  # route -> (optimizer, ms/epoch)

    def check_rows(losses, ref, what, gate_all=True, gated=()):
        rows = trajectory_rows(losses)
        rel = {e: abs(rows[e] - ref[e]) / abs(ref[e]) for e in rows if e in ref}
        worst = max(rel, key=rel.get)
        print(f"{what}: {len(losses)} epochs, epoch-0 loss {rows[0]!r} (reference {ref[0]!r}, rel {rel[0]:.2e}); "
              f"worst row epoch {worst}: {rows[worst]!r} vs {ref[worst]!r} ({100 * rel[worst]:.2f}%); "
              f"final {rows[max(rows)]!r} {tag}")
        if rel[0] > 1e-5:
            fail(f"{what}: epoch-0 loss {rows[0]} differs from the reference {ref[0]} by {rel[0]:.2e} (limit 1e-5)")
        for e in (rel if gate_all else gated):
            if rel[e] > 0.15:
                fail(f"{what}: epoch {e}: loss {rows[e]} is {100 * rel[e]:.1f}% from the reference (limit 15%)")
        return rows, rel

    def loss_only(problem, state, x, grad_fn, what, want):
        """The loss-only path (make_loss_fn + autograd) at x, its launches
        against `want`, and its loss and gradients against grad_fn's."""
        loss_fn, _ = problem.make_loss_fn(state)
        xs = [a.detach().clone().requires_grad_(True) for a in x]
        counters.zero()
        loss_e, _ = loss_fn(xs, problem.tracers)
        grads_e = torch.autograd.grad(loss_e, xs)
        torch.cuda.synchronize()
        counts = counters.read()
        expect_counts(counts, want, f"{what} loss-only path")
        (loss_t, _), grads_t = grad_fn(x, problem.tracers)
        e, ok = close_all(grads_e, grads_t)
        print(f"{what} loss-only vs one-pass route: loss {float(loss_e)!r} vs {float(loss_t)!r}, "
              f"max|dgrad| {e:.3e}; launches {counts} {tag}")
        if abs(float(loss_e) - float(loss_t)) > TERMS_RTOL * abs(float(loss_t)) or not ok:
            fail(f"{what}: the loss-only path and the one-pass route disagree")
        return counts

    none = {"backward_mg": 0, "forward_mg": 0, "backward_rows": 0, "forward_rows": 0}

    # a. pallas_mg at 256^2 (the flagship's fused route).
    problem, state, _ = problems["256"]
    grad_mg = problem.make_loss_grad_fn(state)
    if grad_mg is None:
        fail("make_loss_grad_fn declined the flagship: the fused route did not apply")
    counters.zero()
    opt, losses, chunk_ms = train(torch, Adam, grad_mg, problem.domain.arrays_from_state(state), args.epochs)
    expect_counts(counters.read(), dict(none, backward_mg=len(losses)), "pallas_mg training at 256^2")
    launches["backward_mg_sums"] = counters.read()["backward_mg"]
    check_rows(losses, ref256, "training (pallas_mg)")
    counts = loss_only(problem, state, opt.x, grad_mg, "pallas_mg", dict(none, forward_mg=1, backward_mg=1))
    launches["forward_mg"], launches["backward_mg"] = counts["forward_mg"], counts["backward_mg"]
    loops["pallas_mg 256"] = (opt, steady_ms(chunk_ms))

    # b. pallas at 256^2: the generic one-pass route.
    problem_p, state_p, _ = vt.build(*SIZES["256"], kernel="pallas", device=dev)
    grad_p = problem_p.make_loss_grad_fn(state_p)
    if grad_p is None:
        fail("make_loss_grad_fn declined kernel='pallas': the one-pass route did not apply")
    counters.zero()
    opt_p, losses, chunk_ms = train(torch, Adam, grad_p, problem_p.domain.arrays_from_state(state_p), args.epochs)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses)), "pallas training at 256^2")
    launches["backward_rows_sums_256"] = counters.read()["backward_rows"]
    check_rows(losses, ref256, "training (pallas)")
    counts = loss_only(problem_p, state_p, opt_p.x, grad_p, "pallas", dict(none, forward_rows=1, backward_rows=1))
    launches["forward_rows_256"], launches["backward_rows_256"] = counts["forward_rows"], counts["backward_rows"]
    loops["pallas 256"] = (opt_p, steady_ms(chunk_ms))
    # One function, two routes: the same loss and gradients at a seeded
    # random state; at the trained state also against the plain operator in
    # fp64 on the card.  There the u-gradients are at the fp32 roundoff floor
    # of the loss (either route is as far from fp64 as max|g_u|), so the
    # routes are held to each other within that floor where it exceeds
    # GRAD_ATOL * max|g|.
    problem64, state64, _ = vt.build(*SIZES["256"], kernel="xla", dtype=np.float64, device=dev)
    loss64, _ = problem64.make_loss_fn(state64)
    x_rand = [rand(*a.shape) / 3 for a in opt_p.x]
    for name, x in (("a random state", x_rand), ("the trained state", opt_p.x)):
        (l_p, _), g_p = grad_p(x, problem_p.tracers)
        g_p = [a.clone() for a in g_p]
        (l_m, _), g_m = grad_mg(x, problem.tracers)
        x64 = [a.detach().double().requires_grad_(True) for a in x]
        l_64, _ = loss64(x64, problem64.tracers)
        g_64 = torch.autograd.grad(l_64, x64)
        floor = [max(float((a.double() - c).abs().max()), float((b.double() - c).abs().max()))
                 for a, b, c in zip(g_p, g_m, g_64)]
        oks = []
        for a, b, f in zip(g_p, g_m, floor):
            atol = max(GRAD_ATOL * float(b.abs().max()), f if name == "the trained state" else 0.0)
            oks.append(bool(((a - b).abs() <= GRAD_RTOL * b.abs() + atol).all()))
        e = max(float((a - b).abs().max()) for a, b in zip(g_p, g_m))
        print(f"pallas vs pallas_mg at {name}: loss {float(l_p)!r} vs {float(l_m)!r} (fp64 {float(l_64)!r}), "
              f"max|dgrad| {e:.3e}, fp32 floor (max |route - fp64| per array) {max(floor):.3e} {tag}")
        if abs(float(l_p) - float(l_m)) > TERMS_RTOL * abs(float(l_m)) or not all(oks):
            fail(f"the pallas and pallas_mg routes disagree at {name} (gradients ok per array: {oks})")
    del g_p, g_m, g_64, x64, x_rand, problem64, state64, loss64

    # c. pallas at 64^3.
    problem64, state64, _ = vt.build(*SIZES["64"], kernel="pallas", device=dev)
    grad64 = problem64.make_loss_grad_fn(state64)
    counters.zero()
    opt64, losses, chunk_ms = train(torch, Adam, grad64, problem64.domain.arrays_from_state(state64), 350)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses)), "pallas training at 64^3")
    launches["backward_rows_sums_64"] = counters.read()["backward_rows"]
    rows, rel = check_rows(losses, ref64, "training (pallas, 64^3)", gate_all=False, gated=(50,))
    print("  rows after epoch 50 (not gated): " + ", ".join(
        f"{e}: {rows[e]:.6g} vs {ref64[e]:.6g}" for e in sorted(ref64) if e > 50 and e in rows) + f" {tag}")
    counts = loss_only(problem64, state64, opt64.x, grad64, "pallas 64^3",
                       dict(none, forward_rows=1, backward_rows=1))
    launches["forward_rows_64"], launches["backward_rows_64"] = counts["forward_rows"], counts["backward_rows"]
    loops["pallas 64"] = (opt64, steady_ms(chunk_ms))

    # d. 512^2: pallas_mg and pallas, 40 epochs each; epoch 0 against the
    # plain operator's loss on the zero state.
    problem_x, state_x, _ = vt.build(*SIZES["512"], kernel="xla", device=dev)
    loss_x, _ = problem_x.make_loss_fn(state_x)
    with torch.no_grad():
        zero_loss = float(loss_x(problem_x.domain.arrays_from_state(state_x), problem_x.tracers)[0])
    del problem_x, state_x, loss_x
    for route, kernel, epochs in (("pallas_mg 512", "pallas_mg", 40), ("pallas 512", "pallas", 40)):
        problem5, state5, _ = problems["512"] if kernel == "pallas_mg" else vt.build(
            *SIZES["512"], kernel=kernel, device=dev)
        grad5 = problem5.make_loss_grad_fn(state5)
        counters.zero()
        opt5, losses, chunk_ms = train(torch, Adam, grad5, problem5.domain.arrays_from_state(state5), epochs)
        key = "backward_mg" if kernel == "pallas_mg" else "backward_rows"
        expect_counts(counters.read(), dict(none, **{key: len(losses)}), f"{route} training")
        launches["backward_mg_sums_512" if kernel == "pallas_mg" else "backward_rows_sums_512"] = len(losses)
        rel0 = abs(losses[0] - zero_loss) / abs(zero_loss)
        ms, n = steady_ms(chunk_ms)
        print(f"training ({route}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain operator's "
              f"{zero_loss!r} (rel {rel0:.2e}); final {losses[-1]!r}; {ms:.4f} ms/epoch {tag}")
        if rel0 > 1e-5:
            fail(f"{route}: epoch-0 loss {losses[0]} differs from the plain operator's {zero_loss} (limit 1e-5)")
        if kernel == "pallas":
            counts = loss_only(problem5, state5, opt5.x, grad5, route, dict(none, forward_rows=1, backward_rows=1))
            launches["forward_rows_512"], launches["backward_rows_512"] = counts["forward_rows"], counts["backward_rows"]
        loops[route] = (opt5, (ms, n))
        del opt5, grad5, problem5, state5

    # e. heat 64^2: the converged lane from the JAX package's initial net.
    with open(HEAT_DATA) as fh:
        heat_ref = json.load(fh)
    lane = heat_ref["config"]
    problem_h, state_h, extra_h = th.build(
        nt=lane["nt"], nx=lane["nx"], infer_k=lane["infer_k"], imposed=lane["imposed"], nimp=lane["nimp"],
        seed=lane["seed"], kernel="pallas", device=dev,
    )
    net = state_h.fields["k_net"]
    net.weights = [torch.tensor(w, dtype=torch.float32, device=dev) for w in heat_ref["weights"]]
    net.biases = [torch.tensor(b, dtype=torch.float32, device=dev) for b in heat_ref["biases"]]
    grad_h = problem_h.make_loss_grad_fn(state_h)
    if grad_h is None:
        fail("make_loss_grad_fn declined heat kernel='pallas': the one-pass route did not apply")
    history = {}

    def heat_row(epoch, o):
        if epoch % HEAT_EVERY == 0:
            history[epoch] = heat_errors(torch, th, problem_h, extra_h, o.x)

    counters.zero()
    opt_h, losses, chunk_ms = train(torch, Adam, grad_h, problem_h.domain.arrays_from_state(state_h), HEAT_EPOCHS,
                                    lr=1e-3, on_chunk=heat_row)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses)), "heat training at 64^2")
    launches["backward_rows_sums_heat_64"] = counters.read()["backward_rows"]
    rel0 = abs(losses[0] - heat_ref["epoch0_loss"]) / abs(heat_ref["epoch0_loss"])
    rows = {e: (losses[e - 1],) + history[e] for e in sorted(history)}
    with open(os.path.join(PARITY, "ref_heat_seeds.csv")) as fh:
        seeds = list(csv.DictReader(fh))
    medians = {k: statistics.median(float(r[k]) for r in seeds) for k in HEAT_MARGINS}
    last = sorted(rows)[-3:]
    finals = {k: min(rows[e][i] for e in last) for i, k in enumerate(HEAT_MARGINS)}
    print(f"training (heat 64^2, pallas): {len(losses)} epochs, epoch-0 loss {losses[0]!r} (JAX package "
          f"{heat_ref['epoch0_loss']!r}, rel {rel0:.2e}); min of epochs {last}: " + ", ".join(
              f"{k} {finals[k]:.6g} ({finals[k] / medians[k]:.3f}x the seed median {medians[k]:.6g}, limit "
              f"{HEAT_MARGINS[k]}x)" for k in HEAT_MARGINS) + f" {tag}")
    print("  rows (epoch: loss, error_u, error_k; not gated): " + "; ".join(
        f"{e}: {r[0]:.6g}, {r[1]:.6g}, {r[2]:.6g}" for e, r in rows.items()) + f" {tag}")
    if rel0 > 1e-5:
        fail(f"heat 64^2: epoch-0 loss {losses[0]} differs from the JAX package's {heat_ref['epoch0_loss']} "
             f"by {rel0:.2e} (limit 1e-5)")
    for k, margin in HEAT_MARGINS.items():
        if finals[k] > margin * medians[k]:
            fail(f"heat 64^2: final {k} {finals[k]} exceeds {margin} x the reference seeds' median {medians[k]}")
    counts = loss_only(problem_h, state_h, opt_h.x, grad_h, "heat 64^2", dict(none, forward_rows=1, backward_rows=1))
    launches["forward_rows_heat_64"], launches["backward_rows_heat_64"] = counts["forward_rows"], counts["backward_rows"]
    loops["heat 64"] = (opt_h, steady_ms(chunk_ms))

    # f. heat 1024^2, 50 epochs; epoch 0 against the plain operator.  Both
    # builds draw the same initial net (the same seed).
    def zero_state_loss(problem, state):
        loss_fn, _ = problem.make_loss_fn(state)
        with torch.no_grad():
            return float(loss_fn(problem.domain.arrays_from_state(state), problem.tracers)[0])

    big = dict(zip(("nt", "nx"), SIZES_1D["1024"]))
    heat_big = dict(infer_k=True, imposed="stripe", nimp=lane["nimp"], seed=lane["seed"], device=dev, **big)
    plain_loss = zero_state_loss(*th.build(kernel="xla", **heat_big)[:2])
    problem_hb, state_hb, _ = th.build(kernel="pallas", **heat_big)
    grad_hb = problem_hb.make_loss_grad_fn(state_hb)
    counters.zero()
    opt_hb, losses, chunk_ms = train(torch, Adam, grad_hb, problem_hb.domain.arrays_from_state(state_hb), 50, lr=1e-3)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses)), "heat training at 1024^2")
    launches["backward_rows_sums_heat_1024"] = len(losses)
    rel0 = abs(losses[0] - plain_loss) / abs(plain_loss)
    ms, n = steady_ms(chunk_ms)
    print(f"training (heat 1024^2, pallas): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain "
          f"operator's {plain_loss!r} (rel {rel0:.2e}); final {losses[-1]!r}; {ms:.4f} ms/epoch {tag}")
    if rel0 > 1e-5:
        fail(f"heat 1024^2: epoch-0 loss {losses[0]} differs from the plain operator's {plain_loss} (limit 1e-5)")
    counts = loss_only(problem_hb, state_hb, opt_hb.x, grad_hb, "heat 1024^2",
                       dict(none, forward_rows=1, backward_rows=1))
    launches["forward_rows_heat_1024"], launches["backward_rows_heat_1024"] = (
        counts["forward_rows"], counts["backward_rows"])
    loops["heat 1024"] = (opt_hb, (ms, n))
    del opt_hb, grad_hb, problem_hb, state_hb

    # g. wave 64^2 against the plain route trained the same way, then 1024^2.
    wave64 = dict(zip(("nt", "nx"), SIZES_1D["64"]), dtype=np.float32, device=dev)
    problem_w, state_w, _ = tw.build(kernel="pallas", **wave64)
    grad_w = problem_w.make_loss_grad_fn(state_w)
    if grad_w is None:
        fail("make_loss_grad_fn declined wave kernel='pallas': the one-pass route did not apply")
    counters.zero()
    opt_w, losses_w, chunk_ms = train(torch, Adam, grad_w, problem_w.domain.arrays_from_state(state_w), 200, lr=1e-3)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses_w)), "wave training at 64^2")
    launches["backward_rows_sums_wave_64"] = len(losses_w)
    loops["wave 64"] = (opt_w, steady_ms(chunk_ms))
    problem_wx, state_wx, _ = tw.build(kernel="xla", **wave64)
    counters.zero()
    _, losses_x, chunk_ms = train(torch, Adam, autograd_loss_grad_fn(torch, problem_wx, state_wx),
                                  problem_wx.domain.arrays_from_state(state_wx), 200, lr=1e-3)
    expect_counts(counters.read(), none, "wave training at 64^2 on the plain route")
    loops["wave 64 plain route"] = (None, steady_ms(chunk_ms))
    rel = {e: abs(losses_w[max(e - 1, 0)] - losses_x[max(e - 1, 0)]) / abs(losses_x[max(e - 1, 0)])
           for e in range(0, len(losses_w) + 1, 20)}
    worst = max(rel, key=rel.get)
    print(f"training (wave 64^2, pallas vs the plain route): epoch-0 loss {losses_w[0]!r} vs {losses_x[0]!r} "
          f"(rel {rel[0]:.2e}); worst 20-epoch row epoch {worst} ({100 * rel[worst]:.4f}%); final "
          f"{losses_w[-1]!r} vs {losses_x[-1]!r} {tag}")
    if rel[0] > 1e-5 or rel[worst] > 0.01:
        fail(f"wave 64^2: the kernel route leaves the plain route (epoch 0 rel {rel[0]:.2e}, limit 1e-5; "
             f"epoch {worst} {100 * rel[worst]:.3f}%, limit 1%)")
    counts = loss_only(problem_w, state_w, opt_w.x, grad_w, "wave 64^2", dict(none, forward_rows=1, backward_rows=1))
    launches["forward_rows_wave_64"], launches["backward_rows_wave_64"] = counts["forward_rows"], counts["backward_rows"]

    wave_big = dict(big, dtype=np.float32, device=dev)
    plain_loss = zero_state_loss(*tw.build(kernel="xla", **wave_big)[:2])
    problem_wb, state_wb, _ = tw.build(kernel="pallas", **wave_big)
    grad_wb = problem_wb.make_loss_grad_fn(state_wb)
    counters.zero()
    opt_wb, losses, chunk_ms = train(torch, Adam, grad_wb, problem_wb.domain.arrays_from_state(state_wb), 40, lr=1e-3)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses)), "wave training at 1024^2")
    launches["backward_rows_sums_wave_1024"] = len(losses)
    rel0 = abs(losses[0] - plain_loss) / abs(plain_loss)
    ms, n = steady_ms(chunk_ms)
    print(f"training (wave 1024^2, pallas): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain "
          f"operator's {plain_loss!r} (rel {rel0:.2e}); final {losses[-1]!r}; {ms:.4f} ms/epoch {tag}")
    if rel0 > 1e-5:
        fail(f"wave 1024^2: epoch-0 loss {losses[0]} differs from the plain operator's {plain_loss} (limit 1e-5)")
    counts = loss_only(problem_wb, state_wb, opt_wb.x, grad_wb, "wave 1024^2",
                       dict(none, forward_rows=1, backward_rows=1))
    launches["forward_rows_wave_1024"], launches["backward_rows_wave_1024"] = (
        counts["forward_rows"], counts["backward_rows"])
    loops["wave 1024"] = (opt_wb, (ms, n))
    del opt_wb, grad_wb, problem_wb, state_wb

    idle = [name for name in report if launches.get(name, 0) < 1]
    if idle:
        fail(f"kernels not launched on their paths: {idle}")

    # -- Phase 4: timing -------------------------------------------------------
    for route, (o, (ms, n)) in loops.items():
        print(f"training loop ({route}): {ms:.4f} ms/epoch (median of {n} chunks of {CHUNK} epochs "
              f"after the first) {tag}")
    for route in ("pallas_mg 256", "pallas 256", "heat 64"):
        o, (ms, _) = loops[route]
        profile_epochs(torch, o, ms, f"({route}) {tag}")

    nbytes = lambda ts: 4 * sum(t.numel() for t in ts)
    mg_in, mg_out = nbytes(t0s + coarse + consts), nbytes(t0s + coarse)
    mg512_in, mg512_out = nbytes(t0s512 + coarse512 + consts512), nbytes(t0s512 + coarse512)
    mg_src, rows_src = "odil_torch/csrc/rowwise_mg.cu", "odil_torch/csrc/rowwise.cu"
    timed = {
        "backward_mg_sums": (
            lambda: rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, True),
            lambda: rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, True),
            mg_in + mg_out + 8 * nterms, OPS_BACKWARD * cells, "odil_tpu/ops/rowwise_mg.py:766", mg_src,
        ),
        "backward_mg": (
            lambda: rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, False),
            lambda: rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, False),
            mg_in + mg_out + 4 * nterms, OPS_BACKWARD * cells, "odil_tpu/ops/rowwise_mg.py:766", mg_src,
        ),
        "forward_mg": (
            lambda: rmg.forward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts),
            lambda: rmg._forward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts),
            mg_in + 4 * nterms, OPS_FORWARD * cells, "odil_tpu/ops/rowwise_mg.py:336", mg_src,
        ),
        "backward_mg_sums_512": (
            lambda: rmg.backward_mg_cuda(model512, nterms512, 1, f0s, t0s512, coarse512, consts512, g512, True),
            lambda: rmg._backward_mg_plain(model512, nterms512, 1, f0s, t0s512, coarse512, consts512, g512, True),
            mg512_in + mg512_out + 8 * nterms512, OPS_BACKWARD * cells512, "odil_tpu/ops/rowwise_mg_tiled.py:490",
            mg_src,
        ),
    }
    replaces = {
        "256": ("odil_tpu/ops/rowwise.py:174", "odil_tpu/ops/rowwise.py:292"),
        "64": ("odil_tpu/ops/rowwise.py:385", "odil_tpu/ops/rowwise.py:549"),
        "512": ("odil_tpu/ops/rowwise_tiled.py:272", "odil_tpu/ops/rowwise_tiled.py:447"),
    }
    for size, fs in fields.items():
        m, nt_, cs = row_model(size)
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        n_cells, f_in = fs[0].numel(), nbytes(fs + cs)
        timed[f"forward_rows_{size}"] = (
            lambda m=m, nt_=nt_, fs=fs, cs=cs: rw.forward_cuda(m, nt_, 1, fs, (), (), cs),
            lambda m=m, nt_=nt_, fs=fs, cs=cs: rw._forward_plain(m, nt_, 1, fs, (), (), cs),
            f_in + 4 * nt_, OPS_ROWS_FORWARD * n_cells, replaces[size][0], rows_src,
        )
        for sums, name in ((True, f"backward_rows_sums_{size}"), (False, f"backward_rows_{size}")):
            timed[name] = (
                lambda m=m, nt_=nt_, fs=fs, cs=cs, gs=gs, s=sums: rw.backward_cuda(m, nt_, 1, fs, (), (), cs, gs, s),
                lambda m=m, nt_=nt_, fs=fs, cs=cs, gs=gs, s=sums: rw._backward_plain(
                    m, nt_, 1, fs, (), (), cs, gs, s),
                f_in + nbytes(fs) + 4 * nt_ * (2 if sums else 1), OPS_ROWS_BACKWARD * n_cells, replaces[size][1],
                rows_src,
            )
    ops_1d = {"heat": (OPS_HEAT_FORWARD, OPS_HEAT_BACKWARD), "wave": (OPS_WAVE_FORWARD, OPS_WAVE_BACKWARD)}
    for (which, size), (m, nt_, h, fs, ps, ds, cs) in cases_1d.items():
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        n_cells, f_in = fs[0].numel(), nbytes(fs + ps + ds + cs)
        ops_f, ops_b = ops_1d[which]
        timed[f"forward_rows_{which}_{size}"] = (
            lambda m=m, nt_=nt_, h=h, fs=fs, ps=ps, ds=ds, cs=cs: rw.forward_cuda(m, nt_, h, fs, ps, ds, cs),
            lambda m=m, nt_=nt_, h=h, fs=fs, ps=ps, ds=ds, cs=cs: rw._forward_plain(m, nt_, h, fs, ps, ds, cs),
            f_in + 4 * nt_, ops_f * n_cells, "odil_tpu/ops/rowwise.py:385", rows_src,
        )
        for sums, name in ((True, f"backward_rows_sums_{which}_{size}"), (False, f"backward_rows_{which}_{size}")):
            timed[name] = (
                lambda m=m, nt_=nt_, h=h, fs=fs, ps=ps, ds=ds, cs=cs, gs=gs, s=sums: rw.backward_cuda(
                    m, nt_, h, fs, ps, ds, cs, gs, s),
                lambda m=m, nt_=nt_, h=h, fs=fs, ps=ps, ds=ds, cs=cs, gs=gs, s=sums: rw._backward_plain(
                    m, nt_, h, fs, ps, ds, cs, gs, s),
                f_in + nbytes(fs + ps) + 4 * nt_ * (2 if sums else 1), ops_b * n_cells, "odil_tpu/ops/rowwise.py:549",
                rows_src,
            )
    kernels = []
    for name, (kfn, pfn, nbyte, ops, replaced, source) in timed.items():
        ms = kernel_ms(torch, kfn, 50)
        plain_ms = time_ms(torch, pfn, 3)
        t_bytes = nbyte / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"kernel {name}: {ms:.4f} ms, bound {bound_ms:.4g} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"{launches[name]} launches on its path {tag}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaced,
            "launches": launches[name], "max_abs_err": report[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
