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
4. Timing: ms/epoch of the training loops with a profiler breakdown of the
   two 256^2 routes, and each kernel's time (a CUDA graph of 50 calls) beside
   its bound, its plain version's time and its launches on its path, every
   line tagged with the card's name and power limit.

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
DEVICE = "cuda"
# The grids in cells: the flagship (the whole-plane TPU kernels), 64^3 (the
# blocked ones) and 512^2 (the x-tiled ones).
SIZES = {"256": (64, 256, 256), "64": (64, 64, 64), "512": (64, 512, 512)}
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


def train(torch, Adam, grad_fn, arrays, epochs):
    """Adam (lr 0.01) for `epochs` epochs in chunks of CHUNK: (optimizer,
    losses, host ms/epoch of each chunk)."""
    opt = Adam(grad_fn, arrays, lr=0.01)
    losses, chunk_ms = [], []
    torch.cuda.synchronize()
    for _ in range(epochs // CHUNK):
        t_start = time.perf_counter()
        out = opt.run_chunk(CHUNK)
        losses += out.cpu().tolist()  # waits for the card once per chunk
        chunk_ms.append((time.perf_counter() - t_start) * 1e3 / CHUNK)
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
    from odil_torch.models import veltracer as vt
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
        f"{e}: {rows[e]:.6g} vs {ref64[e]:.6g}" for e in sorted(ref64) if e > 50 and e in rows))
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

    idle = [name for name in report if launches.get(name, 0) < 1]
    if idle:
        fail(f"kernels not launched on their paths: {idle}")

    # -- Phase 4: timing -------------------------------------------------------
    for route, (o, (ms, n)) in loops.items():
        print(f"training loop ({route}): {ms:.4f} ms/epoch (median of {n} chunks of {CHUNK} epochs "
              f"after the first) {tag}")
    for route in ("pallas_mg 256", "pallas 256"):
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
    kernels = []
    for name, (kfn, pfn, nbyte, ops, replaced, source) in timed.items():
        ms = kernel_ms(torch, kfn, 50)
        plain_ms = time_ms(torch, pfn, 3)
        t_bytes = nbyte / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"kernel {name}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
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
