#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py            # the full check (400 training epochs)
    python3 chip_smoke.py --epochs 40   # a shorter training phase

Phases, any failure exits non-zero and prints no result:

1. Build: the CUDA kernels of ``odil_torch/csrc/`` compile with nvcc for
   sm_90a into ``build/odil_torch/``.
2. Kernels vs their plain PyTorch versions at the flagship shapes -- t0
   (65,256,256) x3 fields, P (33,128,128) x3, seeded random values and the
   real tracer planes: backward+sums (terms rtol 1e-5; dt0, dP rtol 1e-4 with
   atol 1e-6 * max|ref|), forward sums (rtol 1e-5), and the gradient of the
   loss-only path (forward kernel + autograd) against autograd of the plain
   forward.
3. Training: velocity_from_tracer at (64,256,256), multigrid, fused loss+grad,
   Adam lr=0.01 with fp32 slots, against the reference trajectory
   ``docs/parity_data/ref_velt_256.csv`` (epoch 0 within 1e-5, every row
   within 15%).  The launch counters are zeroed before it and must show the
   backward kernel on every epoch.  Then the loss-only evaluation path
   (forward kernel + autograd) runs once with the counters zeroed again.
4. Timing: ms/epoch of the training loop and each kernel's time beside its
   bound and its plain version's time, every line tagged with the card's
   name and power limit.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import csv
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_CSV = os.path.join(HERE, "docs", "parity_data", "ref_velt_256.csv")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
# fp32 operations per fine cell of the function, all three fields, counted
# from the formulas: the rebuild of a fine value (blend of 4 coarse taps,
# two 2-tap contractions, f0*t0 + up: 23 per field), the six residual
# terms (40), their adjoint (60) and the transposed prolongation (12).
OPS_FORWARD = 3 * 23 + 40
OPS_BACKWARD = OPS_FORWARD + 60 + 12
DEVICE = "cuda"
NT, NX, NY = 64, 256, 256  # the flagship grid in cells


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=400, help="Training epochs (multiple of 10)")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the random kernel inputs")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs only on the card")
    if not os.path.isdir(os.path.join(HERE, "odil_torch")):
        fail(f"no odil_torch package beside {__file__}: run from a checkout of the repository")
    sys.path.insert(0, HERE)

    from odil_torch.context import Context
    from odil_torch.models import veltracer as vt
    from odil_torch.ops import _build
    from odil_torch.ops import rowwise_mg as rmg
    from odil_torch.optim import Adam

    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}")

    # -- Phase 1: build --------------------------------------------------------
    path, seconds, log = _build.compile_source("rowwise_mg")
    print(f"build: {os.path.relpath(path, HERE)} in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    rmg._library()

    # -- Phase 2: kernels vs plain versions at the flagship shapes --------------
    dev = torch.device(DEVICE)
    problem, state, extra = vt.build(nt=NT, nx=NX, ny=NY, kernel="pallas_mg", device=dev)
    ctx = Context(problem.domain, state, extra=extra)
    model, nterms = vt._row_model(ctx)
    consts = (extra.u_init, extra.u_final)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    T, X, Y, Tc = NT + 1, NX, NY, NT // 2 + 1
    t0s = tuple(0.3 * torch.randn((T, X, Y), generator=gen, device=dev) for _ in range(3))
    coarse = tuple(0.3 * torch.randn((Tc, X // 2, Y // 2), generator=gen, device=dev) for _ in range(3))
    t0s, coarse, f0s, cells = rmg._prepare_mg(t0s, coarse, (1.0, 1.0, 1.0), 1)
    Wx, Wy = rmg._interp_matrices(X // 2, Y // 2, torch.float32, dev)
    g = torch.full((nterms,), 1.0 / cells, device=dev)
    report = {}

    kd0, kP, ksums = rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, True)
    pd0, pP, psums = rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, True)
    torch.cuda.synchronize()
    e_s, ok_s = close(ksums.double() / cells, psums.double() / cells, 1e-5, 0.0)
    errs = [close(a, b, 1e-4, 1e-6) for a, b in zip(kd0 + kP, pd0 + pP)]
    print(f"backward+sums: max|d terms| {e_s:.3e} (max rel {rel_err(ksums, psums):.2e}), "
          f"max|d(dt0,dP)| {max(e for e, _ in errs):.3e} {tag}")
    if not (ok_s and all(ok for _, ok in errs)):
        fail(f"backward+sums kernel disagrees with its plain version (sums ok={ok_s}, grads {errs})")
    report["backward_mg_sums"] = max(e for e, _ in errs)

    fsums = rmg.forward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts)
    pf = rmg._forward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts)
    torch.cuda.synchronize()
    e_f, ok_f = close(fsums.double() / cells, pf.double() / cells, 1e-5, 0.0)
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
        it = torch.arange(T, device=dev).view(T, 1, 1)
        res = model.row_fn(it, T, rmg._row_stacks(fines, 1), (), (), consts)
        loss_p = sum(torch.sum(r * r) / cells for r in res)
    grads_p = torch.autograd.grad(loss_p, leaves_p)
    torch.cuda.synchronize()
    errs = [close(a, b, 1e-4, 1e-6) for a, b in zip(grads_k, grads_p)]
    e_l, ok_l = close(torch.stack(terms_k).sum().double(), loss_p.double(), 1e-5, 0.0)
    print(f"loss-only path: max|dloss| {e_l:.3e}, max|dgrad| {max(e for e, _ in errs):.3e} {tag}")
    if not (ok_l and all(ok for _, ok in errs)):
        fail(f"forward kernel + autograd disagrees with plain autograd (loss ok={ok_l}, grads {errs})")
    report["backward_mg"] = max(e for e, _ in errs)
    del leaves_k, leaves_p, grads_k, grads_p, fines, res

    # -- Phase 3: end-to-end training -----------------------------------------
    with open(REF_CSV) as fh:
        ref = {int(r["epoch"]): float(r["loss"]) for r in csv.DictReader(fh)}
    grad_fn = problem.make_loss_grad_fn(state)
    if grad_fn is None:
        fail("make_loss_grad_fn declined the flagship: the fused route did not apply")
    arrays = problem.domain.arrays_from_state(state)
    opt = Adam(grad_fn, arrays, lr=0.01)
    rmg.backward_mg_cuda.launches = 0
    rmg.forward_mg_cuda.launches = 0
    chunk = 10
    losses, chunk_ms = [], []
    torch.cuda.synchronize()
    for _ in range(args.epochs // chunk):
        t_start = time.perf_counter()
        out = opt.run_chunk(chunk)
        losses += out.cpu().tolist()  # waits for the card once per chunk
        chunk_ms.append((time.perf_counter() - t_start) * 1e3 / chunk)
    train_launches = {"backward_mg_sums": rmg.backward_mg_cuda.launches}
    if rmg.backward_mg_cuda.launches != len(losses) or rmg.forward_mg_cuda.launches != 0:
        fail(
            f"training ran {len(losses)} epochs but the counters read backward "
            f"{rmg.backward_mg_cuda.launches}, forward {rmg.forward_mg_cuda.launches}"
        )
    rows = {0: losses[0]}
    rows.update({e: losses[e - 1] for e in range(chunk, len(losses) + 1, chunk)})
    rel = {e: abs(rows[e] - ref[e]) / abs(ref[e]) for e in rows}
    worst = max(rel, key=rel.get)
    print(f"training: {len(losses)} epochs, epoch-0 loss {rows[0]!r} (reference {ref[0]!r}, "
          f"rel {rel[0]:.2e}); worst row epoch {worst}: {rows[worst]!r} vs {ref[worst]!r} "
          f"({100 * rel[worst]:.2f}%); final {rows[max(rows)]!r} {tag}")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        fail("non-finite training loss")
    if rel[0] > 1e-5:
        fail(f"epoch-0 loss {rows[0]} differs from the reference {ref[0]} by {rel[0]:.2e} (limit 1e-5)")
    if rel[worst] > 0.15:
        fail(f"epoch {worst}: loss {rows[worst]} is {100 * rel[worst]:.1f}% from the reference (limit 15%)")

    # The loss-only evaluation path: forward kernel, autograd -> backward kernel.
    loss_fn, _ = problem.make_loss_fn(state)
    x = [a.detach().clone().requires_grad_(True) for a in opt.x]
    rmg.backward_mg_cuda.launches = 0
    rmg.forward_mg_cuda.launches = 0
    loss_e, _ = loss_fn(x, problem.tracers)
    grads_e = torch.autograd.grad(loss_e, x)
    loss_e = loss_e.detach()
    torch.cuda.synchronize()
    eval_launches = {"forward_mg": rmg.forward_mg_cuda.launches, "backward_mg": rmg.backward_mg_cuda.launches}
    if eval_launches != {"forward_mg": 1, "backward_mg": 1}:
        fail(f"the loss-only path did not run each kernel once: {eval_launches}")
    (loss_t, _), grads_t = grad_fn(opt.x, problem.tracers)
    e_eval = max(close(a, b, 1e-4, 1e-6)[0] for a, b in zip(grads_e, grads_t))
    ok_eval = all(close(a, b, 1e-4, 1e-6)[1] for a, b in zip(grads_e, grads_t))
    print(f"loss-only vs fused route at the trained state: loss {float(loss_e)!r} vs {float(loss_t)!r}, "
          f"max|dgrad| {e_eval:.3e} {tag}")
    if abs(float(loss_e) - float(loss_t)) > 1e-5 * abs(float(loss_t)) or not ok_eval:
        fail("the loss-only path and the fused training route disagree")

    # -- Phase 4: timing -------------------------------------------------------
    steady = chunk_ms[1:] if len(chunk_ms) > 3 else chunk_ms
    epoch_ms = statistics.median(steady)
    print(f"training loop: {epoch_ms:.4f} ms/epoch (median of {len(steady)} chunks of "
          f"{chunk} epochs after the first) {tag}")
    profile_epochs(torch, opt, epoch_ms, tag)
    nbytes = lambda ts: 4 * sum(t.numel() for t in ts)
    in_bytes = nbytes(t0s + coarse + consts)
    out_bytes = nbytes(t0s + coarse)
    timed = {
        "backward_mg_sums": (
            lambda: rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, True),
            lambda: rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, True),
            in_bytes + out_bytes + 8 * nterms, OPS_BACKWARD, "odil_tpu/ops/rowwise_mg.py:766",
            train_launches["backward_mg_sums"],
        ),
        "backward_mg": (
            lambda: rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, False),
            lambda: rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, False),
            in_bytes + out_bytes + 4 * nterms, OPS_BACKWARD, "odil_tpu/ops/rowwise_mg.py:766",
            eval_launches["backward_mg"],
        ),
        "forward_mg": (
            lambda: rmg.forward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts),
            lambda: rmg._forward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts),
            in_bytes + 4 * nterms, OPS_FORWARD, "odil_tpu/ops/rowwise_mg.py:336",
            eval_launches["forward_mg"],
        ),
    }
    kernels = []
    for name, (kfn, pfn, nbyte, ops, replaces, launches) in timed.items():
        ms = time_ms(torch, kfn, 50)
        plain_ms = time_ms(torch, pfn, 3)
        t_bytes = nbyte / HBM_BYTES_PER_S * 1e3
        t_ops = ops * cells / FP32_FLOPS * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        print(f"kernel {name}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"{launches} launches on its path {tag}")
        kernels.append({
            "name": name, "route": "cuda", "source": "odil_torch/csrc/rowwise_mg.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": report[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
