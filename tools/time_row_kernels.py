#!/usr/bin/env python3
"""Times the port's row kernels (``odil_torch/csrc/rowwise.cu``) of the tree
at the current directory on the card: heat and wave at 64^2 and 1024^2
(the converged lane's configuration), veltracer at (65,256,256) and
(65,64,64); backward with and without the sums, forward, streaming backward;
each a CUDA graph of 50 calls (``chip_smoke.kernel_ms``), with the launch
shape where the tree has one and ptxas's register report; then the host's
microseconds a call of the backward+sums wrapper (300 calls, the enqueue
alone) and the ms/epoch of three 200-epoch chunks of the heat 64^2 and the
``pallas`` 64^3 training loops (host clock, a sync after each chunk).

Run from the root of a tree (the repository, or a copy of it under the
git-ignored ``build/`` with one change, to compare the two in one call):

    python3 tools/time_row_kernels.py TAG [heat,wave,vt]
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from odil_torch.context import Context  # noqa: E402
from odil_torch.models import heat as th  # noqa: E402
from odil_torch.models import veltracer as vt  # noqa: E402
from odil_torch.models import wave as tw  # noqa: E402
from odil_torch.ops import _build  # noqa: E402
from odil_torch.ops import rowwise as trw  # noqa: E402
from odil_torch.optim import Adam  # noqa: E402


def host_us(fn, n=300):
    """Host microseconds a call of fn, enqueue alone (after a warm-up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - start) / n * 1e6
    torch.cuda.synchronize()
    return us


def epoch_ms(problem, state, lr, chunks=3, epochs=200):
    """ms/epoch of `chunks` chunks of the one-pass training loop."""
    opt = Adam(problem.make_loss_grad_fn(state), problem.domain.arrays_from_state(state), lr=lr)
    opt.run_chunk(20)
    torch.cuda.synchronize()
    out = []
    for _ in range(chunks):
        start = time.perf_counter()
        opt.run_chunk(epochs)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - start) / epochs * 1e3)
    return out


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    which = sys.argv[2].split(",") if len(sys.argv) > 2 else ["heat", "wave", "vt"]
    if not torch.cuda.is_available():
        cs.fail("no card: the kernels run only on the card")
    _, _, log = _build.compile_source("rowwise")
    regs, name = [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
        elif "Used" in line and name and ("rows1d" in name or "rows_kernel" in name):
            regs.append(f"{name[:60]}: {line.split(':', 1)[1].strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    shape = getattr(trw, "launch_shape", None)
    card = cs.card_line()
    cases = []
    for model in ("heat", "wave"):
        if model in which:
            for size in ((64, 64), (1024, 1024)):
                cases.append((f"{model} {size}", cs.row_case_1d(torch, np, th, tw, Context, model, *size, rand, dev)))
    if "vt" in which:
        for size in ((64, 256, 256), (64, 64, 64)):
            p, st, e = vt.build(*size, kernel="pallas", device=dev)
            m, nt_ = vt._row_model(Context(p.domain, st, extra=e))
            fs = tuple(rand(size[0] + 1, size[1], size[2]) for _ in range(3))
            cases.append((f"veltracer {size}", (m, nt_, 1, fs, (), (), (e.u_init, e.u_final))))
    for what, (m, nt_, h, fs, ps, ds, cs_) in cases:
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        args = (m, nt_, h, fs, ps, ds, cs_)
        t = [cs.kernel_ms(torch, f, 50) for f in (
            lambda: trw.backward_cuda(*args, gs, True), lambda: trw.backward_cuda(*args, gs, False),
            lambda: trw.forward_cuda(*args), lambda: trw.backward_stream_cuda(*args, gs, False))]
        launch = shape(m, fs, True, True) if shape else None
        us = host_us(lambda: trw.backward_cuda(*args, gs, True))
        print(f"{tag} {what}: backward+sums {t[0]:.4f} backward {t[1]:.4f} forward {t[2]:.4f} streaming backward "
              f"{t[3]:.4f} ms; launch (slab, tiles, blocks, resident) {launch}; host {us:.1f} us a backward+sums call "
              f"[{card}]")
    print(f"{tag} registers: " + " | ".join(regs))
    lane = dict(nt=64, nx=64, infer_k=True, imposed="stripe", nimp=200, seed=1000, kernel="pallas", device=dev)
    heat = epoch_ms(*th.build(**lane)[:2], 1e-3)
    velt = epoch_ms(*vt.build(64, 64, 64, kernel="pallas", device=dev)[:2], 1e-2)
    print(f"{tag} ms/epoch: heat 64^2 " + ", ".join(f"{v:.4f}" for v in heat) + "; pallas 64^3 " + ", ".join(
        f"{v:.4f}" for v in velt) + f" [{card}]")


if __name__ == "__main__":
    main()
