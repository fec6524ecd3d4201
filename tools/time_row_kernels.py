#!/usr/bin/env python3
"""Times the port's row kernels (``odil_torch/csrc/rowwise.cu``) of the tree
at the current directory on the card: heat and wave at 64^2 and 1024^2
(the converged lane's configuration), veltracer at (65,256,256) and
(65,64,64) and the masked per-shard kernel at one t:2,x:2 shard of the
flagship, (34,130,256); backward with and without the sums, forward,
streaming backward (none for the shard); each a CUDA graph of 50 calls
(``chip_smoke.kernel_ms``), with the launch shape where the tree has one
and ptxas's register report; then the host's microseconds a call of the
backward+sums wrapper (300 calls, the enqueue alone) and the ms/epoch of
three 200-epoch chunks of the heat 64^2 and the ``pallas`` 64^3 training
loops (host clock, a sync after each chunk).

``phases`` in the list times the veltracer row kernel's phases instead, at
its three shapes: copies of the tree's sources under
``build/phases/`` in which the row walk keeps its staging only (1), then
the ring-1 staging (2), then the cell terms with their stores cut (3); the
tree's own backward (4: + the stores) and backward+sums (5: + the sums)
complete the breakdown.  The cuts are text edits of the statements that
every version of the kernel has (``PHASE_EDITS``), so the same cuts time
another tree's kernel.

Run from the root of a tree (the repository, or a copy of it under the
git-ignored ``build/`` with one change, to compare the two in one call):

    python3 tools/time_row_kernels.py TAG [heat,wave,vt,phases]
"""

import concurrent.futures
import ctypes
import importlib.util
import os
import re
import shutil
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


# The phase cuts of rows_kernel: the ring-1 staging from phase 2, the cell
# terms from phase 3 (their stores kept live by a test no value passes), the
# stores from phase 4.  Before phase 3 each thread reads a cell of every
# staged plane and ring-1 array (a sink behind the same test), so that the
# compiler keeps the stores into them, and the loads that feed the stores.
_SINK = ("if (ODIL_PHASE < 3) { const int si = threadIdx.y + 2, sj = threadIdx.x + 2; const float q = P.Um[si][sj] + "
         "P.Uc[si][sj] + P.Un[si][sj] + P.VXm[si][sj] + P.VXc[si][sj] + P.VXn[si][sj] + P.VYm[si][sj] + "
         "P.VYc[si][sj] + P.VYn[si][sj] + P.U0[si][sj] + \\2.B0n[si][sj] + \\2.CXn[si][sj] + \\2.CYn[si][sj] + "
         "\\2.LXc[si][sj] + \\2.LYc[si][sj]; if (q == 1234.5f) A.df[0][0] = q; }")
PHASE_EDITS = (
    (r"if \(grads\) (stage_ring1(?:_rows)?)\(A, P, it1 \+ off, g2, ([\w.]+), H\);",
     r"if (grads && ODIL_PHASE >= 2) \1(A, P, it1 + off, g2, \2, H); " + _SINK),
    (r"(\n\s*)cell_terms<grads, sums>\(", r"\1if (ODIL_PHASE >= 3) cell_terms<grads, sums>("),
    (r"A\.df\[f\]\[cell\] = (d(?:\[c\])?\[f\]);",
     r"if (ODIL_PHASE >= 4 || (ODIL_PHASE == 3 && \1 == 1234.5f)) A.df[f][cell] = \1;"),
)
PHASES = {1: "staging", 2: "+ ring-1", 3: "+ cell terms", 4: "+ stores", 5: "+ sums"}


def phase_libraries():
    """{phase: ctypes handle} of the phase-cut copies 1-3 of this tree's
    rowwise.cu, built together (one nvcc each) under build/phases/."""
    src = os.path.join(os.getcwd(), "odil_torch")
    paths = {}
    for phase in (1, 2, 3):
        root = os.path.join(os.getcwd(), "build", "phases", f"p{phase}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(src, os.path.join(root, "odil_torch"), ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(root, "odil_torch", "csrc", "rowwise.cu")
        with open(cu) as fh:
            text = fh.read()
        for pattern, repl in PHASE_EDITS:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                cs.fail(f"phase cut {pattern!r} matched {n} statements of {cu}")
        with open(cu, "w") as fh:
            fh.write(f"#define ODIL_PHASE {phase}\n" + text)
        spec = importlib.util.spec_from_file_location(f"phase_build_{phase}", os.path.join(root, "odil_torch", "ops",
                                                                                         "_build.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        paths[phase] = mod
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as ex:
        built = dict(zip(paths, ex.map(lambda m: m.compile_source("rowwise")[0], paths.values())))
    return {phase: ctypes.CDLL(path) for phase, path in built.items()}


def vt_cases(dev, rand):
    """(name, row case, masked) of the veltracer row kernel: the flagship
    plane, 64^3 and one t:2,x:2 shard of the flagship (the first: row
    offset -1, own rows 1..33, the halo columns masked)."""
    out = []
    for size in ((64, 256, 256), (64, 64, 64)):
        p, st, e = vt.build(*size, kernel="pallas", device=dev)
        m, nt_ = vt._row_model(Context(p.domain, st, extra=e))
        fs = tuple(rand(size[0] + 1, size[1], size[2]) for _ in range(3))
        out.append((f"veltracer {size}", (m, nt_, 1, fs, (), (), (e.u_init, e.u_final)), False))
        if size[1] == 256:
            nt, nx, ny = size
            mask = torch.ones((nx // 2 + 2, ny), device=dev)
            mask[0] = 0
            mask[-1] = 0
            hm = trw.halo_model(m, mask, -1, nt + 1, 1, nt // 2 + 2)
            hfs = tuple(rand(nt // 2 + 2, nx // 2 + 2, ny) for _ in range(3))
            hcs = tuple(torch.nn.functional.pad(c[: nx // 2], (0, 0, 1, 1)) for c in (e.u_init, e.u_final))
            out.append((f"veltracer shard {tuple(hfs[0].shape)}", (hm, nt_, 1, hfs, (), (), hcs), True))
    return out


def time_phases(tag, dev, rand, card):
    """The phase breakdown of the veltracer row kernel (see the docstring)."""
    libs = phase_libraries()
    load = _build.load
    for what, (m, nt_, h, fs, ps, ds, cs_), masked in vt_cases(dev, rand):
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        backward = trw.backward_halo_cuda if masked else trw.backward_cuda
        args = (m, nt_, h, fs, ps, ds, cs_, gs)
        times = {}
        for phase, lib in libs.items():
            _build.load = lambda name, lib=lib: lib if name == "rowwise" else load(name)
            try:
                times[phase] = cs.kernel_ms(torch, lambda: backward(*args, False), 50)
            finally:
                _build.load = load
        times[4] = cs.kernel_ms(torch, lambda: backward(*args, False), 50)
        times[5] = cs.kernel_ms(torch, lambda: backward(*args, True), 50)
        print(f"{tag} phases of {what}: " + "; ".join(f"{p} {PHASES[p]} {t:.4f}" for p, t in times.items())
              + f" ms [{card}]")


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
        cases += [(what, case) for what, case, _ in vt_cases(dev, rand)]
    for what, (m, nt_, h, fs, ps, ds, cs_) in cases:
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        args = (m, nt_, h, fs, ps, ds, cs_)
        masked = getattr(m, "halo", None) is not None
        backward = trw.backward_halo_cuda if masked else trw.backward_cuda
        forward = trw.forward_halo_cuda if masked else trw.forward_cuda
        calls = [lambda: backward(*args, gs, True), lambda: backward(*args, gs, False), lambda: forward(*args)]
        if not masked:
            calls.append(lambda: trw.backward_stream_cuda(*args, gs, False))
        t = [cs.kernel_ms(torch, f, 50) for f in calls] + [float("nan")] * (4 - len(calls))
        launch = shape(m, fs, True, True) if shape else None
        us = host_us(lambda: backward(*args, gs, True))
        print(f"{tag} {what}: backward+sums {t[0]:.4f} backward {t[1]:.4f} forward {t[2]:.4f} streaming backward "
              f"{t[3]:.4f} ms; launch (slab, tiles, blocks, resident) {launch}; host {us:.1f} us a backward+sums call "
              f"[{card}]")
    print(f"{tag} registers: " + " | ".join(regs))
    if "phases" in which:
        time_phases(tag, dev, rand, card)
    if not {"heat", "vt"} & set(which):
        return
    lane = dict(nt=64, nx=64, infer_k=True, imposed="stripe", nimp=200, seed=1000, kernel="pallas", device=dev)
    heat = epoch_ms(*th.build(**lane)[:2], 1e-3)
    velt = epoch_ms(*vt.build(64, 64, 64, kernel="pallas", device=dev)[:2], 1e-2)
    print(f"{tag} ms/epoch: heat 64^2 " + ", ".join(f"{v:.4f}" for v in heat) + "; pallas 64^3 " + ", ".join(
        f"{v:.4f}" for v in velt) + f" [{card}]")


if __name__ == "__main__":
    main()
