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

The heat row kernels of the wide conductivity nets (more than 48 params:
``csrc/heat_net.cu`` with ``csrc/heat_wide.cuh``), at ``WIDE_CASES`` or the
cases named after the list:

- ``wide``: each kernel held to its fp64 plain version with
  ``chip_smoke.py``'s gates, then timed; with its launch shape;
- ``widephases``: the backward+sums at 1024^2 and 64^2 of copies under
  ``build/wide_phases/`` in which the tile loop keeps its staging only (1),
  then the faces (2), then the cell terms (3), then the gather and the
  param cotangents (4); the tree's own kernel (5: + the last block's param
  sums) completes it (``WIDE_PHASE_EDITS``: statements of the kernel before
  and after its wide-net redesign, so the same cuts time the parent);
- ``ablations``: the [1, 16, 16, 16, 1] kernels at 1024^2 and the
  [1, 32, 32, 1] ones at 64^2 beside copies (``ABLATIONS``) with ``tanhf``
  for ``tanh_fast``, and with the param phase's forward rerun replaced by
  stores of its records (the best that keeping the face phase's activations
  could do), in turns;
- ``tanh``: ``tanh_fast`` and ``tanhf`` on the card against fp64 tanh over
  every scale of input, worst absolute and relative errors by band of |x|.

Run from the root of a tree (the repository, or a copy of it under the
git-ignored ``build/`` with one change, to compare the two in one call; by
path, so that another tree is timed the same way):

    python3 tools/time_row_kernels.py TAG [heat,wave,vt,phases,wide,widephases,ablations,tanh] [CASE,...]
"""

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
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


def edited_trees(subdir, source, variants):
    """{key: the _build module of a copy of this tree's odil_torch under
    build/<subdir>/<key>/}, the copy's csrc/<source> with the edits of
    variants[key] = (top line, ((pattern, replacement), ...)), each pattern
    matching one statement."""
    src = os.path.join(os.getcwd(), "odil_torch")
    mods = {}
    for key, (top, edits) in variants.items():
        root = os.path.join(os.getcwd(), "build", subdir, str(key))
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(src, os.path.join(root, "odil_torch"), ignore=shutil.ignore_patterns("__pycache__"))
        cu = os.path.join(root, "odil_torch", "csrc", source)
        with open(cu) as fh:
            text = fh.read()
        for pattern, repl in edits:
            text, n = re.subn(pattern, repl, text)
            if n != 1:
                cs.fail(f"edit {pattern!r} matched {n} statements of {cu}")
        with open(cu, "w") as fh:
            fh.write(top + text)
        spec = importlib.util.spec_from_file_location(f"build_{subdir}_{key}".replace(" ", "_"),
                                                      os.path.join(root, "odil_torch", "ops", "_build.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[key] = mod
    return mods


def build_together(jobs):
    """The library paths of jobs [(a _build module, compile_source's
    arguments)], built together (one nvcc each)."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        return list(ex.map(lambda j: j[0].compile_source(*j[1])[0], jobs))


def phase_libraries():
    """{phase: ctypes handle} of the phase-cut copies 1-3 of this tree's
    rowwise.cu, built together under build/phases/."""
    mods = edited_trees("phases", "rowwise.cu", {p: (f"#define ODIL_PHASE {p}\n", PHASE_EDITS) for p in (1, 2, 3)})
    paths = build_together([(mod, ("rowwise",)) for mod in mods.values()])
    return {phase: ctypes.CDLL(path) for phase, path in zip(mods, paths)}


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
            _build.load = lambda name, *a, lib=lib: lib if name == "rowwise" else load(name, *a)
            try:
                times[phase] = cs.kernel_ms(torch, lambda: backward(*args, False), 50)
            finally:
                _build.load = load
        times[4] = cs.kernel_ms(torch, lambda: backward(*args, False), 50)
        times[5] = cs.kernel_ms(torch, lambda: backward(*args, True), 50)
        print(f"{tag} phases of {what}: " + "; ".join(f"{p} {PHASES[p]} {t:.4f}" for p, t in times.items())
              + f" ms [{card}]")


# The wide nets' cases: name -> (hidden widths, keep_init, keep_frozen,
# sizes, routes): "slabbed" (forward, backward+sums, backward), "stream" (the
# streaming pair), "shard" (the masked kernels on shard 1 of t:4).
WIDE_CASES = {
    "w16x16x16_ki0_kf0": ((16, 16, 16), 0, 0, (1024,), ("slabbed", "stream", "shard")),
    "w32x32_kf0": ((32, 32), 1, 0, (64, 256), ("slabbed",)),
    "w32x32x32_ki0_kf0": ((32, 32, 32), 0, 0, (1024,), ("slabbed",)),
}
WIDE_PHASE_CASES = ABLATION_CASES = (("w16x16x16_ki0_kf0", 1024), ("w32x32_kf0", 64))
# The phase cuts of rows1d.cuh's tile loop (the tail's comment says "column"
# before the redesign, "sum" after).
WIDE_PHASE_EDITS = (
    (r"if constexpr \(M::FACES\) \{(\n\s*constexpr int j0 = grads \? 0 : 1, nf = grads \? NFACE : TILE \+ 1;\n"
     r"\s*for \(int idx)", r"if constexpr (M::FACES && ODIL_PHASE >= 2) {\1"),
    (r"\{(\n\s*constexpr int i0 = grads \? 0 : 1, nc = grads \? RW : TILE;)", r"if (ODIL_PHASE >= 3) {\1"),
    (r"if constexpr \(grads\) \{(\n\s*for \(int idx = tid; idx < nown \* TILE;)",
     r"if constexpr (grads) if (ODIL_PHASE >= 4) {\1"),
    (r"if \(infer\) \{(  // each param's (?:column|sum))", r"if (infer && ODIL_PHASE >= 5) {\1"),
)
WIDE_PHASES = {1: "staging", 2: "+ faces", 3: "+ cell terms", 4: "+ gather, param cotangents", 5: "+ tail"}
# Copies of heat_wide.cuh: tanhf in place of tanh_fast; the param phase's
# records stored without running a pass's net again (its values wrong: a
# time only).
ABLATIONS = {
    "tanhf": ("", ((r"const float e = __expf\(-2\.0f \* fabsf\(x\)\);\n\s*return copysignf\(__fdividef\(1\.0f - e, "
                    r"1\.0f \+ e\), x\);", "return tanhf(x);"),)),
    "no-rerun": ("", ((r"const float acc = net<false, true>\(w\.wts, x, tout, rec, hl\);",
                       "const float acc = x; (void)tout; for (int k = 0; k < h_off(NL); ++k) rec[k * RS] = x * k; "
                       "for (int i = 0; i < MW; ++i) hl[i] = x + i;"),)),
}
# A copy of heat_net.cu with a kernel of tanh_fast and tanhf over an array.
TANH_PROBE = ("", ((r'extern "C" \{', """__global__ void tanh_probe_kernel(const float* x, float* y, float* z, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    y[i] = rows1d::tanh_fast(x[i]);
    z[i] = tanhf(x[i]);
  }
}

extern "C" {

int odil_tanh_probe(const float* x, float* y, float* z, int n) {
  tanh_probe_kernel<<<(n + 255) / 256, 256>>>(x, y, z, n);
  return (int)cudaDeviceSynchronize();
}
"""),))


def wide_kw(widths, ki, kf, lane):
    return dict(arch_k=widths, args=argparse.Namespace(
        infer_k=True, imposed=lane["imposed"], nimp=lane["nimp"], noise=0.0, seed=lane["seed"], kimp=2.0, kxreg=0.0,
        kxregdecay=0, ktreg=0.0, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=kf, keep_init=ki,
        solver="odil"))


def wide_case(name, T, N, lane, dev, gen):
    """(model, nterms, hist, fields, params, data, consts) of a wide case at
    (T, N), as chip_smoke.py's phase u makes them."""
    widths, ki, kf, _, _ = WIDE_CASES[name]
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    p, s, e = th.build(nt=T, nx=N, multigrid=False, kernel="pallas", device=dev, **wide_kw(widths, ki, kf, lane))
    model, names, params = th._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
    params = tuple(q + rand(*q.shape) for q in params)
    zero = torch.zeros((1, 1), device=dev)
    u0 = e.init_u
    consts = (u0, torch.roll(u0, 1, 0), torch.roll(u0, -1, 0), torch.arange(N, dtype=torch.float32, device=dev),
              zero, zero)
    return model, len(names), 1, (rand(T, N) + 0.5,), params, (e.imp_mask, e.imp_u + rand(T, N)), consts


def wide_shard_case(name, N, lane, dev):
    """The recorded call of shard 1 of t:4 at N^2."""
    widths, ki, kf, _, _ = WIDE_CASES[name]
    recs = cs.shard_records(torch, np, th, None, {"config": lane}, "heat", N, N, dev,
                            heat_kw=wide_kw(widths, ki, kf, lane))
    r = recs[1]
    return (r["row_fn"], r["nterms"], r["hist"]) + tuple(
        tuple(x.detach().contiguous() for x in r[k]) for k in ("fields", "params", "data", "consts"))


def held(what, got, c, g, sums, masked):
    """got (a forward's sums, or a backward's (dfields, dparams, sums))
    against the plain version in fp64, chip_smoke.py's gates."""
    m, nt_, h, fs, ps, ds, cs_ = c
    w = lambda ts: tuple(t.double() for t in ts)
    c64 = (m, nt_, h, w(fs), w(ps), w(ds), w(cs_))
    if g is None:
        err, ok = cs.close(got.double(), trw._forward_plain(*c64), cs.TERMS_RTOL, 0.0)
    else:
        kd, kp, ks = got
        pd, pp, psums = trw._backward_plain(*c64, g.double(), True)
        if masked:
            qd, qp, _ = trw._backward_plain(*c, g, True)
            err, ok, _ = cs.close_floor(list(kd) + list(kp), list(qd) + list(qp), list(pd) + list(pp))
        else:
            err, ok = cs.close_all([a.double() for a in kd + kp], list(pd) + list(pp))
        if sums:
            ok = ok and cs.close(ks.double(), psums, cs.TERMS_RTOL, 0.0)[1]
    if not ok:
        cs.fail(f"{what} disagrees with its plain version (max|d| {err:.3e})")
    return err


def on_library(lib, fn):
    """fn() with lib as every heat_net.cu library."""
    load = _build.load
    _build.load = lambda src, *a: lib if src == "heat_net" else load(src, *a)
    trw._heat_net_library.cache_clear()
    try:
        return fn()
    finally:
        _build.load = load
        trw._heat_net_library.cache_clear()


def time_wide(tag, dev, lane, card, names):
    """The wide nets' kernels at WIDE_CASES, held and timed (``wide``)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    for name in names:
        _, _, _, sizes, routes = WIDE_CASES[name]
        for n in sizes:
            for route in routes:
                masked = route == "shard"
                c = wide_shard_case(name, n, lane, dev) if masked else wide_case(name, n, n, lane, dev, gen)
                gs = torch.full((c[1],), 1.0 / c[3][0].numel(), device=dev)
                if masked:
                    fwd, bwd = trw.forward_halo_rows1d_cuda, trw.backward_halo_rows1d_cuda
                elif route == "stream":
                    fwd, bwd = trw.forward_stream_cuda, trw.backward_stream_cuda
                else:
                    fwd, bwd = trw.forward_cuda, trw.backward_cuda
                calls = {"forward": (lambda: fwd(*c), None, True)}
                if route != "stream":
                    calls["backward+sums"] = (lambda: bwd(*c, gs, True), gs, True)
                calls["backward"] = (lambda: bwd(*c, gs, False), gs, False)
                key = f"{name} {tuple(c[3][0].shape)} {route}"
                times, errs = {}, {}
                for what, (fn, g, sums) in calls.items():
                    errs[what] = held(f"{key} {what}", fn(), c, g, sums, masked)
                    times[what] = cs.kernel_ms(torch, fn, 50)
                shape = trw.launch_shape(c[0], c[3], True, True)
                print(f"{tag} {key}: " + ", ".join(f"{k} {v:.4f} ms (max|d| {errs[k]:.2e})" for k, v in times.items())
                      + f"; backward+sums launch (slab, tiles, blocks, resident) {shape} [{card}]", flush=True)
                del c


def wide_phases(tag, dev, lane, card, names):
    """Where the wide nets' backward+sums spends its time (``widephases``)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = [(name, n) for name, n in WIDE_PHASE_CASES if name in names]
    nets = sorted({WIDE_CASES[name][0] for name, _ in cases})
    mods = edited_trees("wide_phases", "rows1d.cuh",
                        {p: (f"#define ODIL_PHASE {p}\n", WIDE_PHASE_EDITS) for p in (1, 2, 3, 4)})
    jobs = [(phase, w) for phase in mods for w in nets]
    paths = dict(zip(jobs, build_together([(mods[p], trw.heat_net_source(w)) for p, w in jobs])))
    for name, n in cases:
        c = wide_case(name, n, n, lane, dev, gen)
        gs = torch.full((c[1],), 1.0 / c[3][0].numel(), device=dev)
        fn = lambda: cs.kernel_ms(torch, lambda: trw.backward_cuda(*c, gs, True), 50)
        times = {p: on_library(ctypes.CDLL(paths[(p, WIDE_CASES[name][0])]), fn) for p in mods}
        times[5] = fn()
        print(f"{tag} phases of the {name} {n}^2 backward+sums: "
              + "; ".join(f"{p} {WIDE_PHASES[p]} {t:.4f}" for p, t in times.items()) + f" ms [{card}]", flush=True)


def wide_ablations(tag, dev, lane, card, names):
    """The wide kernels beside their ABLATIONS copies, in turns (``ablations``)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = [(name, n) for name, n in ABLATION_CASES if name in names]
    nets = sorted({WIDE_CASES[name][0] for name, _ in cases})
    mods = edited_trees("wide_ablations", "heat_wide.cuh", ABLATIONS)
    jobs = [(v, w) for v in mods for w in nets]
    paths = dict(zip(jobs, build_together([(mods[v], trw.heat_net_source(w)) for v, w in jobs])))
    for name, n in cases:
        c = wide_case(name, n, n, lane, dev, gen)
        gs = torch.full((c[1],), 1.0 / c[3][0].numel(), device=dev)
        fn = lambda: (cs.kernel_ms(torch, lambda: trw.forward_cuda(*c), 50),
                      cs.kernel_ms(torch, lambda: trw.backward_cuda(*c, gs, True), 50))
        for turn in "ab":
            times = {"shipped": fn()}
            for v in mods:
                times[v] = on_library(ctypes.CDLL(paths[(v, WIDE_CASES[name][0])]), fn)
            print(f"{tag}-{turn} ablations of {name} {n}^2 (forward, backward+sums ms): "
                  + "; ".join(f"{v} {f:.4f}, {b:.4f}" for v, (f, b) in times.items()) + f" [{card}]", flush=True)


def tanh_error(tag, dev, card):
    """tanh_fast and tanhf against fp64 tanh on the card (``tanh``): every
    scale of |x| from 1e-30 to 20, and -10..10 evenly."""
    mod = edited_trees("tanh_probe", "heat_net.cu", {"probe": TANH_PROBE})["probe"]
    lib = ctypes.CDLL(build_together([(mod, trw.heat_net_source((16, 16, 16)))])[0])
    mags = torch.logspace(-30, np.log10(20.0), 1 << 21, dtype=torch.float64)
    x = torch.cat([mags, -mags, torch.linspace(-10, 10, 1 << 21, dtype=torch.float64)]).float().to(dev)
    y, z = torch.empty_like(x), torch.empty_like(x)
    err = lib.odil_tanh_probe(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                              ctypes.c_void_p(z.data_ptr()), ctypes.c_int(x.numel()))
    if err:
        cs.fail(f"the tanh probe failed: cuda error {err}")
    ref = torch.tanh(x.double())
    ax = x.abs().double()
    out = {}
    for lo, hi in ((0, 1e-3), (1e-3, 0.1), (0.1, 0.55), (0.55, 3.0), (3.0, 30.0)):
        band = (ax >= lo) & (ax < hi)
        for what, got in (("tanh_fast", y), ("tanhf", z)):
            d = (got.double() - ref)[band].abs()
            out[f"{what} |x| in [{lo}, {hi})"] = dict(
                abs=float(d.max()), rel=float((d / ref[band].abs().clamp_min(1e-300)).max()))
    print(f"{tag} tanh against fp64 tanh ({x.numel()} inputs): " + json.dumps(out) + f" [{card}]", flush=True)


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    which = sys.argv[2].split(",") if len(sys.argv) > 2 else ["heat", "wave", "vt"]
    names = sys.argv[3].split(",") if len(sys.argv) > 3 else list(WIDE_CASES)
    if not torch.cuda.is_available():
        cs.fail("no card: the kernels run only on the card")
    dev = torch.device("cuda")
    card = cs.card_line()
    if {"heat", "wave", "vt", "phases"} & set(which):
        row_kernels(tag, which, dev, card)
    with open(cs.HEAT_DATA) as fh:
        lane = json.load(fh)["config"]
    if "wide" in which:
        time_wide(tag, dev, lane, card, names)
    if "widephases" in which:
        wide_phases(tag, dev, lane, card, names)
    if "ablations" in which:
        wide_ablations(tag, dev, lane, card, names)
    if "tanh" in which:
        tanh_error(tag, dev, card)


def row_kernels(tag, which, dev, card):
    """The row kernels of rowwise.cu (the module docstring's first part)."""
    _, _, log = _build.compile_source("rowwise")
    regs, name = [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
        elif "Used" in line and name and ("rows1d" in name or "rows_kernel" in name):
            regs.append(f"{name[:60]}: {line.split(':', 1)[1].strip()}")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    shape = getattr(trw, "launch_shape", None)
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
