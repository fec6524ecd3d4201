"""Where the fused mg loss+grad's time goes on one NVIDIA card, by ablation:
the port's counterpart of ``benchmarks/kernel_ablation.py``, with its flags
(``--device`` in place of ``--cpu``) and its JSON keys.

Run on the card (from the root of a checkout):

    python -m odil_torch.tools.kernel_ablation [--nt 64] [--nx 256] [--length 200] [--reps 5] \\
        [--variants full,kernel-only,trivial-row,no-matmul,vpu] [--device cuda]

Variants, each timed as the one-pass loss+grad chain of
``tools/roofline.py`` (carry ``x - 1e-30 * g``; a warm-up chunk, then
``reps`` chunks, the median ms an iteration):

  full         the ``pallas_mg`` route as every path runs it;
  kernel-only  ``ops/rowwise_mg.backward_mg_cuda`` alone on the partials of
               ``Problem._flatten_multigrid_batched(partial_out=...)``, the
               carry t0s and coarse minus 1e-30 times their cotangents: the
               delta against full prices the prologue (the multigrid Horner
               ladder and its vjp, two CUDA graphs) and the epilogue;
  trivial-row  the mg kernel's build with the JAX tool's trivial row
               (``ops/mg_ablation.py``): the delta bounds all row math;
  no-matmul    the build without the in-kernel 2-tap prolongation and its
               transpose (tiled and sliced copies of the same shapes): the
               delta bounds the in-kernel prolongation, the TPU's MXU dots;
  vpu          the fma probe's chain (``ops/probes.fma``, K = 128 FMAs an
               element): the achievable fp32 FMA rate, and the row math's
               operations at that rate.

``raw-bwd``, ``split-bwd`` and ``raw-both`` price the TPU's MXU precision
passes; the port keeps fp32 and has no dot in the kernel, so they are
printed as having no counterpart and nothing is computed for them.  The
ablated variants compute wrong results, as the JAX tool's do: this is a
pricing tool.  ``row_math_gflops_per_eval`` counts the veltracer row
model's fp32 operations (residuals and adjoint, ``OPS_ROWS_BACKWARD`` a
cell) in place of XLA's cost analysis, and the key
``xla_prologue_epilogue_ms`` keeps its name for the port's prologue and
epilogue.  ``--device cpu`` runs the plain versions (no device metric).
"""

import argparse
import contextlib
import json

from odil_torch.tools.roofline import (
    OPS_ROWS_BACKWARD,
    device_of,
    flagship,
    fine_arrays,
    lossgrad_chain,
    timed_chain,
)

VARIANTS = ("full", "trivial-row", "no-matmul", "raw-bwd", "split-bwd", "raw-both")
NO_COUNTERPART = ("the port keeps fp32 and has no dot in the kernel (ROADMAP's precision contract): "
                  "no MXU precision pass to price")


def measure(label, args, dev, ablation=None):
    """ms an iteration of the one-pass loss+grad chain, with ``ablation``
    (a variant of ``ops/mg_ablation.py``) in place of the mg kernel."""
    from odil_torch.ops import mg_ablation

    with mg_ablation.ablated(ablation) if ablation else contextlib.nullcontext():
        _, _, grad_fn, x0 = flagship(args.nt, args.nx, dev)
        dt, reps, _ = timed_chain(lossgrad_chain(grad_fn, args.length), (list(x0), 0), args.length, args.reps, dev)
    print(f"{label}: {dt * 1e3:.4f} ms/iter  reps={reps}", flush=True)
    return dt


def measure_kernel_only(label, args, dev):
    """ms an iteration of the mg kernel alone on precomputed partials: no
    prologue (the coarse Horner ladder), no epilogue, no state update."""
    import torch

    from odil_torch.context import Context
    from odil_torch.models import veltracer as vt
    from odil_torch.ops import rowwise_mg

    problem, state, _, x0 = flagship(args.nt, args.nx, dev)
    domain = problem.domain
    domain.arrays_to_state(x0, state)
    partial = {}
    problem._flatten_multigrid_batched(state, partial_out=partial)
    keys = ("u", "vx", "vy")
    t0s = tuple(partial[k][0].detach() for k in keys)
    f0s = tuple(float(partial[k][1]) for k in keys)
    coarse = tuple(partial[k][2].detach() for k in keys)
    extra = problem.extra
    model, nterms = vt._row_model(Context(domain, state, extra=extra))
    consts = (extra.u_init, extra.u_final)

    def run(carry):
        t0s_c, coarse_c = carry
        for _ in range(args.length):
            _, (dt0, dcoarse, _) = rowwise_mg.rowwise_mg_loss_and_grads(
                model, t0s=t0s_c, coarse=coarse_c, factors0=f0s, consts=consts, nterms=nterms, hist=1)
            t0s_c = tuple(torch._foreach_add(list(t0s_c), list(dt0), alpha=-1e-30))
            coarse_c = tuple(torch._foreach_add(list(coarse_c), list(dcoarse), alpha=-1e-30))
        return t0s_c, coarse_c

    dt, reps, _ = timed_chain(run, (t0s, coarse), args.length, args.reps, dev)
    print(f"{label}: {dt * 1e3:.4f} ms/iter  reps={reps}", flush=True)
    return dt


def measure_vpu(args, dev):
    """The fma probe's chain: the achievable fp32 FMA rate (2 K operations an
    element over its time), and the row math's operations an evaluation
    (the veltracer row model's residuals and adjoint, counted)."""
    from odil_torch.ops import probes

    T = args.nt + 1
    K = probes.FMA_K

    def run(x):
        for _ in range(args.length):
            x = probes.fma(x, K)
        return x

    dt_fma, reps, _ = timed_chain(run, fine_arrays(T, args.nx, dev, 1)[0], args.length, args.reps, dev)
    cells = T * args.nx * args.nx
    ceiling_tflops = 2 * K * cells / dt_fma / 1e12
    print(f"vpu-ceiling: {dt_fma * 1e3:.4f} ms/iter = {ceiling_tflops:.2f} TFLOP/s  reps={reps}", flush=True)
    row_flops = OPS_ROWS_BACKWARD * cells
    print(f"row-math flops (counted, OPS_ROWS_BACKWARD {OPS_ROWS_BACKWARD} a cell): {row_flops / 1e9:.3f} G/eval",
          flush=True)
    return dt_fma, ceiling_tflops, row_flops / 1e9


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nt", type=int, default=64)
    parser.add_argument("--nx", type=int, default=256)
    parser.add_argument("--length", type=int, default=200)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--variants", type=str, default="", help="comma-separated subset (default: all but vpu)")
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    dev, card = device_of(args.device)
    sel = args.variants.split(",") if args.variants else None
    variants = [v for v in VARIANTS if sel is None or v in sel]

    results, absent = {}, {}
    if sel is None or "kernel-only" in sel:
        results["kernel-only"] = measure_kernel_only("kernel-only", args, dev)
    for name in variants:
        if name in ("raw-bwd", "split-bwd", "raw-both"):
            print(f"{name}: no counterpart on this card: {NO_COUNTERPART}", flush=True)
            absent[name] = NO_COUNTERPART
            continue
        results[name] = measure(name, args, dev, None if name == "full" else name)

    vpu_stats = measure_vpu(args, dev) if sel is not None and "vpu" in sel else None

    out = {"shape": [args.nt, args.nx, args.nx], "length": args.length, "device": card,
           "ms_per_iter": {k: round(v * 1e3, 4) for k, v in results.items()}}
    if absent:
        out["no_counterpart"] = absent
    if "full" in results:
        f = results["full"]
        for k, label in (("trivial-row", "row_math_bound_ms"),
                         ("no-matmul", "in_kernel_matmul_bound_ms"),
                         ("kernel-only", "xla_prologue_epilogue_ms")):
            if k in results:
                out[label] = round((f - results[k]) * 1e3, 4)
    if vpu_stats:
        dt_fma, tflops, row_gflops = vpu_stats
        out.update({"vpu_ms": round(dt_fma * 1e3, 4), "vpu_ceiling_tflops": round(tflops, 2),
                    "row_math_gflops_per_eval": round(row_gflops, 3)})
        # The time the row math would need unoverlapped if every counted
        # operation ran at the FMA ceiling.
        at_ceiling = row_gflops / tflops
        out["row_math_at_ceiling_ms"] = round(at_ceiling, 4)
        if "trivial-row" in results and "full" in results and results["full"] > results["trivial-row"]:
            # Far below 1: the row math overlaps the kernel's other work.
            out["row_math_overlap_factor"] = round(at_ceiling / ((results["full"] - results["trivial-row"]) * 1e3), 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
