"""The roofline position of the flagship's training step on one NVIDIA card:
the port's counterpart of ``benchmarks/roofline.py``, with its flags and
its JSON keys.

Run on the card (from the root of a checkout):

    python -m odil_torch.tools.roofline [--nt 64] [--nx 256] [--length 200] [--reps 3] [--device cuda]

Three chains at velocity_from_tracer (T, nx, nx), T = nt + 1:

  1. the full epoch: ``models/veltracer.build(kernel="pallas_mg")`` trained
     by ``optim/adam.Adam`` with bfloat16 slots (``bench.py``'s program, the
     JAX tool's ``epoch_step``), ``run_chunk(length)``; the same chain with
     fp32 slots beside it, and both chains' losses, ungated;
  2. loss+grad only: the carry ``x - 1e-30 * g``;
  3. the copy3 chain (``ops/probes.copy3``, ``csrc/probes.cu``) over three
     fine arrays, each call's outputs the next call's inputs: the achievable
     HBM copy rate for this access pattern.

Timing: the JAX tool's scan chains hide an RPC; here a warm-up chunk of the
measured length, then ``reps`` chunks, each ending in a synchronize; the
median ms an iteration, every rep in ``rep_times_ms``.  Bytes are the JAX
tool's analytic minima, word for word, so an achieved rate is a lower
bound.  The peak is this card's data-sheet HBM rate (3350 GB/s, the H100
SXM), and the output names the card and its power limit.  XLA's cost
analysis has no torch counterpart: the operations are the fp32 operations
of the fused mg backward's device code (``OPS_BACKWARD`` a fine cell, the
count every bound of ``PERF.md`` uses), under the key
``kernel_ops_per_eval_G`` in place of ``xla_flops_per_eval_G`` -- another
count, so another name.

This module also holds the counts that the port's bounds divide by and
multiply with (``chip_smoke.py`` and ``tools/kernel_ablation.py`` read
them here): the data-sheet rates and the fp32 operations per cell of each
kernel's device code.  ``--device cpu`` runs the same chains on the plain
versions (no device metric: the output says so).
"""

import argparse
import json
import statistics
import subprocess
import time

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
# The kernel-ablation builds of the mg backward (ops/mg_ablation.py), per
# fine cell: trivial-row keeps the rebuild and its transpose and replaces
# the row math by two sums of 8 values (14), 12 products for the terms, the
# squares into the sums (12) and the two weights of the adjoint (24);
# no-matmul keeps the row math and replaces the rebuild by the t-blend and
# f0 * t0 + value (5 a field) and the transpose by the t-blend (2 a field).
OPS_TRIVIAL_ROW_BACKWARD = 3 * 23 + 14 + 12 + 12 + 24 + 12
OPS_NO_MATMUL_BACKWARD = 3 * 5 + OPS_ROWS_BACKWARD + 3 * 2
# The heat and wave row models (heat_row.cuh, wave_row.cuh), per residual
# cell, a multiply-add counted as two operations and a tanhf or expf as one:
# heat's conductivity net runs once per face, about one face a cell, with
# its face temperature (3), and the stencil (~25); its backward adds the
# stencil's adjoint (~30), the net's param adjoint once per face and the
# gather (6), and without keep_frozen the net's tangent once per face and the
# face temperatures' cotangents (heat_net_ops).  Wave: the stencil (16) and
# its adjoint (20).


def heat_net_ops(widths=(5, 5)):
    """fp32 operations of one pass of the conductivity net [1, *widths, 1]
    (its multiply-adds, a tanhf a hidden unit, the expf, 3 for the sigmoid
    and kmax: 84 for [1, 5, 5, 1]), of its param adjoint (4 for the output's
    cotangent, an add a bias, a multiply-add a weight, the cotangents back
    through every layer but the first -- a multiply where the layer has one
    output -- and 3 a hidden unit for tanh's derivative: 170), and of its
    tangent with the face temperatures' cotangents (without keep_frozen)."""
    dims = (1,) + tuple(widths) + (1,)
    macs = sum(a * b for a, b in zip(dims, dims[1:]))
    hidden = sum(widths)
    back = sum(ni * (1 if no == 1 else 2 * no) for ni, no in zip(dims[1:-1], dims[2:]))
    net = 2 * macs + hidden + 1 + 3
    vjp = 4 + hidden + 1 + 2 * macs + back + 3 * hidden
    tangent = 2 * (macs - dims[1]) + 3 * hidden + 4 + 8
    return net, vjp, tangent


def heat_ops(widths=(5, 5), keep_frozen=True):
    """(forward, backward) fp32 operations per residual cell of the heat row
    model with the conductivity net of hidden ``widths``."""
    net, vjp, tangent = heat_net_ops(widths)
    forward = net + 3 + 25
    return forward, forward + 30 + vjp + 6 + (0 if keep_frozen else tangent)


OPS_HEAT_NET, OPS_HEAT_NET_VJP, _ = heat_net_ops()
OPS_HEAT_FORWARD, OPS_HEAT_BACKWARD = heat_ops()
OPS_WAVE_FORWARD = 16
OPS_WAVE_BACKWARD = OPS_WAVE_FORWARD + 20
# The two-level backward adds, per level-1 cell, the rebuild of the level-1
# value (23 per field) and the transposed prolongation one level down and
# the f1 scaling (5 per field).
OPS_LVL2_PER_COARSE = 3 * (23 + 5)


def device_of(name):
    """(torch device, its description): the card's name and power limit
    (nvidia-smi), or the CPU's note.  A CUDA device without a card raises:
    no measurement falls back to the CPU."""
    import torch

    dev = torch.device(name)
    if dev.type != "cuda":
        return dev, "cpu (the kernels' plain versions: no device metric)"
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false; pass --device cpu for the plain versions")
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        card = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return dev, card.strip()


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_chain(run, carry, length, reps, dev):
    """One warm-up chunk + ``reps`` timed chunks of ``run(carry) -> carry``
    (a chunk of ``length`` iterations), each ending in a synchronize.  The
    carry evolves through every chunk.  Returns (median seconds an
    iteration, every rep's ms an iteration, the last carry)."""
    carry = run(carry)
    sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        carry = run(carry)
        sync(dev)
        times.append((time.perf_counter() - t0) / length)
    return statistics.median(times), [round(t * 1e3, 4) for t in times], carry


def flagship(nt, nx, dev):
    """(problem, state, grad_fn, arrays) of velocity_from_tracer at (nt, nx,
    nx) on the ``pallas_mg`` one-pass route."""
    from odil_torch.models import veltracer as vt

    problem, state, _ = vt.build(nt=nt, nx=nx, ny=nx, kernel="pallas_mg", device=dev)
    grad_fn = problem.make_loss_grad_fn(state)
    if grad_fn is None:
        raise RuntimeError("make_loss_grad_fn declined the flagship: the one-pass route did not apply")
    return problem, state, grad_fn, problem.domain.arrays_from_state(state)


def lossgrad_chain(grad_fn, length):
    """run(carry) of loss+grad only: carry (x, epoch) -> (x - 1e-30 g,
    epoch + length)."""

    import torch

    def run(carry):
        x, t = carry
        for _ in range(length):
            _, g = grad_fn(x, {"epoch": t})
            x = torch._foreach_add(x, list(g), alpha=-1e-30)  # x - 1e-30 g, one multi-tensor launch
            t += 1
        return x, t

    return run


def copy_chain(length):
    """run(carry) of the copy3 probe: each call's outputs the next call's
    inputs."""
    from odil_torch.ops import probes

    def run(carry):
        for _ in range(length):
            carry = probes.copy3(*carry)
        return carry

    return run


def fine_arrays(T, nx, dev, count, seed=0):
    """``count`` uniform fp32 (T, nx, nx) arrays from a seeded generator, made
    on the device."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.rand((T, nx, nx), generator=gen, device=dev) for _ in range(count)]


def main(argv=None):
    import torch

    from odil_torch.optim import Adam

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nt", type=int, default=64)
    parser.add_argument("--nx", type=int, default=256)
    parser.add_argument("--length", type=int, default=200)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    dev, card = device_of(args.device)

    problem, state, grad_fn, x0 = flagship(args.nt, args.nx, dev)

    # -- chain 1: the full epoch (bench.py's program), bf16 slots; fp32 beside it
    epochs, losses = {}, {}
    for slots, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        opt = Adam(grad_fn, x0, lr=0.01, slot_dtype=dtype)
        last = []

        def run_epochs(carry, opt=opt, last=last):
            last.append(float(opt.run_chunk(args.length)[-1]))
            return carry

        dt, reps, _ = timed_chain(run_epochs, None, args.length, args.reps, dev)
        epochs[slots] = (dt, reps)
        losses[slots] = last
        del opt

    # -- chain 2: loss+grad only
    dt_lg, lg_times, _ = timed_chain(lossgrad_chain(grad_fn, args.length), (list(x0), 0), args.length, args.reps, dev)

    # -- chain 3: the copy3 chain over the fine arrays
    T = args.nt + 1
    dt_copy, copy_times, _ = timed_chain(copy_chain(args.length), fine_arrays(T, args.nx, dev, 3), args.length,
                                         args.reps, dev)

    # -- byte accounting (the JAX tool's analytic minima)
    Tc = args.nt // 2 + 1
    fine = T * args.nx * args.nx * 4
    coarse = Tc * (args.nx // 2) * (args.nx // 2) * 4
    consts = 2 * args.nx * args.nx * 4
    state_b = sum(int(a.numel()) * 4 for a in x0)  # all levels of all 3 fields
    lg_bytes = 2 * 3 * (fine + coarse) + consts
    adam_bytes = state_b * (4 + 2 + 2 + 4 + 2 + 2) // 4  # r g,m,v + w x,m,v (bf16 slots) per f32 elem
    adam_bytes += state_b  # read x
    epoch_bytes = lg_bytes + adam_bytes
    copy_bytes = 2 * 3 * fine

    dt_epoch = epochs["bf16"][0]
    gbps_lg = lg_bytes / dt_lg / 1e9
    gbps_epoch = epoch_bytes / dt_epoch / 1e9
    gbps_copy = copy_bytes / dt_copy / 1e9
    peak = HBM_BYTES_PER_S / 1e9
    ops = OPS_BACKWARD * T * args.nx * args.nx

    out = {
        "shape": [args.nt, args.nx, args.nx],
        "device": card,
        "epoch_ms": round(dt_epoch * 1e3, 4),
        "lossgrad_ms": round(dt_lg * 1e3, 4),
        "copy_ms": round(dt_copy * 1e3, 4),
        "rep_times_ms": {"epoch": epochs["bf16"][1], "lossgrad": lg_times, "copy": copy_times},
        "min_bytes_MB": {"lossgrad": round(lg_bytes / 1e6, 1),
                         "epoch": round(epoch_bytes / 1e6, 1),
                         "copy": round(copy_bytes / 1e6, 1)},
        "achieved_GBps": {"lossgrad": round(gbps_lg, 1), "epoch": round(gbps_epoch, 1)},
        "copy_ceiling_GBps": round(gbps_copy, 1),
        "hbm_peak_GBps": peak,
        "pct_of_hbm_peak": {"lossgrad": round(100 * gbps_lg / peak, 1),
                            "epoch": round(100 * gbps_epoch / peak, 1),
                            "copy": round(100 * gbps_copy / peak, 1)},
        "pct_of_copy_ceiling": {"lossgrad": round(100 * gbps_lg / gbps_copy, 1),
                                "epoch": round(100 * gbps_epoch / gbps_copy, 1)},
        "kernel_ops_per_eval_G": round(ops / 1e9, 4),
        "achieved_TFLOPs_lossgrad": round(ops / dt_lg / 1e12, 3),
        "arith_intensity_flops_per_byte": round(ops / lg_bytes, 2),
        "epoch_fp32_slots_ms": round(epochs["fp32"][0] * 1e3, 4),
        "rep_times_fp32_slots_ms": epochs["fp32"][1],
        "chunk_last_losses": losses,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
