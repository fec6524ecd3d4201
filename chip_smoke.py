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
   h. The streaming pair (``stream=True``; autograd of the loss, since
      make_loss_grad_fn declines a streaming call): velocity_from_tracer at
      (64,256,256) with an operator calling
      ``ctx.rowwise_terms(**_kernel_decl(ctx), stream=True)``, against
      ``ref_velt_256.csv`` as in a.; at 64^3, 50 epochs, epoch 0 within 1e-5
      and epoch 50 within 15% of ``ref_velt_64.csv``; wave at 64^2, 200
      epochs, every 20-epoch row within 1% of g.'s slabbed route, and at
      1024^2, 40 epochs, epoch 0 within 1e-5 of the plain operator; heat with
      its kernel calls streaming at 64^2, 100 epochs from e.'s initial net,
      every 20-epoch row within 1% of e.'s slabbed route, and at 1024^2, 10
      epochs, epoch 0 within 1e-5 of the plain operator.  One stream forward
      and one stream backward (sums off) per epoch, and no other kernel.
   i. Two-level fusion: ``kernel="pallas_mg"`` at (64,256,256) with the
      veltracer hook ``_mg_loss_and_grads.partial_depth`` set to 2, against
      ``ref_velt_256.csv`` as in a. (the worst row printed beside a.'s); the
      one-pass gradients at a seeded random state within rtol 1e-5, atol
      1e-6 * max of depth 1's; one two-level backward+sums per epoch and no
      other kernel; then ms/epoch of depth 1 and depth 2 in turns.
   j. The halo (per-shard) path: velocity_from_tracer at (64,256,256) on the
      mesh t:2,x:2 of four shards of the card (``parallel.mesh_from_spec``
      with the card four times), ``make_loss_grad_fn(halo=True)`` with
      ``halo_fuse="generic"`` and ``"mg"`` (the route asserted: a None or
      another route fails), each against ``ref_velt_256.csv`` as in a. and
      with epoch 0 within 1e-5 of a.'s unsharded run (the largest row
      difference from it printed); one masked per-shard backward+sums (or
      one local-block mg backward) a shard and epoch and no other kernel; at
      a seeded random state each route's loss and gradients against the
      unsharded one-pass of the same kernel family (``pallas`` for the
      generic route, ``pallas_mg`` for the mg one) within rtol 1e-5, atol
      1e-6 * max.  The mg route also at (64,512,512), 40 epochs, epoch 0
      within 1e-5 of the plain operator (shards of the shapes where the TPU
      takes its local-tiled kernel).
   k. Loss-only and autograd through ``make_halo_loss_fn`` (one masked
      forward and one masked backward a shard and epoch), 20 epochs, every
      row within 1% of j.'s generic run, and its gradients at the trained
      state against the generic route's.
   l. A row model without a CUDA counterpart: heat 64^2 with ``keep_init=0``
      (no hand adjoint, so ``cuda_model=None``) trained 50 epochs on the card
      through the one-pass route, whose row-wise call runs the plain version
      on the card (``rowwise.plain_on_card``, once an epoch, and no kernel);
      epoch 0 within 1e-5 and every 10-epoch row within 1% of the plain
      operator (``kernel="xla"``) trained the same way by autograd.
   m. The training harness: the command-line examples run as a user runs
      them, through ``util.optimize``, ``make_callback`` and ``History``,
      each in a new directory under ``build/`` (the working directory and
      the log sink restored after).  ``odil_torch.examples.veltracer`` at
      (64,256,256) with ``--kernel pallas_mg`` for ``--epochs`` epochs, a
      history row every 10: one mg backward with the sums an epoch plus the
      epoch-0 evaluation's forward and sums-off backward, and no other
      kernel; its ``train.csv`` against ``ref_velt_256.csv`` as in a., and
      rows 10 on within 1e-6 of a.'s hand loop (the same kernels and
      chunks); its ms/epoch (``walltime/epoch`` of its ``train.log``) beside
      a.'s.  ``odil_torch.examples.wave`` at 64^2 in fp64 with L-BFGS-B,
      200 epochs (plain torch on the card, no kernel): epoch 0 within 1e-5 of
      ``ref_wave.csv``, and the min of the last three rows of error_u and
      loss within 1.3 and 1.6 times its final row (tests/test_converged.py).
   n. The remaining command-line examples, run as in m., at the converged
      lane's configurations (tests/test_converged.py), each gated like it
      (the min of the last three rows of each column within its margin times
      the reference's final value) against docs/parity_data: poisson 64^2
      (``--ref osc --rhs exact``, fp64, Adam, 1000 epochs) against
      ``ref_poisson.csv`` (error_u 1.25, loss 1.8); heat 64^2 with
      ``--kernel xla`` and ``--kernel pallas`` (1500 epochs from phase e's
      initial net, put into the CLI's state by wrapping its
      ``make_problem``) against the seed medians of ``ref_heat_seeds.csv``
      (loss 1.5, error_u 1.3, error_k 1.25), the pallas run with one heat
      row backward+sums an epoch plus the epoch-0 evaluation's forward and
      sums-off backward, and its rows from epoch 100 on equal to phase e's
      hand loop's to the bit (epoch 0 within 1e-6: the CLI evaluates it by
      autograd of the loss); infer_constant 64^2 (fp64, the default
      ``lbfgs``, 100 epochs) against ``ref_infconst.csv`` (norm_0, c_diff,
      c_src, c_vel 1.15), and with ``--optimizer lbfgsb`` (1.1); heat_tmax
      64^2 (``lbfgs``, 4000 epochs) against ``ref_heat_tmax.csv`` (norm_eqn
      3, norm_imp 3, loss 10); wave 64^2
      (fp64, ``lbfgs``, 200 epochs) against ``ref_wave.csv`` (error_u 1.3,
      loss 1.8); fields 8x4 (Adam, 100 epochs) against ``ref_fields.csv``
      (loss 1.2, the four norms 1.1); and the heat PINN solver 64^2 (200
      epochs; no archived trajectory: the loss finite and lower at the end).
      Each prints its ms/epoch (its train.log) and wall time, the L-BFGS runs
      their loss+grad evaluations and host syncs an iteration, and the
      device of the L-BFGS iterate and memory (which must be the card's).
   o. Newton and Gauss-Newton: the run scripts' cases (examples/*/run) as
      CLIs, run as in m., against the JAX package's rows in
      ``odil_torch/data/newton_rows.json`` (written on the CPU by
      ``python tests/test_torch_newton_cli.py --write-rows``); no kernel
      on their path.  poisson n and gn (64^2, ``--ref osc --rhs exact
      --multigrid 0``, 3 epochs, fp64) and wave n (``--multigrid 0``) and
      gn (64^2, 5 epochs, fp64): every row within rtol 1e-7, or (gn, whose
      100 CG iterations magnify roundoff in the JAX package too) twice the
      JAX package's own spread under three one-ulp changes of its CG
      operator (stored with the rows), or both below 1e-12 of epoch 0's
      loss (1e-6 of its norms); wave gn again with ``--linsolver_maxiter
      3``, every row within rtol 1e-7; poisson gn again with ``--linsolver
      multigrid`` (BPX) and ``vcycle``, the final loss below plain CG's.
      heat case 0 (256^2,
      ``newton --multigrid 0``, 50 epochs, fp32, ``--checkpoint_every
      50``): each row within twice the JAX package's fp32-to-fp64 spread up
      to its epoch (at least 1e-6).  heat case 2n (64^2, ``--infer_k 1
      --imposed stripe --kwreg 1``, cut to 5 epochs, fp32) from the JAX package's
      initial net with ``--ref_path`` at case 0's checkpoint: epoch 0 within
      1e-5; the JAX package's normal matrix is exactly singular at its first
      solve and its rows are NaN from epoch 2, and the port's must be NaN
      at the same epochs.  veltracer gn (64^3, ``--linsolver_maxiter 10``,
      10 epochs; multigrid fields, so the Jacobi-preconditioned CG with the
      port's own probes): fp32, epoch 0 within 1e-5 and the rows printed
      beside the JAX package's, not gated (a zero Hutchinson entry's
      inverse, 1e30, overflows fp32 in the CG: a zero step or NaN by the
      probes, in either package); with ``--double 1``, epoch 0 within 1e-5
      and the last loss within the band of the JAX package's three seeds
      (1000, 1, 2).  Each prints its ms/epoch and wall
      time, a Newton epoch's split (the linearization's gradients on the
      card with their copy to the host, the assembly and the solve on the
      host, the update), a Gauss-Newton epoch's normal matvecs, CG
      iterations and host syncs, and the device of the iterate.
   p. Heat and wave under ``--halo`` on the mesh t:4 of four shards of the
      card, plot epochs, asynchronous checkpoints and ``compare.py``.  The
      masked per-shard 1-D kernels (the halo layer of ``rows1d.cuh``:
      forward, backward+sums, backward) on every shard of the 64^2 and
      1024^2 grids of heat (e.'s configuration) and wave (fp32) at a seeded
      random state, against the plain version of the wrapped model in fp64
      (``close_floor``; the sums rtol 1e-5), and repeating their bits.  The
      heat CLI (64^2, ``--kernel pallas --infer_k 1 --imposed stripe`` from
      e.'s initial net, 1500 epochs) and the wave CLI (64^2, ``--kernel
      pallas``, fp32, Adam lr 0.001, 200 epochs) unsharded and with
      ``--mesh t:4 --halo 1``, each held to the band its phase holds: heat's
      last rows within e.'s converged margins of the seed medians, and its
      worst 100-epoch row against the unsharded CLI's within twice the
      spread that roundoff alone opens there (e.'s hand loop with every
      gradient entry one ulp up or down every epoch, three seeds: Adam
      carries the roundoff of the shards' other order of summation into a
      trajectory that parts by a few percent at some rows and meets
      again); wave's every
      20-epoch row within 1% of the unsharded CLI's (g.'s band); epoch 0
      within 1e-5,
      both the CLI's row (which
      ``eval_loss_grad`` evaluates unsharded, as in the JAX package) and the
      per-shard loss-only path at the CLI's initial state (four masked
      forwards and sums-off backwards); four per-shard backward+sums an
      epoch (counted apart) and no other kernel but the epoch-0
      evaluation's; each CLI's ms/epoch.  The unsharded runs plot at three epochs with
      ``--dump_data 1`` and a pickle checkpoint at the same epochs: each
      ``data_*.pickle`` carries the JAX example's keys, its ``state_u`` is
      the field of the checkpoint of its epoch to the bit, and whether the
      figures were drawn (they need matplotlib) is printed.  Heat and wave
      at 1024^2 on t:4, 50 epochs: epoch 0 within 1e-5 of f.'s and g.'s
      plain operator; their loss-only paths.  The veltracer CLI of m. with
      ``--checkpoint_format orbax --checkpoint_every 100``: its rows equal
      to m.'s to the bit, a step directory every 100 epochs, the last step
      restored into a fresh state equal to the run's final fields to the
      bit with the Adam slots, two steps left by ``max_to_keep=2``, and its
      ms/epoch beside m.'s (not gated).  ``odil_torch.examples.compare`` on
      the card prints PASS.  The unmasked forms of ``rows1d_kernel`` keep
      the SASS instruction counts and registers of the build before the
      halo layer (``ROWS1D_PINNED``, checked right after the build).
   The streaming kernels (veltracer at (65,256,256) and (65,64,64), heat and
   wave at 64^2 and 1024^2; on the card the slabbed launch, counted apart)
   and the two-level kernel (t0 (65,256,256), t1 (33,128,128), P2
   (17,64,64), x3) are held first to their plain versions, as above, and each
   repeats its bits call after call (the streaming ones also the slabbed
   launch's bits); so are the per-shard kernels at the shapes of j.'s four
   shards (their gradients held to the plain version in fp64 within the
   tolerance plus 4 times the fp32 plain version's own distance from it,
   cell by cell: ``close_floor``): the masked forward, backward+sums and
   backward on (34,130,256) x3 blocks with a (130,256) mask, and the
   local-block mg backward on t0 (33,130,256) x3, coarse windows
   (17,128,128) x3 and heads (1,130,256) x3, for each shard's row offset,
   own rows and first global column.  The row kernels print their launch
   shapes (slabs, tiles, blocks, waves of the resident blocks).
4. Timing: ms/epoch of the training loops with a profiler breakdown of the
   two 256^2 routes and the heat 64^2 route; the mg kernels' time by kernel
   name (the row walk, the dP gather, the level-2 dP pass), where the
   depth-1 and local-block forms must launch no separate dP pass
   (``mg_coarse_grad_kernel``), and a row kernel's backward+sums, slabbed
   or streaming, must launch one kernel (the profiles run after the
   training loops: a profiler session leaves the host slower); and each
   kernel's time (a CUDA
   graph of 50 calls) beside its bound, its plain version's time and its
   launches on its path, every line tagged with the card's name and power
   limit; each streaming kernel's time beside the slabbed launch's on the
   same inputs and its bound also with the rows its slabs read again; the
   launch floor (an empty kernel timed the same way) beside the small
   planes' rows; the operation counts the bounds use.  Two variants that no
   path of the JAX package runs (the
   streaming backward with the sums, which the TPU's ``_backward_stream``
   lacks, and the two-level backward without the sums, which its one
   caller never asks for) are held to their plain versions and timed but
   are not in the kernel table.

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
# cell, a multiply-add counted as two operations and a tanhf or expf as one:
# heat's conductivity net runs once per face, about one face a cell (35
# multiply-adds, 11 transcendentals, 3 for the sigmoid and kmax: 84), with
# its face temperature (3), and the stencil (~25); its backward adds the
# stencil's adjoint (~30), the net's param adjoint once per face (170) and
# the gather (6).  Wave: the stencil (16) and its adjoint (20).
OPS_HEAT_NET, OPS_HEAT_NET_VJP = 84, 170
OPS_HEAT_FORWARD = OPS_HEAT_NET + 3 + 25
OPS_HEAT_BACKWARD = OPS_HEAT_FORWARD + 30 + OPS_HEAT_NET_VJP + 6
OPS_WAVE_FORWARD = 16
OPS_WAVE_BACKWARD = OPS_WAVE_FORWARD + 20
# The two-level backward adds, per level-1 cell, the rebuild of the level-1
# value (23 per field) and the transposed prolongation one level down and
# the f1 scaling (5 per field).
OPS_LVL2_PER_COARSE = 3 * (23 + 5)
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
# Wave 64^2, L-BFGS-B, fp64, 200 epochs (tests/test_converged.py:53-61): the
# min of the last three rows within these factors of ref_wave.csv's final.
WAVE_MARGINS = {"error_u": 1.3, "loss": 1.6}
CHUNK = 10
TERMS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
# The streaming paths' lengths: veltracer 64^3, heat 64^2 and 1024^2.
STREAM_EPOCHS_64, HEAT_STREAM_EPOCHS, HEAT_STREAM_EPOCHS_BIG = 50, 100, 10
# Depth 1 and depth 2 timed in turns: rounds of TURN_EPOCHS epochs each.
TURNS, TURN_EPOCHS = 8, 100
# The halo path: four shards of the card on the mesh t:2,x:2; the loss-only
# route's epochs and the 512^2 mg route's.
HALO_SPEC, HALO_PART, HALO_SHARDS = "t:2,x:2", {"t": "t", "x": "x"}, 4
HALO_LOSS_EPOCHS, HALO_EPOCHS_512 = 20, 40
# Phase p: heat and wave on the mesh t:4 of four shards of the card (the CLIs
# at 64^2 for phase e's and the wave cell's epochs, a history row every
# HALO1D_EVERY; hand loops at 1024^2), and the veltracer CLI's asynchronous
# checkpoints every CKPT_EVERY epochs.
HALO1D_SPEC, HALO1D_PART, HALO1D_SHARDS = "t:4", {"t": "t"}, 4
HALO1D_WAVE_EPOCHS, HALO1D_BIG_EPOCHS = 200, 50
HALO1D_EVERY = {"heat": 100, "wave": 20}
# The seeds of heat's unsharded loop with every gradient entry one ulp up
# or down every epoch: the spread of these runs bounds the heat CLI under
# --halo (twice the largest, since the worst row of three seeds varies by
# nearly that factor).
ROUNDOFF_SEEDS = (1, 2, 3)
CKPT_EVERY = 100
# The unmasked forms of rows1d_kernel as built before its halo layer (SASS
# instructions by cuobjdump, registers by ptxas; measured on one NVIDIA H100
# 80GB HBM3 for rowwise.cu before the layer): the layer leaves them as they were.
ROWS1D_PINNED = {
    ("HeatRow", 1): (5376, 128), ("HeatRow", 2): (5984, 128), ("HeatRow", 3): (6448, 128),
    ("WaveRow", 1): (2744, 40), ("WaveRow", 2): (2456, 40), ("WaveRow", 3): (2904, 43),
}
# The data_*.pickle keys of the JAX examples' plot functions.
PLOT_KEYS = {
    "wave": ["cshape", "lower", "ref_u", "ref_ut", "state_u", "state_ut", "upper"],
    "heat": ["imp_indices", "imp_points", "imp_u", "k", "ref_k", "ref_u", "ref_uk", "state_u"],
}


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


def close_floor(got, want, want64):
    """(max |got-want| over pairs, all within the gradient tolerance of the
    fp64 plain version plus 4 times the fp32 plain version's own distance
    from it, cell by cell, and the reading at the worst cell).  The per-shard
    kernels' random inputs put a few cells of a million where the gradient
    is a cancellation that fp32 resolves to 0.3% only (the fp32 plain version
    is as far from fp64 there); the floor admits those and nothing else.  The
    worst cell is the one where the kernel's distance from fp64 is largest
    against the tolerance without the floor: (that distance, the fp32 plain
    version's distance there, their ratio to the tolerance)."""
    errs, oks, worst = [], [], (0.0, 0.0, -1.0)
    for a, b, c in zip(got, want, want64):
        a, b, c = a.detach().double(), b.detach().double(), c.detach()
        floor = (b - c).abs()
        base = GRAD_RTOL * c.abs() + GRAD_ATOL * float(c.abs().max())
        dist = (a - c).abs()
        errs.append(float((a - b).abs().max()))
        oks.append(bool((dist <= base + 4 * floor).all()))
        r = (dist / base.clamp(min=1e-300)).reshape(-1)
        i = int(r.argmax())
        if float(r[i]) > worst[2]:
            worst = (float(dist.reshape(-1)[i]), float(floor.reshape(-1)[i]), float(r[i]))
    return max(errs), all(oks), worst


def worst_text(w):
    """The worst cell of close_floor as text."""
    return f"worst cell vs fp64: kernel {w[0]:.3e}, fp32 plain {w[1]:.3e} ({w[2]:.2f}x the tolerance without the floor)"


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


def host_profile(torch, opt, tag, n=5):
    """The host's operators by their own CPU time over `n` epochs of `opt`
    (torch.profiler), and the card's busy time: where a host-bound epoch
    goes."""
    from torch.profiler import ProfilerActivity, profile

    opt.run_chunk(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        opt.run_chunk(n)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    device = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    print(f"host profile: {wall:.4f} ms/epoch under the profiler, kernels {device:.4f} ms/epoch; by own CPU time "
          f"per epoch: " + "; ".join(f"{e.key[:48]} {e.self_cpu_time_total / 1e3 / n:.3f} ms in {e.count // n}"
                                     for e in rows) + f" {tag}")


def short_name(name):
    """A kernel's demangled name without its namespace and argument list."""
    for junk in ("void ", "(anonymous namespace)::", "<unnamed>::", "(int)", "(bool)"):
        name = name.replace(junk, "")
    return name[: name.rfind("(")] if name.endswith(")") else name


def sass_counts(path):
    """{kernel: SASS instructions} of a built library (cuobjdump), or {} where
    the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and line.strip().startswith("/*") and "*/" in line and line.split("*/", 1)[1].strip():
            counts[name] += 1
    filt = os.path.join(os.path.dirname(tool), "cu++filt")
    if counts and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(counts), capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(counts):
            counts = {short_name(n): c for n, c in zip(names, counts.values())}
    return counts


def build_all(_build, names=("rowwise_mg", "rowwise")):
    """Compiles every CUDA source, one nvcc each, all started together, and
    prints ptxas's register and shared-memory report and each kernel's SASS
    instruction count."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        results = dict(zip(names, ex.map(_build.compile_source, names)))
    for name, (path, seconds, log) in results.items():
        print(f"build: {os.path.relpath(path, HERE)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())
        for kernel, n in sass_counts(path).items():
            print(f"  sass: {n} instructions in {kernel}")
    return results


def ptxas_registers(log, kernel):
    """{mangled entry: registers} of the entries of a ptxas report whose
    name holds `kernel`."""
    regs, name = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
        elif name and kernel in name and "Used" in line and "registers" in line:
            regs[name] = int(line.split("Used")[1].split("registers")[0])
    return regs


def kernel_split(torch, fn, reps=50):
    """{kernel name: device ms per call of fn} over `reps` calls after a
    warm-up (torch.profiler), the calls' total, and {kernel name: launches
    per call}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, counts = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = short_name(e.name)
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
            counts[name] = counts.get(name, 0) + 1 / reps
    return split, sum(split.values()), counts


def print_split(torch, fn, what, tag):
    split, total, _ = kernel_split(torch, fn)
    print(f"split of {what}: {total:.4f} ms of kernels per call: " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in sorted(split.items(), key=lambda kv: -kv[1])) + f" {tag}")
    return split


class Counters:
    """The launch counters of the kernel wrappers."""

    def __init__(self, rmg, rw):
        self.wrappers = {
            "backward_mg": rmg.backward_mg_cuda, "forward_mg": rmg.forward_mg_cuda,
            "backward_mg2": rmg.backward_mg2_cuda,
            "backward_rows": rw.backward_cuda, "forward_rows": rw.forward_cuda,
            "backward_stream": rw.backward_stream_cuda, "forward_stream": rw.forward_stream_cuda,
            "backward_halo": rw.backward_halo_cuda, "forward_halo": rw.forward_halo_cuda,
            "backward_mg_local": rmg.backward_mg_local_cuda, "plain_on_card": rw.plain_on_card,
            "backward_halo_rows1d": rw.backward_halo_rows1d_cuda, "forward_halo_rows1d": rw.forward_halo_rows1d_cuda,
        }

        # The mg backward's launches that also formed the sums, counted apart
        # by its wrapper.
        self.modes = {"backward_mg_with_sums": (rmg.backward_mg_cuda, "launches_with_sums")}

    def zero(self):
        for w in self.wrappers.values():
            w.launches = 0
        for w, attr in self.modes.values():
            setattr(w, attr, 0)

    def read(self):
        counts = {k: w.launches for k, w in self.wrappers.items()}
        counts.update({k: getattr(w, attr) for k, (w, attr) in self.modes.items()})
        return counts


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


def run_cli(torch, counters, name, argv, keep=None):
    """Runs ``odil_torch.examples.<name>.main(argv)`` in a new directory
    under build/ with the launch counters zeroed just before it and read just
    after: (train.csv rows, train.log lines, counts, what main returned, wall
    seconds).  The working directory and the log sink are restored, and the
    directory removed (after ``keep(directory)``, when given)."""
    import importlib
    import shutil
    import tempfile

    from odil_torch import util

    cli = importlib.import_module(f"odil_torch.examples.{name}")
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_", dir=os.path.join(HERE, "build"))
    cwd, sink = os.getcwd(), util._log_sink.stream
    try:
        counters.zero()
        t_start = time.perf_counter()
        result = cli.main(argv + ["--outdir", out])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        counts = counters.read()
    finally:
        os.chdir(cwd)
        if util._log_sink.stream is not sink:
            util._log_sink.stream.close()
            util.set_log_file(sink)
    try:
        with open(os.path.join(out, "train.csv")) as fh:
            rows = list(csv.DictReader(fh))
        with open(os.path.join(out, "train.log")) as fh:
            log = fh.read().splitlines()
        if keep is not None:
            keep(out)
    finally:
        shutil.rmtree(out)
    return rows, log, counts, result, seconds


def log_ms(log):
    """The median walltime/epoch of a train.log's reports, in ms, leaving out
    the report of epoch 0 and the first stretch (the CUDA graph capture)."""
    ms = [float(line.split("walltime/epoch: ")[1].split()[0]) for line in log if "walltime/epoch: " in line]
    return statistics.median(ms[2:] or ms[1:])


def harness_phase(torch, counters, epochs, hand_losses, hand_ms, tag, extra_argv=()):
    """Phase m: the veltracer CLI at the flagship size against
    ref_velt_256.csv and against phase a's hand loop (`hand_losses`, its
    `hand_ms` ms/epoch), then the wave CLI against ref_wave.csv's converged
    margins.  Returns the launches of the mg kernels on the CLI's path, the
    veltracer CLI's train.csv rows and its ms/epoch.  extra_argv goes to
    both CLIs (a rehearsal on the CPU passes --device)."""
    ref256 = read_ref("ref_velt_256.csv")
    none = dict.fromkeys(counters.read(), 0)
    cli_rows, cli_log, counts_vt, *_ = run_cli(torch, counters, "veltracer", [
        "--Nt", str(SIZES["256"][0]), "--Nx", str(SIZES["256"][1]), "--Ny", str(SIZES["256"][2]),
        "--kernel", "pallas_mg", "--epochs", str(epochs), "--history_every", str(CHUNK),
        "--report_every", str(100 if epochs >= 300 else CHUNK), "--plot_every", "0", *extra_argv,
    ])
    # One fused backward (sums on) an epoch, and the epoch-0 evaluation by
    # autograd of the loss: one forward and one backward with the sums off.
    expect_counts(counts_vt, dict(none, backward_mg=epochs + 1, backward_mg_with_sums=epochs, forward_mg=1),
                  "veltracer CLI (pallas_mg)")
    rows = {int(r["epoch"]): float(r["loss"]) for r in cli_rows}
    if sorted(rows) != list(range(0, epochs + 1, CHUNK)):
        fail(f"veltracer CLI: train.csv rows at epochs {sorted(rows)}")
    rel = {e: abs(rows[e] - ref256[e]) / abs(ref256[e]) for e in rows if e in ref256}
    worst = max(rel, key=rel.get)
    hand = trajectory_rows(hand_losses)
    rel_a = {e: abs(rows[e] - hand[e]) / abs(hand[e]) for e in rows if e}
    worst_a = max(rel_a, key=rel_a.get)
    cli_ms = log_ms(cli_log)
    print(f"veltracer CLI (pallas_mg, {epochs} epochs through util.optimize): epoch-0 loss {rows[0]!r} "
          f"(reference {ref256[0]!r}, rel {rel[0]:.2e}); worst row vs ref_velt_256.csv epoch {worst} "
          f"({100 * rel[worst]:.2f}%); worst row vs phase a's hand loop epoch {worst_a} (rel {rel_a[worst_a]:.2e}); "
          f"final {rows[epochs]!r}; columns {list(cli_rows[0])} {tag}")
    print(f"veltracer CLI: {cli_ms:.4f} ms/epoch (median walltime/epoch of its train.log reports after the first) "
          f"against phase a's hand loop {hand_ms:.4f} ms/epoch; launches {counts_vt} {tag}")
    if rel[0] > 1e-5 or any(r > 0.15 for r in rel.values()):
        fail(f"veltracer CLI: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} {100 * rel[worst]:.1f}% (limit 15%)")
    if rel_a[worst_a] > 1e-6:
        fail(f"veltracer CLI: epoch {worst_a} loss {rows[worst_a]} is {rel_a[worst_a]:.2e} from phase a's "
             f"{hand[worst_a]} (limit 1e-6)")

    with open(os.path.join(PARITY, "ref_wave.csv")) as fh:
        ref_wave = list(csv.DictReader(fh))
    wave_rows, wave_log, counts, *_ = run_cli(torch, counters, "wave", [
        "--Nt", "64", "--Nx", "64", "--double", "1", "--optimizer", "lbfgsb", "--epochs", "200",
        "--history_every", "20", *extra_argv,
    ])
    expect_counts(counts, none, "wave CLI (fp64, plain torch on the card)")
    if int(wave_rows[-1]["epoch"]) != int(ref_wave[-1]["epoch"]):
        fail(f"wave CLI: the last row is epoch {wave_rows[-1]['epoch']}, the reference's {ref_wave[-1]['epoch']}")
    rel0 = abs(float(wave_rows[0]["loss"]) - float(ref_wave[0]["loss"])) / abs(float(ref_wave[0]["loss"]))
    got = {c: min(abs(float(r[c])) for r in wave_rows[-3:]) for c in WAVE_MARGINS}
    ratio = {c: got[c] / abs(float(ref_wave[-1][c])) for c in WAVE_MARGINS}
    print(f"wave CLI (64^2 fp64, L-BFGS-B, 200 epochs): epoch-0 loss {wave_rows[0]['loss']} (reference "
          f"{ref_wave[0]['loss']}, rel {rel0:.2e}); min of the last three rows " + ", ".join(
              f"{c} {got[c]!r} ({ratio[c]:.3f}x the reference's final, limit {WAVE_MARGINS[c]})" for c in got)
          + f"; {log_ms(wave_log):.4f} ms/epoch {tag}")
    if rel0 > 1e-5 or any(ratio[c] > WAVE_MARGINS[c] for c in ratio):
        fail(f"wave CLI: epoch 0 rel {rel0:.2e} (limit 1e-5), ratios {ratio} (limits {WAVE_MARGINS})")
    launches = {"backward_mg_sums": counts_vt["backward_mg_with_sums"], "forward_mg": counts_vt["forward_mg"],
                "backward_mg": counts_vt["backward_mg"] - counts_vt["backward_mg_with_sums"]}
    return launches, cli_rows, cli_ms


def read_rows(name):
    with open(os.path.join(PARITY, name)) as fh:
        return list(csv.DictReader(fh))


def converged_gate(rows, ref_rows, margins, what, tag, median=False, epochs=None):
    """The converged lane's gate (tests/test_converged.py): the min over the
    last three rows of each column within its margin times the reference's
    final value (or, with `median`, the median over the reference's seeds),
    at the reference's final epoch (or `epochs`).  Returns the ratios."""
    if median:
        ref = {c: statistics.median(abs(float(r[c])) for r in ref_rows) for c in margins}
        want_epoch = epochs
    else:
        ref = {c: abs(float(ref_rows[-1][c])) for c in margins}
        want_epoch = int(float(ref_rows[-1]["epoch"]))
    if int(float(rows[-1]["epoch"])) != want_epoch:
        fail(f"{what}: the last row is epoch {rows[-1]['epoch']}, the reference's {want_epoch}")
    got = {c: min(abs(float(r[c])) for r in rows[-3:]) for c in margins}
    ratio = {c: got[c] / max(ref[c], 1e-12) for c in margins}
    print(f"{what}: min of the last three rows " + ", ".join(
        f"{c} {got[c]!r} ({ratio[c]:.3f}x the reference's {'seed median' if median else 'final'}, limit "
        f"{margins[c]})" for c in margins) + f" {tag}")
    if any(not (got[c] == got[c]) or ratio[c] > margins[c] for c in margins):
        fail(f"{what}: ratios {ratio} (limits {margins})")
    return ratio


def cli_phase(torch, counters, heat_ref, heat_losses, heat_ms, tag, extra_argv=()):
    """Phase n: the CLIs of poisson, heat (xla, pallas and the PINN solver),
    infer_constant, heat_tmax, wave with its default optimizer and fields at
    the converged lane's configurations (tests/test_converged.py), each held
    to its reference in docs/parity_data.  The heat odil runs start from
    phase e's initial conductivity net (the JAX package's at seed 1000); the
    pallas run's rows from epoch 100 on must equal phase e's hand loop's
    (`heat_losses`) to the bit.  Returns the heat row kernels' launches on
    the pallas run's path.  extra_argv goes to every CLI (a rehearsal on the
    CPU passes --device)."""
    from odil_torch.examples import heat as heat_cli

    none = dict.fromkeys(counters.read(), 0)

    def run(name, argv, what, want_counts=None, lbfgs=False):
        rows, log, counts, (problem, _), seconds = run_cli(torch, counters, name, argv + list(extra_argv))
        expect_counts(counts, want_counts or none, what)
        line = f"{what}: {log_ms(log):.4f} ms/epoch (median walltime/epoch of its train.log reports after the " \
               f"first), {seconds:.2f} s wall"
        if lbfgs:
            opt = problem._active_optimizer
            if not (opt.x.device.type == opt.memory.s.device.type == problem.domain.device.type):
                fail(f"{what}: the L-BFGS iterate ({opt.x.device}) or memory ({opt.memory.s.device}) is not on "
                     f"{problem.domain.device}")
            line += (f"; {opt.evals} iterations, {opt.grad_evals / opt.evals:.3f} loss+grad evaluations and "
                     f"{opt.host_syncs / opt.evals:.3f} host syncs an iteration; memory {tuple(opt.memory.s.shape)} "
                     f"{opt.memory.s.dtype} on {opt.memory.s.device}")
        print(f"{line}; launches {counts} {tag}")
        return rows, counts

    rows, _ = run("poisson", ["--N", "64", "--ref", "osc", "--rhs", "exact", "--double", "1", "--epochs", "1000",
                              "--history_every", "50"], "poisson CLI (64^2 fp64, Adam, 1000 epochs)")
    converged_gate(rows, read_rows("ref_poisson.csv"), {"error_u": 1.25, "loss": 1.8}, "poisson CLI", tag)

    orig = heat_cli.make_problem

    def make_problem(args):
        problem, state = orig(args)
        dtype = torch.float64 if args.double else torch.float32
        net = state.fields["k_net"]
        net.weights = [torch.tensor(w, dtype=dtype, device=problem.domain.device) for w in heat_ref["weights"]]
        net.biases = [torch.tensor(b, dtype=dtype, device=problem.domain.device) for b in heat_ref["biases"]]
        return problem, state

    lane = heat_ref["config"]
    heat_argv = ["--Nt", str(lane["nt"]), "--Nx", str(lane["nx"]), "--infer_k", "1", "--imposed", lane["imposed"],
                 "--nimp", str(lane["nimp"]), "--seed", str(lane["seed"]), "--epochs", str(HEAT_EPOCHS),
                 "--history_every", str(HEAT_EVERY)]
    seeds = read_rows("ref_heat_seeds.csv")
    heat_cli.make_problem = make_problem
    try:
        for kernel in ("xla", "pallas"):
            want = dict(none, backward_rows=HEAT_EPOCHS + 1, forward_rows=1) if kernel == "pallas" else none
            rows, counts = run("heat", heat_argv + ["--kernel", kernel],
                               f"heat CLI (64^2, --kernel {kernel}, Adam, {HEAT_EPOCHS} epochs from phase e's net)",
                               want_counts=want)
            converged_gate(rows, seeds, HEAT_MARGINS, f"heat CLI --kernel {kernel}", tag, median=True,
                           epochs=HEAT_EPOCHS)
            if kernel == "pallas":
                launches = {"backward_rows_sums_heat_64": HEAT_EPOCHS, "forward_rows_heat_64": counts["forward_rows"],
                            "backward_rows_heat_64": counts["backward_rows"] - HEAT_EPOCHS}
                later = [r for r in rows if int(r["epoch"]) >= HEAT_EVERY]
                differ = [int(r["epoch"]) for r in later if float(r["loss"]) != heat_losses[int(r["epoch"]) - 1]]
                rel0 = abs(float(rows[0]["loss"]) - heat_losses[0]) / abs(heat_losses[0])
                print(f"heat CLI --kernel pallas against phase e's hand loop: rows {[int(r['epoch']) for r in later]} "
                      f"equal to the bit: {not differ}; epoch 0 (the CLI's evaluation by autograd of the loss: one "
                      f"forward and one sums-off backward) rel {rel0:.2e}; phase e's loop {heat_ms:.4f} ms/epoch "
                      f"{tag}")
                if differ or rel0 > 1e-6:
                    fail(f"heat CLI --kernel pallas: rows {differ} differ from phase e's hand loop, epoch 0 rel "
                         f"{rel0:.2e} (limit 1e-6)")
    finally:
        heat_cli.make_problem = orig

    rows, _ = run("infer_constant", ["--Nt", "64", "--Nx", "64", "--double", "1", "--epochs", "100",
                                     "--history_every", "20"], "infer_constant CLI (64^2 fp64, lbfgs, 100 epochs)",
                  lbfgs=True)
    converged_gate(rows, read_rows("ref_infconst.csv"), dict.fromkeys(("norm_0", "c_diff", "c_src", "c_vel"), 1.15),
                   "infer_constant CLI", tag)
    rows, _ = run("infer_constant", ["--Nt", "64", "--Nx", "64", "--double", "1", "--epochs", "100",
                                     "--history_every", "20", "--optimizer", "lbfgsb"],
                  "infer_constant CLI (64^2 fp64, L-BFGS-B, 100 epochs)")
    converged_gate(rows, read_rows("ref_infconst.csv"), dict.fromkeys(("norm_0", "c_diff", "c_src", "c_vel"), 1.1),
                   "infer_constant CLI (lbfgsb)", tag)
    rows, _ = run("heat_tmax", ["--Nt", "64", "--Nx", "64", "--epochs", "4000", "--history_every", "200"],
                  "heat_tmax CLI (64^2 fp64, lbfgs, 4000 epochs)", lbfgs=True)
    converged_gate(rows, read_rows("ref_heat_tmax.csv"), {"norm_eqn": 3.0, "norm_imp": 3.0, "loss": 10.0},
                   "heat_tmax CLI", tag)
    rows, _ = run("wave", ["--Nt", "64", "--Nx", "64", "--double", "1", "--epochs", "200", "--history_every", "20"],
                  "wave CLI (64^2 fp64, lbfgs, 200 epochs)", lbfgs=True)
    converged_gate(rows, read_rows("ref_wave.csv"), {"error_u": 1.3, "loss": 1.8}, "wave CLI (lbfgs)", tag)
    rows, _ = run("fields", ["--plot", "0", "--epochs", "100", "--history_every", "10"],
                  "fields CLI (8x4, Adam, 100 epochs)")
    converged_gate(rows, read_rows("ref_fields.csv"), dict({"loss": 1.2}, **dict.fromkeys(
        ("norm_uc", "norm_un", "norm_ufx", "norm_ufy"), 1.1)), "fields CLI", tag)
    rows, _ = run("heat", ["--Nt", "64", "--Nx", "64", "--solver", "pinn", "--infer_k", "1", "--imposed", "random",
                           "--epochs", "200", "--history_every", "100", "--report_every", "100"],
                  "heat CLI (--solver pinn, 64^2, Adam, 200 epochs)")
    first, last = float(rows[0]["loss"]), float(rows[-1]["loss"])
    print(f"heat CLI --solver pinn: loss {first!r} at epoch 0, {last!r} at epoch {rows[-1]['epoch']} (no archived "
          f"PINN trajectory: finite and lower is the gate) {tag}")
    if not (last == last and abs(last) != float("inf") and last < first and rows[-1]["epoch"] == "200"):
        fail(f"heat CLI --solver pinn: loss {first} -> {last} at epoch {rows[-1]['epoch']}")
    return launches


NEWTON_DATA = os.path.join(HERE, "odil_torch", "data", "newton_rows.json")
# The columns of train.csv that carry no number of the run.
NOT_VALUES = ("epoch", "frame", "walltime", "memory", "gpu_used", "gpu_pool")


def value_rows(rows, columns):
    """[epoch, *values] of each train.csv row, the values of `columns`."""
    if [c for c in rows[0] if c not in NOT_VALUES] != columns:
        fail(f"train.csv columns {list(rows[0])}, expected {columns}")
    return [[int(float(r["epoch"]))] + [float(r[c]) for c in columns] for r in rows]


def rows_gate(got, want, columns, what, tag, rtol, spread=None, floor=True, only=None):
    """Every value within rtol of the JAX row's (`rtol` a number or a list by
    row), or twice `spread` (the JAX package's own spread by row and column
    when its CG operator changes by one ulp), or, with `floor`, both below
    1e-12 of epoch 0's loss (1e-6 of its norms); `only` limits the gate to
    those epochs.  Returns the largest relative distance; fails on any other
    value."""
    if [r[0] for r in got] != [r[0] for r in want]:
        fail(f"{what}: rows at epochs {[r[0] for r in got]}, the JAX package's at {[r[0] for r in want]}")
    floors = [1e-12 * abs(v) if c == "loss" else 1e-6 * abs(v) if c.startswith("norm_") else 0.0
              for c, v in zip(columns, want[0][1:])] if floor else [0.0] * len(columns)
    worst, bad = 0.0, []
    for i, (a, b) in enumerate(zip(got, want)):
        if only is not None and a[0] not in only:
            continue
        r = rtol[i] if isinstance(rtol, list) else rtol
        for j, (x, y) in enumerate(zip(a[1:], b[1:])):
            if abs(x) < floors[j] and abs(y) < floors[j]:
                continue
            limit = max(r * abs(y), 2 * spread[i][j] if spread else 0.0)
            if not abs(x - y) <= limit:
                bad.append((a[0], columns[j], x, y, limit))
            worst = max(worst, abs(x - y) / abs(y) if y else 0.0)
    print(f"{what}: largest relative distance from the JAX package's rows {worst:.3e} {tag}")
    if bad:
        fail(f"{what}: rows off the JAX package's (epoch, column, card, JAX, limit): {bad[:6]}")
    return worst


def newton_phase(torch, counters, tag, extra_argv=()):
    """Phase o: the run scripts' Newton and Gauss-Newton cases as CLIs
    through ``util.optimize`` (no kernel on their path), each against the
    JAX package's rows of ``odil_torch/data/newton_rows.json``.  Prints each
    case's ms/epoch and wall time, a Newton epoch's split (the
    linearization's gradients on the card with their copy to the host, the
    assembly and the solve on the host, the update), a Gauss-Newton epoch's
    normal matvecs, CG iterations and host syncs, and the device of the
    iterate.  extra_argv goes to every CLI (a rehearsal on the CPU passes
    --device)."""
    import shutil

    from odil_torch.examples import heat as heat_cli

    with open(NEWTON_DATA) as fh:
        data = json.load(fh)["cases"]
    none = dict.fromkeys(counters.read(), 0)

    def run(name, what, argv=(), keep=None, case=None):
        case = case or data[name]
        csv_rows, log, counts, (problem, state), seconds = run_cli(
            torch, counters, case["module"], case["argv"] + list(argv) + list(extra_argv), keep=keep)
        expect_counts(counts, none, what)
        rows = value_rows(csv_rows, case["columns"])
        stats = problem.solver_stats
        devices = {str(a.device) for a in problem.domain.arrays_from_state(state)}
        if {a.device.type for a in problem.domain.arrays_from_state(state)} != {problem.domain.device.type}:
            fail(f"{what}: the iterate lies on {devices}, not on {problem.domain.device}")
        n = stats["epochs"]
        argv = case["argv"] + list(argv)
        if n != int(argv[len(argv) - 1 - argv[::-1].index("--epochs") + 1]):
            fail(f"{what}: {n} epochs run, {argv} asks for another number")
        if "solve_s" in stats:
            split = ", ".join(f"{k[:-2]} {stats[k] / n * 1e3:.2f}" for k in ("gradients_s", "assembly_s", "solve_s",
                                                                               "update_s"))
            split = f"a Newton epoch in ms: {split} (gradients on the card with their copy to the host)"
        else:
            split = (f"a Gauss-Newton epoch: {stats['matvecs'] / n:.1f} normal matvecs, {stats['iterations'] / n:.1f} "
                     f"CG iterations, {stats['syncs'] / n:.1f} CG host syncs")
        print(f"{what}: {log_ms(log):.4f} ms/epoch (median walltime/epoch of its train.log reports after the first), "
              f"{seconds:.2f} s wall; {split}; iterate on {devices.pop()} {tag}")
        return rows

    def jax_rows(name):
        return data[name]["rows"]

    # Newton, and wave gn with a CG budget of 3 (roundoff below 1e-12 on the
    # CPU): rtol 1e-7.
    for name, what in (("poisson_n", "poisson n CLI (64^2 fp64, Newton, direct)"),
                       ("wave_n", "wave n CLI (64^2 fp64, Newton, direct)"),
                       ("wave_gn_cg3", "wave gn CLI (64^2 fp64, multigrid fields, Gauss-Newton, 3 CG iterations)")):
        rows_gate(run(name, what), jax_rows(name), data[name]["columns"], what, tag, 1e-7)
    # The run scripts' budget of 100 CG iterations magnifies roundoff in the
    # JAX package itself: rtol 1e-7 or twice its own spread.
    gn_final = {}
    for name, what in (("poisson_gn", "poisson gn CLI (64^2 fp64, Gauss-Newton, plain CG)"),
                       ("wave_gn", "wave gn CLI (64^2 fp64, multigrid fields, Gauss-Newton, plain CG)")):
        rows = run(name, what)
        gn_final[name] = rows[-1][data[name]["columns"].index("loss") + 1]
        rows_gate(rows, jax_rows(name), data[name]["columns"], what + " (rtol 1e-7 or twice the JAX package's own "
                  "spread)", tag, 1e-7, spread=data[name]["jax_spread"])
    # The multilevel preconditioners on the card (no case of the run scripts
    # takes them): poisson gn with BPX and with the V-cycle, from the port's
    # own probes; the loss at the end lower than plain CG's.
    for linsolver in ("multigrid", "vcycle"):
        what = f"poisson gn CLI (64^2 fp64, --linsolver {linsolver})"
        rows = run("poisson_gn", what, ["--linsolver", linsolver])
        final = rows[-1][data["poisson_gn"]["columns"].index("loss") + 1]
        print(f"{what}: final loss {final!r} against plain CG's {gn_final['poisson_gn']!r} {tag}")
        if not final < gn_final["poisson_gn"]:
            fail(f"{what}: final loss {final} not below plain CG's {gn_final['poisson_gn']}")

    # heat case 0 (fp32): each row within twice the JAX package's own
    # fp32-to-fp64 spread up to its epoch (at least 1e-6).
    h0 = data["heat0"]
    spread, rel = 0.0, []
    loss_col = h0["columns"].index("loss") + 1
    for a, b in zip(h0["rows"], h0["rows_fp64"]):
        spread = max(spread, abs(a[loss_col] - b[loss_col]) / abs(b[loss_col]))
        rel.append(max(2 * spread, 1e-6))
    build = os.path.join(HERE, "build")
    ref_path = os.path.join(build, "chip_smoke_heat_ref.pickle")

    def keep_checkpoint(out):
        shutil.copy(os.path.join(out, "checkpoint_000050.pickle"), ref_path)

    what = "heat case 0 CLI (256^2 fp32, Newton, direct, 50 epochs)"
    rows = run("heat0", what, keep=keep_checkpoint)
    rows_gate(rows, h0["rows"], h0["columns"], what + " (twice the JAX package's fp32-to-fp64 spread)", tag, rel)

    # heat case 2n (5 epochs) from the JAX package's initial net, the
    # reference from case 0's checkpoint: epoch 0 within 1e-5; the JAX
    # package meets an exactly singular normal matrix at its first solve and
    # is NaN from epoch 2, and so must the port be.
    orig = heat_cli.make_problem
    init = data["heat2n"]["init_net"]

    def make_problem(args):
        problem, state = orig(args)
        dt = torch.float64 if args.double else torch.float32
        net = state.fields["k_net"]
        net.weights = [torch.tensor(w, dtype=dt, device=problem.domain.device) for w in init["weights"]]
        net.biases = [torch.tensor(b, dtype=dt, device=problem.domain.device) for b in init["biases"]]
        return problem, state

    heat_cli.make_problem = make_problem
    try:
        what = "heat case 2n CLI (64^2 fp32, Newton, from the JAX package's initial net and case 0's checkpoint)"
        rows = run("heat2n", what, ["--ref_path", ref_path])
    finally:
        heat_cli.make_problem = orig
        os.remove(ref_path)
    want = jax_rows("heat2n")
    loss_col = data["heat2n"]["columns"].index("loss") + 1
    rows_gate(rows, want, data["heat2n"]["columns"], what + ", epoch 0", tag, 1e-5, floor=False, only=(0,))
    nan_got = [r[0] for r in rows if any(v != v for v in r[1:])]
    nan_want = [r[0] for r in want if any(v != v for v in r[1:])]
    print(f"heat case 2n: epoch 1 loss {rows[1][loss_col]!r} (JAX package {want[1][loss_col]!r}); NaN rows at "
          f"epochs {nan_got[:3]}...{nan_got[-1:]} (JAX package {nan_want[:3]}...{nan_want[-1:]}) {tag}")
    if nan_got != nan_want:
        fail(f"heat case 2n: NaN rows at {nan_got}, the JAX package's at {nan_want}")

    # veltracer gn, 64^3 (multigrid fields: the Jacobi-preconditioned CG,
    # its probes the port's own): fp32, epoch 0 within 1e-5, the rows
    # printed beside the JAX package's and not gated (a zero Hutchinson
    # entry's inverse, 1e30, overflows fp32 in the CG's dot products: a zero
    # step or NaN by the probes, in either package); fp64, epoch 0 within
    # 1e-5 and the last row's loss within the band of three JAX seeds.
    what = "veltracer gn CLI (64^3 fp32, Jacobi CG, 10 iterations)"
    rows = run("vt_gn", what)
    vcol = data["vt_gn"]["columns"].index("loss") + 1
    rows_gate(rows, jax_rows("vt_gn"), data["vt_gn"]["columns"], what + ", epoch 0", tag, 1e-5, floor=False,
              only=(0,))
    print(f"{what}: loss by epoch {[r[vcol] for r in rows]} (JAX package, seed 1000: "
          f"{[r[vcol] for r in jax_rows('vt_gn')]}) {tag}")
    what = "veltracer gn CLI (64^3 fp64, Jacobi CG, 10 iterations)"
    rows = run("vt_gn64", what)
    rows_gate(rows, jax_rows("vt_gn64"), data["vt_gn64"]["columns"], what + ", epoch 0", tag, 1e-5, floor=False,
              only=(0,))
    finals = [seed_rows[-1][vcol] for seed_rows in data["vt_gn64"]["seeds"].values()]
    band = (min(finals), max(finals))
    print(f"{what}: loss by epoch {[r[vcol] for r in rows]}; last {rows[-1][vcol]!r}, the JAX package's three seeds "
          f"{finals} (band {band}) {tag}")
    if not band[0] <= rows[-1][vcol] <= band[1]:
        fail(f"{what}: last loss {rows[-1][vcol]} outside {band}")


def autograd_loss_grad_fn(torch, problem, state, halo=False):
    """The plain route's training step: autograd of make_loss_fn (per shard
    with the halo exchange when `halo`)."""
    loss_fn, _ = problem.make_loss_fn(state, halo=halo)

    def fn(arrays, tracers):
        x = [a.detach().requires_grad_(True) for a in arrays]
        loss, aux = loss_fn(x, tracers)
        return (loss.detach(), aux), torch.autograd.grad(loss, x)

    return fn


def halo_metas(size):
    """Per shard of the t:2,x:2 mesh at `size` = (nt, nx, ny) cells: the
    masked generic block's row offset and own rows, and the local mg block's
    first global column x0, first global row g0 and own rows, as halo.py
    derives them for velocity_from_tracer (hist = halox = 1; the generic
    block is (nt/2 + 2, nx/2 + 2, ny), the mg block (nt/2 + 1, nx/2 + 2, ny))."""
    nt, nx, _ = size
    B, XB = nt // 2, nx // 2
    return [
        dict(shard=(i_t, i_x), off=i_t * B - 1, r_lo=1 + (i_t > 0), r_hi=B + 2, x0=i_x * XB - 1, g0=i_t * B,
             mg_r_lo=int(i_t > 0), xs=i_x * XB)
        for i_t in range(2) for i_x in range(2)
    ]


def halo_inputs(torch, rw, rmg, model, consts, size, rand, dev):
    """Seeded random per-shard kernel inputs at the shapes of the t:2,x:2
    shards of `size`, for each shard: (its meta, the masked generic model,
    blocks and const planes; the local mg model, t0 blocks, coarse window,
    heads)."""
    nt, nx, ny = size
    B, XB = nt // 2, nx // 2
    mask = torch.ones((XB + 2, ny), device=dev)
    mask[0] = 0
    mask[-1] = 0
    out = []
    for meta in halo_metas(size):
        cs = tuple(torch.nn.functional.pad(c[meta["xs"] : meta["xs"] + XB], (0, 0, 1, 1)) for c in consts)
        hm = rw.halo_model(model, mask, meta["off"], nt + 1, meta["r_lo"], meta["r_hi"])
        fs = tuple(rand(B + 2, XB + 2, ny) for _ in range(3))
        mm = rw.halo_model(model, mask, meta["g0"], nt + 1, meta["mg_r_lo"], B + 1)
        t0 = tuple(rand(B + 1, XB + 2, ny) for _ in range(3))
        P = tuple(rand(B // 2 + 1, nx // 2, ny // 2) for _ in range(3))
        heads = tuple(rand(1, XB + 2, ny) for _ in range(3))
        out.append((meta, hm, fs, cs, mm, t0, P, heads))
    return mask, out


def streaming(problem):
    """The problem with every ``ctx.rowwise_terms`` call of its operator
    streaming (``stream=True``)."""
    base = problem.operator

    def operator(ctx):
        call = ctx.rowwise_terms
        ctx.rowwise_terms = lambda *a, **k: call(*a, **dict(k, stream=True))
        return base(ctx)

    problem.operator = operator
    return problem


def same_bits(torch, first, again):
    """Whether two calls' outputs (nested tuples of tensors or None) are
    bitwise equal."""
    flat = lambda xs: [t for x in xs for t in (flat(x) if isinstance(x, (tuple, list)) else [x]) if t is not None]
    return all(torch.equal(a, b) for a, b in zip(flat(first), flat(again)))


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


def rows1d_unchanged(builds, tag):
    """The forms of rows1d_kernel without the halo layer against
    ROWS1D_PINNED: their SASS instructions (where the toolkit has cuobjdump)
    and registers, so that the layer is seen to leave them as they were."""
    path, _, log = builds["rowwise"]
    sass = sass_counts(path)
    regs = ptxas_registers(log, "rows1d_kernel")
    got = {}
    for model, mode in ROWS1D_PINNED:
        r = [v for k, v in regs.items() if f"{model}ELi{mode}ELb0E" in k]
        got[(model, mode)] = (sass.get(f"rows1d::rows1d_kernel<rows1d::{model}, {mode}, 0>"), r[0] if len(r) == 1 else None)
    print("rows1d_kernel without the halo layer, (SASS instructions, registers) against the build before the layer: "
          + ", ".join(f"{m} mode {k} {got[(m, k)]} (pinned {w})" for (m, k), w in ROWS1D_PINNED.items())
          + ("" if sass else " (no cuobjdump: registers only)") + f" {tag}")
    bad = [key for key, want in ROWS1D_PINNED.items() if got[key][1] != want[1] or (sass and got[key][0] != want[0])]
    if bad:
        fail(f"the rows1d_kernel forms {bad} without the halo layer changed: {got}, pinned {ROWS1D_PINNED}")


def shard_records(torch, np, th, tw, heat_ref, which, T, N, dev, seed=14):
    """The recorded per-shard kernel calls (``halo._run_operators``) of heat
    (the converged lane's configuration) or wave (fp32) at (T, N) on the mesh
    t:4 of four shards of `dev`, at a seeded random state."""
    from odil_torch import halo, parallel

    mesh = parallel.mesh_from_spec(HALO1D_SPEC, devices=[dev] * HALO1D_SHARDS)
    lane = heat_ref["config"]
    if which == "heat":
        p, s, _ = th.build(nt=T, nx=N, infer_k=True, imposed=lane["imposed"], nimp=lane["nimp"], seed=lane["seed"],
                           kernel="pallas", device=dev, mesh=mesh, partition=HALO1D_PART)
    else:
        p, s, _ = tw.build(nt=T, nx=N, dtype=np.float32, kernel="pallas", device=dev, mesh=mesh, partition=HALO1D_PART)
    rng = np.random.default_rng(seed)
    arrays = [torch.as_tensor((0.3 * rng.normal(size=tuple(a.shape))).astype(np.float32), device=dev)
              for a in p.domain.arrays_from_state(s)]
    plan = halo._HaloPlan(p, s)
    grid, params = halo._localize(p, plan, halo._mg_metas(p, s, plan), arrays)
    results = halo._run_operators(p, plan, halo._extended(plan, grid), params, p.tracers)
    return [r for ctx, _ in results for r in ctx.rowwise_deferred]


def roundoff_spread(torch, th, heat_ref, dev, base, epochs):
    """The spread that roundoff alone opens in heat's trajectory: e.'s hand
    loop (unsharded, from its initial net) with every gradient entry moved
    one ulp up or down (a coin of the seed's generator for each entry and
    epoch) every epoch, the size of the change a sum in another order
    makes.  The largest relative distance of its losses from the unsharded
    CLI's rows `base` ({epoch: loss}, e.'s loop's to the bit) over
    ROUNDOFF_SEEDS and the rows after epoch 0, and {seed: (that distance,
    its epoch)}."""
    from odil_torch.optim import Adam

    lane = heat_ref["config"]
    worst = {}
    for seed in ROUNDOFF_SEEDS:
        problem, state, _ = th.build(nt=lane["nt"], nx=lane["nx"], infer_k=True, imposed=lane["imposed"],
                                     nimp=lane["nimp"], seed=lane["seed"], kernel="pallas", device=dev)
        net = state.fields["k_net"]
        net.weights = [torch.tensor(w, dtype=torch.float32, device=dev) for w in heat_ref["weights"]]
        net.biases = [torch.tensor(b, dtype=torch.float32, device=dev) for b in heat_ref["biases"]]
        grad_fn, gen = problem.make_loss_grad_fn(state), torch.Generator(device=dev).manual_seed(seed)

        def moved(arrays, tracers, grad_fn=grad_fn, gen=gen):
            out, grads = grad_fn(arrays, tracers)
            return out, [torch.where(torch.rand(g.shape, generator=gen, device=g.device) < 0.5,
                                     torch.nextafter(g, torch.full_like(g, float("inf"))),
                                     torch.nextafter(g, torch.full_like(g, -float("inf")))) for g in grads]

        _, losses, _ = train(torch, Adam, moved, problem.domain.arrays_from_state(state), epochs, lr=1e-3)
        rel = {e: abs(losses[e - 1] - base[e]) / abs(base[e]) for e in base if e > 0}
        e = max(rel, key=rel.get)
        worst[seed] = (rel[e], e)
    return max(r for r, _ in worst.values()), worst


def halo1d_phase(torch, np, counters, heat_ref, vt_rows, vt_ms, vt_epochs, report, plain_big, tag, extra_argv=()):
    """Phase p (the module docstring): the per-shard 1-D kernels against their
    plain versions, heat and wave under --halo, the plot epochs, the
    asynchronous checkpoints and compare.py.  `vt_rows`/`vt_ms`: phase m's
    veltracer CLI rows and ms/epoch; `plain_big`: {which: the plain
    operator's loss at 1024^2 on the initial state} of phases f and g.
    Returns the launches of the per-shard 1-D kernels on their paths and
    their timing cases at shard 1 of each size, {"<which>_<size>": (model,
    nterms, hist, fields, params, data, consts)}."""
    import contextlib
    import io
    import pickle

    from odil_torch import parallel
    from odil_torch.checkpoint import AsyncCheckpointer, checkpoint_load
    from odil_torch.examples import compare
    from odil_torch.examples import heat as heat_cli
    from odil_torch.examples import veltracer as vt_cli
    from odil_torch.examples import wave as wave_cli
    from odil_torch.models import heat as th
    from odil_torch.models import wave as tw
    from odil_torch.ops import rowwise as rw
    from odil_torch.optim import Adam

    dev = torch.device(DEVICE)
    none = dict.fromkeys(counters.read(), 0)
    launches, cases = {}, {}
    shards = HALO1D_SHARDS

    # The per-shard kernels on every shard of the 64^2 and 1024^2 t:4 grids.
    for which in ("heat", "wave"):
        for size, (T, N) in SIZES_1D.items():
            recs = shard_records(torch, np, th, tw, heat_ref, which, T, N, dev)
            errs = {"f": 0.0, "s": 0.0, "g": 0.0, "g2": 0.0}
            worst = (0.0, 0.0, -1.0)
            for i, r in enumerate(recs):
                m, nt_, h = r["row_fn"], r["nterms"], r["hist"]
                a = [tuple(x.detach().contiguous() for x in r[k]) for k in ("fields", "params", "data", "consts")]
                a64 = [tuple(x.double() for x in t) for t in a]
                gs = torch.full((nt_,), 1.0 / a[0][0].numel(), device=dev)
                kf = rw.forward_halo_rows1d_cuda(m, nt_, h, *a)
                kd, kp, ks = rw.backward_halo_rows1d_cuda(m, nt_, h, *a, gs, True)
                kd2, kp2, _ = rw.backward_halo_rows1d_cuda(m, nt_, h, *a, gs, False)
                again = (rw.forward_halo_rows1d_cuda(m, nt_, h, *a), rw.backward_halo_rows1d_cuda(m, nt_, h, *a, gs, True),
                         rw.backward_halo_rows1d_cuda(m, nt_, h, *a, gs, False))
                pd, pp, _ = rw._backward_plain(m, nt_, h, *a, gs, True)
                wf = rw._forward_plain(m, nt_, h, *a64)
                wd, wp, ws = rw._backward_plain(m, nt_, h, *a64, gs.double(), True)
                torch.cuda.synchronize()
                e_f, ok_f = close(kf.double(), wf, TERMS_RTOL, 0.0)
                e_s, ok_s = close(ks.double(), ws, TERMS_RTOL, 0.0)
                e_g, ok_g, w1 = close_floor(list(kd) + list(kp), list(pd) + list(pp), list(wd) + list(wp))
                e_g2, ok_g2, w2 = close_floor(list(kd2) + list(kp2), list(pd) + list(pp), list(wd) + list(wp))
                bits = same_bits(torch, (kf, (kd, kp, ks), (kd2, kp2)), again)
                if not (ok_f and ok_s and ok_g and ok_g2 and bits):
                    fail(f"a per-shard {which} kernel disagrees with its plain version at shard {i} of "
                         f"{tuple(a[0][0].shape)}: forward {ok_f}, sums {ok_s}, backward+sums {ok_g}, backward "
                         f"{ok_g2}, the same bits again {bits}")
                errs = {"f": max(errs["f"], e_f), "s": max(errs["s"], e_s), "g": max(errs["g"], e_g),
                        "g2": max(errs["g2"], e_g2)}
                worst = max(worst, w1, w2, key=lambda w: w[2])
                if i == 1:
                    cases[f"{which}_{size}"] = (m, nt_, h) + tuple(a)
            print(f"per-shard {which} kernels on the {shards} shards of {T}x{N} (t:4, blocks "
                  f"{tuple(recs[1]['fields'][0].shape)}): forward max|d sums| {errs['f']:.3e}, backward+sums max|d sums| "
                  f"{errs['s']:.3e} max|d (dfields, dparams)| {errs['g']:.3e}, backward {errs['g2']:.3e}, against the "
                  f"fp64 plain version with the fp32 floor ({worst_text(worst)}); the same bits again {tag}")
            key = f"{which}_{size}"
            report[f"forward_halo_rows1d_{key}"] = errs["f"]
            report[f"backward_halo_rows1d_sums_{key}"] = errs["g"]
            report[f"backward_halo_rows1d_{key}"] = errs["g2"]

    # Heat and wave under --halo against their unsharded CLIs; the unsharded
    # runs also check the plot epochs' data against pickle checkpoints of
    # the same epochs.
    lane = heat_ref["config"]
    orig = heat_cli.make_problem

    def make_problem(args):
        problem, state = orig(args)
        dtype = torch.float64 if args.double else torch.float32
        net = state.fields["k_net"]
        net.weights = [torch.tensor(w, dtype=dtype, device=problem.domain.device) for w in heat_ref["weights"]]
        net.biases = [torch.tensor(b, dtype=dtype, device=problem.domain.device) for b in heat_ref["biases"]]
        return problem, state

    runs = {
        "heat": (heat_cli, HEAT_EPOCHS, [
            "--Nt", str(lane["nt"]), "--Nx", str(lane["nx"]), "--infer_k", "1", "--imposed", lane["imposed"],
            "--nimp", str(lane["nimp"]), "--seed", str(lane["seed"]), "--kernel", "pallas"]),
        "wave": (wave_cli, HALO1D_WAVE_EPOCHS, [
            "--Nt", str(SIZES_1D["64"][0]), "--Nx", str(SIZES_1D["64"][1]), "--kernel", "pallas", "--double", "0",
            "--optimizer", "adam", "--lr", "0.001"]),
    }
    heat_cli.make_problem = make_problem
    try:
        for which, (cli, epochs, argv) in runs.items():
            argv = argv + ["--epochs", str(epochs), "--history_every", str(HALO1D_EVERY[which]), "--report_every",
                           str(HALO1D_EVERY[which])] + list(extra_argv)
            every = epochs // 2
            drawn = {}

            def keep(out, cli=cli, which=which, every=every, argv=argv):
                """The plot epochs' data_*.pickle against a pickle checkpoint of
                the same epoch: the JAX example's keys, state_u the field."""
                cwd = os.getcwd()
                os.chdir(out)
                try:
                    files = sorted(os.listdir(out))
                    data = [f for f in files if f.startswith("data_")]
                    drawn["figures"] = [f for f in files if f.endswith(".png")]
                    if len(data) != 3:
                        fail(f"{which} CLI: plot epochs wrote {data}, expected three data_*.pickle")
                    args = cli.parse_args(argv + ["--outdir", out])
                    for name in data:
                        epoch = int(name[5:10]) * every
                        with open(name, "rb") as f:
                            payload = pickle.load(f)
                        if sorted(payload) != PLOT_KEYS[which]:
                            fail(f"{which} CLI: {name} has the keys {sorted(payload)}, the JAX example's "
                                 f"{PLOT_KEYS[which]}")
                        problem, state = cli.make_problem(args)
                        checkpoint_load(problem.domain, state, f"checkpoint_{epoch:06d}.pickle")
                        u = problem.domain.mod.numpy(problem.domain.field(state, "u"))
                        if not np.array_equal(u, payload["state_u"]):
                            fail(f"{which} CLI: {name}'s state_u is not the field of checkpoint_{epoch:06d}.pickle")
                finally:
                    os.chdir(cwd)

            rows, log, counts, *_ = run_cli(torch, counters, which, argv + [
                "--plot_every", str(every), "--frames", "3", "--dump_data", "1", "--checkpoint_every", str(every)],
                keep=keep)
            want = dict(none, backward_rows=epochs + 1, forward_rows=1)
            expect_counts(counts, want, f"{which} CLI (64^2, unsharded)")
            print(f"{which} CLI plot epochs (every {every}): three data_*.pickle with the JAX example's keys, state_u "
                  f"equal to the field of the pickle checkpoint of its epoch; figures drawn: "
                  f"{drawn['figures'] or 'none (matplotlib does not import)'} {tag}")
            halo_argv = argv + ["--plot_every", "0", "--mesh", HALO1D_SPEC, "--halo", "1"]
            evaluated = {}

            def keep_halo(out, cli=cli, halo_argv=halo_argv):
                """The loss-only path under --halo at the CLI's initial state
                (the CLI's epoch-0 row is eval_loss_grad's, unsharded in
                both packages)."""
                cwd = os.getcwd()
                os.chdir(out)
                try:
                    problem, state = cli.make_problem(cli.parse_args(halo_argv + ["--outdir", out]))
                    counters.zero()
                    (loss, _), _ = autograd_loss_grad_fn(torch, problem, state, halo=True)(
                        problem.domain.arrays_from_state(state), problem.tracers)
                    torch.cuda.synchronize()
                    evaluated["loss"], evaluated["counts"] = float(loss), counters.read()
                finally:
                    os.chdir(cwd)

            halo_rows, halo_log, counts, *_ = run_cli(torch, counters, which, halo_argv, keep=keep_halo)
            expect_counts(counts, dict(none, backward_halo_rows1d=shards * epochs, backward_rows=1, forward_rows=1),
                          f"{which} CLI (64^2, --mesh {HALO1D_SPEC} --halo 1)")
            expect_counts(evaluated["counts"], dict(none, backward_halo_rows1d=shards, forward_halo_rows1d=shards),
                          f"{which} 64^2 loss-only path under --halo")
            launches[f"backward_halo_rows1d_sums_{which}_64"] = shards * epochs
            launches[f"backward_halo_rows1d_{which}_64"] = shards
            launches[f"forward_halo_rows1d_{which}_64"] = shards
            base = {int(r["epoch"]): float(r["loss"]) for r in rows}
            got = {int(r["epoch"]): float(r["loss"]) for r in halo_rows}
            if sorted(got) != sorted(base):
                fail(f"{which} CLI under --halo: rows at epochs {sorted(got)}, unsharded {sorted(base)}")
            rel = {e: abs(got[e] - base[e]) / abs(base[e]) for e in base}
            rel[0] = max(rel[0], abs(evaluated["loss"] - base[0]) / abs(base[0]))
            worst = max((e for e in rel if e > 0), key=rel.get)
            if which == "heat":
                spread, seeds = roundoff_spread(torch, th, heat_ref, dev, base, epochs)
                limit = 2 * spread
                print(f"heat's spread from roundoff alone (e.'s hand loop, unsharded, with every gradient entry one "
                      f"ulp up or down every epoch), the worst row's relative distance from the unsharded CLI's and "
                      f"its epoch by seed: " + ", ".join(f"{k}: {100 * r:.4f}% at {e}" for k, (r, e) in seeds.items())
                      + f" {tag}")
            else:
                limit = 0.01
            print(f"{which} CLI under --mesh {HALO1D_SPEC} --halo 1 ({epochs} epochs, Adam lr 0.001, fp32): epoch-0 "
                  f"loss {got[0]!r} (eval_loss_grad), the per-shard loss-only path's {evaluated['loss']!r}, vs the "
                  f"unsharded CLI's {base[0]!r} (rel {rel[0]:.2e}); worst {HALO1D_EVERY[which]}-epoch row epoch "
                  f"{worst} ({100 * rel[worst]:.4f}%, gated at {100 * limit:.4f}%); final "
                  f"{got[epochs]!r} vs {base[epochs]!r}; {log_ms(halo_log):.4f} ms/epoch against the unsharded CLI's "
                  f"{log_ms(log):.4f}; {shards} per-shard backward+sums an epoch; launches {counts}; the loss-only "
                  f"path's {evaluated['counts']} {tag}")
            if rel[0] > 1e-5 or rel[worst] > limit:
                fail(f"{which} CLI under --halo: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} "
                     f"{100 * rel[worst]:.4f}% from the unsharded CLI (limit {100 * limit:.4f}%)")
            if which == "heat":
                converged_gate(halo_rows, read_rows("ref_heat_seeds.csv"), HEAT_MARGINS,
                               f"heat CLI under --mesh {HALO1D_SPEC} --halo 1", tag, median=True, epochs=epochs)
    finally:
        heat_cli.make_problem = orig

    # Heat and wave at 1024^2 on t:4 (hand loops): epoch 0 against the plain
    # operator of phases f and g, and the loss-only path.
    mesh = parallel.mesh_from_spec(HALO1D_SPEC, devices=[dev] * shards)
    T, N = SIZES_1D["1024"]
    for which in ("heat", "wave"):
        if which == "heat":
            problem, state, _ = th.build(nt=T, nx=N, infer_k=True, imposed=lane["imposed"], nimp=lane["nimp"],
                                         seed=lane["seed"], kernel="pallas", device=dev, mesh=mesh,
                                         partition=HALO1D_PART)
        else:
            problem, state, _ = tw.build(nt=T, nx=N, dtype=np.float32, kernel="pallas", device=dev, mesh=mesh,
                                         partition=HALO1D_PART)
        grad = problem.make_loss_grad_fn(state, halo=True)
        if grad is None or grad.route != "generic":
            fail(f"{which} 1024^2 under --halo: the one-pass route is {getattr(grad, 'route', None)}, not generic")
        counters.zero()
        opt, losses, chunk_ms = train(torch, Adam, grad, problem.domain.arrays_from_state(state), HALO1D_BIG_EPOCHS,
                                      lr=1e-3)
        expect_counts(counters.read(), dict(none, backward_halo_rows1d=shards * len(losses)),
                      f"{which} 1024^2 training under --halo")
        rel0 = abs(losses[0] - plain_big[which]) / abs(plain_big[which])
        ms, _ = steady_ms(chunk_ms)
        counters.zero()
        autograd_loss_grad_fn(torch, problem, state, halo=True)(opt.x, problem.tracers)
        torch.cuda.synchronize()
        expect_counts(counters.read(), dict(none, backward_halo_rows1d=shards, forward_halo_rows1d=shards),
                      f"{which} 1024^2 loss-only path under --halo")
        print(f"training ({which} 1024^2, t:4 halo, pallas): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the "
              f"plain operator's {plain_big[which]!r} (rel {rel0:.2e}); final {losses[-1]!r}; {ms:.4f} ms/epoch {tag}")
        if rel0 > 1e-5:
            fail(f"{which} 1024^2 under --halo: epoch-0 loss {losses[0]} differs from the plain operator's "
                 f"{plain_big[which]} (limit 1e-5)")
        launches[f"backward_halo_rows1d_sums_{which}_1024"] = shards * len(losses)
        launches[f"backward_halo_rows1d_{which}_1024"] = shards
        launches[f"forward_halo_rows1d_{which}_1024"] = shards
        del opt, grad, problem, state

    # The veltracer CLI of phase m with asynchronous checkpoints.
    restored = {}
    vt_argv = ["--Nt", str(SIZES["256"][0]), "--Nx", str(SIZES["256"][1]), "--Ny", str(SIZES["256"][2]),
               "--kernel", "pallas_mg", "--epochs", str(vt_epochs), "--history_every", str(CHUNK),
               "--report_every", str(100 if vt_epochs >= 300 else CHUNK), "--plot_every", "0",
               "--checkpoint_format", "orbax", "--checkpoint_every", str(CKPT_EVERY), *extra_argv]

    def keep_ckpt(out):
        """The steps on disk once the writer has finished the last, the last
        restored into a fresh state, and a checkpointer with max_to_keep=2."""
        ckpt = AsyncCheckpointer(os.path.join(out, "checkpoint_orbax"))
        t0 = time.perf_counter()
        while ckpt.latest_step() != vt_epochs and time.perf_counter() - t0 < 120:
            time.sleep(0.05)
        steps = sorted(int(n) for n in os.listdir(ckpt.directory))
        restored["steps"], restored["wait"] = steps, time.perf_counter() - t0
        args = vt_cli.parse_args(vt_argv + ["--outdir", out])
        args.Nt, args.Ny = args.Nt or args.Nx, args.Ny or args.Nx
        problem, fresh = vt_cli.make_problem(args)
        slots = ckpt.restore(problem.domain, fresh)
        restored["arrays"] = [a.clone() for a in problem.domain.arrays_from_state(fresh)]
        restored["slots"] = sorted(slots) if slots else None
        two = AsyncCheckpointer(os.path.join(out, "keep2"), max_to_keep=2)
        for step in (1, 2, 3):
            two.save(problem.domain, fresh, step)
        two.close()
        restored["keep2"] = sorted(os.listdir(two.directory))
        ckpt.close()

    rows, log, counts, (problem, state), _ = run_cli(torch, counters, "veltracer", vt_argv, keep=keep_ckpt)
    values = lambda rs: [{k: v for k, v in r.items() if k not in NOT_VALUES or k in ("epoch", "frame")} for r in rs]
    same_rows = values(rows) == values(vt_rows)
    final = problem.domain.arrays_from_state(state)
    same_state = len(final) == len(restored["arrays"]) and all(
        torch.equal(a, b) for a, b in zip(final, restored["arrays"]))
    want_steps = list(range(0, vt_epochs + 1, CKPT_EVERY))
    print(f"veltracer CLI with --checkpoint_format orbax --checkpoint_every {CKPT_EVERY} ({vt_epochs} epochs): "
          f"train.csv rows equal to phase m's to the bit: {same_rows}; steps on disk {restored['steps']} (the last "
          f"whole {restored['wait']:.2f} s after the run); the last restored into a fresh state equal to the run's "
          f"final fields to the bit: {same_state}, slots {restored['slots']}; max_to_keep=2 left {restored['keep2']}; "
          f"{log_ms(log):.4f} ms/epoch against phase m's {vt_ms:.4f} (not gated); launches {counts} {tag}")
    if not (same_rows and same_state and restored["steps"] == want_steps and restored["keep2"] == ["2", "3"]
            and restored["slots"] == ["m", "step", "v"]):
        fail("the veltracer CLI's asynchronous checkpoints: rows, steps, restore or max_to_keep differ (above)")

    # Where a heat epoch under --halo spends its time: a hand loop at 64^2
    # on t:4, its ms/epoch beside the unsharded loop's, then the host's
    # operators and the card's kernels of a few epochs (torch.profiler).
    loops = {}
    for spec in (None, HALO1D_SPEC):
        mesh_ = parallel.mesh_from_spec(spec, devices=[dev] * shards) if spec else None
        problem, state, _ = th.build(nt=lane["nt"], nx=lane["nx"], infer_k=True, imposed=lane["imposed"],
                                     nimp=lane["nimp"], seed=lane["seed"], kernel="pallas", device=dev, mesh=mesh_,
                                     partition=HALO1D_PART if spec else None)
        grad = problem.make_loss_grad_fn(state, halo=bool(spec))
        opt, losses, chunk_ms = train(torch, Adam, grad, problem.domain.arrays_from_state(state), 100, lr=1e-3)
        loops[spec] = (opt, steady_ms(chunk_ms)[0])
    print(f"heat 64^2 hand loop: {loops[HALO1D_SPEC][1]:.4f} ms/epoch on t:4 (--halo) against {loops[None][1]:.4f} "
          f"unsharded {tag}")
    host_profile(torch, loops[HALO1D_SPEC][0], f"(heat 64 halo t:4) {tag}")

    # compare.py on the card.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        compare.main(["--device", str(dev)])
    text = out.getvalue()
    print("compare.py --device " + str(dev) + ": " + "; ".join(text.strip().splitlines()) + f" {tag}")
    if text.strip().splitlines()[-1] != "PASS":
        fail("compare.py did not print PASS")
    return launches, cases


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=400, help="Flagship training epochs (multiple of 10)")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the random kernel inputs")
    args = parser.parse_args()
    t_main = time.perf_counter()

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
    builds = build_all(_build)
    rows1d_unchanged(builds, tag)
    rmg._library()
    rw._library()
    counters = Counters(rmg, rw)

    # -- Phase 2: kernels vs plain versions -------------------------------------
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    report = {}  # kernel name -> max abs error against its plain version
    off_path = {}  # the same for the variants that no path runs (see the docstring)

    def check_stream(key, m, nt_, h, fs, ps, ds, cs, gs, pf, pgrads, psums, slabbed_out):
        """The streaming kernels at one case against the plain versions
        already computed there for the slabbed ones (pf: sums; pgrads:
        dfields and dparams; psums: the backward's sums), their bits call
        after call, and the slabbed launch's bits (slabbed_out: its forward,
        backward+sums and backward): on the card they are one launch."""
        calls = (
            lambda: rw.forward_stream_cuda(m, nt_, h, fs, ps, ds, cs),
            lambda: rw.backward_stream_cuda(m, nt_, h, fs, ps, ds, cs, gs, True),
            lambda: rw.backward_stream_cuda(m, nt_, h, fs, ps, ds, cs, gs, False),
        )
        kf, (kd, kp, ks), (kd2, kp2, _) = first = [c() for c in calls]
        again = [c() for c in calls]
        torch.cuda.synchronize()
        bits = same_bits(torch, first, again) and same_bits(torch, first, slabbed_out)
        e_f, ok_f = close(kf.double(), pf.double(), TERMS_RTOL, 0.0)
        e_s, ok_s = close(ks.double(), psums.double(), TERMS_RTOL, 0.0)
        e_g, ok_g = close_all([a.double() for a in kd + kp], [b.double() for b in pgrads])
        e_g2, ok_g2 = close_all([a.double() for a in kd2 + kp2], [b.double() for b in pgrads])
        print(f"stream kernels at {tuple(fs[0].shape)} ({key}): forward max|d sums| {e_f:.3e} (rel "
              f"{rel_err(kf, pf):.2e}), backward max|d grads| {e_g2:.3e}, backward+sums max|d sums| {e_s:.3e} "
              f"max|d grads| {e_g:.3e}; the same bits call after call and as the slabbed launch: {bits} {tag}")
        if not (ok_f and ok_s and ok_g and ok_g2 and bits):
            fail(f"a streaming kernel disagrees with its plain version or its own bits at {key}: forward {ok_f}, "
                 f"sums {ok_s}, backward+sums {ok_g}, backward {ok_g2}, bits {bits}")
        report[f"forward_stream_{key}"] = e_f
        report[f"backward_stream_{key}"] = e_g2
        off_path[f"backward_stream_sums_{key}"] = e_g
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

    # The two-level backward at the flagship shapes: t1 (33,128,128), P2
    # (17,64,64), against the plain lvl2 backward with the split of dP1.
    t1s = tuple(rand(Tc, X // 2, Y // 2) for _ in range(3))
    P2s = tuple(rand(Tc // 2 + 1, X // 4, Y // 4) for _ in range(3))
    f1s = (1.0, 1.0, 1.0)
    W1x, W1y = rmg._interp_matrices(X // 4, Y // 4, torch.float32, dev)

    def lvl2_plain(with_sums):
        d0, dP1, sums = rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, P2s, consts, g, with_sums, lvl2=(t1s, f1s))
        return (d0,) + rmg._split_dp1(dP1, f1s, W1x, W1y) + (sums,)

    for with_sums, name in ((True, "backward_mg2_sums"), (False, "backward_mg2")):
        call = lambda: rmg.backward_mg2_cuda(model, nterms, 1, f0s, f1s, t0s, t1s, P2s, consts, g, with_sums)
        k, k2, p = call(), call(), lvl2_plain(with_sums)
        torch.cuda.synchronize()
        bits = same_bits(torch, k, k2)
        e_g, ok_g = close_all(k[0] + k[1] + k[2], p[0] + p[1] + p[2])
        e_s, ok_s = close(k[3].double(), p[3].double(), TERMS_RTOL, 0.0) if with_sums else (0.0, True)
        print(f"two-level backward{'+sums' if with_sums else ''}: max|d sums| {e_s:.3e}, max|d(dt0,dt1,dP2)| "
              f"{e_g:.3e}; the same bits call after call: {bits} {tag}")
        if not (ok_g and ok_s and bits):
            fail(f"the two-level backward{'+sums' if with_sums else ''} disagrees with its plain version or its own "
                 f"bits (grads {ok_g}, sums {ok_s}, bits {bits})")
        (report if with_sums else off_path)[name] = e_g
        del k, k2, p

    # The per-shard kernels at the shapes of the flagship's t:2,x:2 shards,
    # each shard's meta; the local mg backward also at a 512^2 shard (the
    # shapes where the TPU takes its local-tiled kernel).
    hmask, halo_cases = halo_inputs(torch, rw, rmg, model, consts, SIZES["256"], rand, dev)
    errs = {"forward_halo": 0.0, "backward_halo_sums": 0.0, "backward_halo": 0.0, "backward_mg_local_sums": 0.0}
    for meta, hm, hfs, hcs, mm, mt0, mP, mh in halo_cases:
        calls = (
            lambda: rw.forward_halo_cuda(hm, nterms, 1, hfs, (), (), hcs),
            lambda: rw.backward_halo_cuda(hm, nterms, 1, hfs, (), (), hcs, g, True),
            lambda: rw.backward_halo_cuda(hm, nterms, 1, hfs, (), (), hcs, g, False),
            lambda: rmg.backward_mg_local_cuda(mm, nterms, 1, f0s, mt0, mP, mh, meta["x0"], hcs, g),
        )
        first = [c() for c in calls]
        again = [c() for c in calls]
        kf, (kd, _, ks), (kd2, _, _), km = first
        pf = rw._forward_plain(hm, nterms, 1, hfs, (), (), hcs)
        pd, _, ps = rw._backward_plain(hm, nterms, 1, hfs, (), (), hcs, g, True)
        pm = rmg._backward_mg_local_plain(mm, nterms, 1, f0s, mt0, mP, mh, meta["x0"], hcs, g)
        wide = lambda ts: tuple(t.double() for t in ts)
        hm64 = rw.halo_model(hm.inner, hmask.double(), *hm.halo[1:])
        mm64 = rw.halo_model(mm.inner, hmask.double(), *mm.halo[1:])
        qd, _, _ = rw._backward_plain(hm64, nterms, 1, wide(hfs), (), (), wide(hcs), g.double(), False)
        qm = rmg._backward_mg_local_plain(mm64, nterms, 1, f0s, wide(mt0), wide(mP), wide(mh), meta["x0"], wide(hcs),
                                          g.double())
        torch.cuda.synchronize()
        bits = same_bits(torch, first, again)
        checks = {
            "forward_halo": close(kf.double(), pf.double(), TERMS_RTOL, 0.0),
            "backward_halo_sums": close_floor(kd, pd, qd),
            "backward_halo": close_floor(kd2, pd, qd),
            "backward_mg_local_sums": close_floor(km[0] + km[1] + km[2], pm[0] + pm[1] + pm[2], qm[0] + qm[1] + qm[2]),
        }
        e_s, ok_s = close(ks.double(), ps.double(), TERMS_RTOL, 0.0)
        e_ms, ok_ms = close(km[3].double(), pm[3].double(), TERMS_RTOL, 0.0)
        print(f"per-shard kernels, shard {meta['shard']} (row offset {meta['off']}, own rows {meta['r_lo']}.."
              f"{meta['r_hi'] - 1}, x0 {meta['x0']}): masked forward max|d sums| {checks['forward_halo'][0]:.3e}, "
              f"backward+sums max|d sums| {e_s:.3e} max|d dfields| {checks['backward_halo_sums'][0]:.3e}, backward "
              f"{checks['backward_halo'][0]:.3e}; local mg backward max|d sums| {e_ms:.3e} max|d (dt0, dP, dheads)| "
              f"{checks['backward_mg_local_sums'][0]:.3e}; the same bits call after call: {bits} {tag}")
        for k in ("backward_halo_sums", "backward_halo", "backward_mg_local_sums"):
            print(f"  {k} at shard {meta['shard']}: {worst_text(checks[k][2])}")
        if not (all(c[1] for c in checks.values()) and ok_s and ok_ms and bits):
            fail(f"a per-shard kernel disagrees with its plain version or its own bits at shard {meta['shard']}: "
                 f"{ {k: c[1] for k, c in checks.items()} }, sums {ok_s}/{ok_ms}, bits {bits}")
        for k, (e, *_) in checks.items():
            errs[k] = max(errs[k], e)
        del first, again, pd, pm, qd, qm
    report.update(errs)
    _, cases512 = halo_inputs(torch, rw, rmg, row_model("512")[0], row_model("512")[2], SIZES["512"], rand, dev)
    meta, _, _, hcs512, mm512, mt512, mP512, mh512 = cases512[3]
    x0_512 = meta["x0"]
    g512h = torch.full((nterms,), 1.0 / ((SIZES["512"][0] + 1) * SIZES["512"][1] * SIZES["512"][2]), device=dev)
    k = rmg.backward_mg_local_cuda(mm512, nterms, 1, f0s, mt512, mP512, mh512, meta["x0"], hcs512, g512h)
    p = rmg._backward_mg_local_plain(mm512, nterms, 1, f0s, mt512, mP512, mh512, meta["x0"], hcs512, g512h)
    wide = lambda ts: tuple(t.double() for t in ts)
    q = rmg._backward_mg_local_plain(rw.halo_model(mm512.inner, mm512.halo[0].double(), *mm512.halo[1:]), nterms, 1,
                                     f0s, wide(mt512), wide(mP512), wide(mh512), meta["x0"], wide(hcs512),
                                     g512h.double())
    torch.cuda.synchronize()
    e_g, ok_g, w_g = close_floor(k[0] + k[1] + k[2], p[0] + p[1] + p[2], q[0] + q[1] + q[2])
    e_s, ok_s = close(k[3].double(), p[3].double(), TERMS_RTOL, 0.0)
    print(f"local mg backward at {tuple(mt512[0].shape)}, shard {meta['shard']}: max|d sums| {e_s:.3e}, "
          f"max|d (dt0, dP, dheads)| {e_g:.3e}; {worst_text(w_g)} {tag}")
    if not (ok_g and ok_s):
        fail(f"the local mg backward disagrees with its plain version at {tuple(mt512[0].shape)}")
    report["backward_mg_local_sums_512"] = e_g
    del k, p, q, cases512

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

    # The mg backward's time by kernel name: the row walk, the dP pass or
    # gather, the sums (256^2, depth 2, a 256^2 shard and a 512^2 one).
    shard = halo_cases[3]
    mg_calls = {
        "backward_mg_sums": lambda: rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, True),
        "backward_mg": lambda: rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, False),
        "forward_mg": lambda: rmg.forward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts),
        "backward_mg_sums_512": lambda: rmg.backward_mg_cuda(model512, nterms512, 1, f0s, t0s512, coarse512,
                                                             consts512, g512, True),
        "backward_mg2_sums": lambda: rmg.backward_mg2_cuda(model, nterms, 1, f0s, f1s, t0s, t1s, P2s, consts, g,
                                                           True),
        "backward_mg_local_sums": lambda: rmg.backward_mg_local_cuda(shard[4], nterms, 1, f0s, shard[5], shard[6],
                                                                     shard[7], shard[0]["x0"], shard[3], g),
        "backward_mg_local_sums_512": lambda: rmg.backward_mg_local_cuda(mm512, nterms, 1, f0s, mt512, mP512,
                                                                         mh512, x0_512, hcs512, g512h),
    }

    def print_mg_splits():
        lib = rmg._library()
        for what, (T_, X_, Y_) in (("256^2", (NT + 1, X, Y)), ("512^2", tuple(t0s512[0].shape)),
                                   ("a 256^2 shard", (shard[5][0].shape[0] + 1, shard[5][0].shape[1] + 1,
                                                      shard[5][0].shape[2]))):
            slab = rmg._mg_slab(T_, X_, Y_, lib._odil_resident)
            grid = (-(-Y_ // lib.odil_mg_tile(1)), -(-X_ // lib.odil_mg_tile(0)), -(-T_ // slab))
            print(f"mg walk launch at {what}: {T_} walked rows in slabs of {slab}, grid {grid} = "
                  f"{grid[0] * grid[1] * grid[2]} blocks of 256 threads, {lib._odil_resident} resident at "
                  f"once {tag}")
        for name, fn in mg_calls.items():
            split = print_split(torch, fn, name, tag)
            if name != "backward_mg2_sums" and any(k.startswith("mg_coarse_grad_kernel") for k in split):
                fail(f"{name} launched a separate dP pass: {sorted(split)}")

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
        if size in ("256", "64"):
            check_stream(size, m, nt_, 1, fs, (), (), cs, gs, pf, pd, ps, [kf, (kd, (), ks), (kd2, (), None)])
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
                check_stream(f"{which}_{size}", m, nt_, h, fs, ps, ds, cs, gs, pf, list(pd) + list(pp), ps_,
                             [kf, (kd, kp, ks), (kd2, kp2, None)])
            del kd, kp, kd2, kp2, pd, pp

    # The row kernels' launch shapes: slabs sized to whole waves of the
    # resident blocks, the 1-D tiles taken by the blocks in rounds.
    row_cases = {size: (*row_model(size)[:2], 1, fields[size], (), (), row_model(size)[2]) for size in SIZES}
    _, shard_m, shard_fs, shard_cs = halo_cases[0][:4]
    row_cases["shard"] = (shard_m, nterms, 1, shard_fs, (), (), shard_cs)
    row_cases.update({f"{w}_{size}": c for (w, size), c in cases_1d.items()})
    # The veltracer row kernel's tile: ptxas's registers of each rows_kernel
    # form, the dynamic shared memory and the blocks an SM.
    tile = rw.row_tile()
    regs = ptxas_registers(builds["rowwise"][2], "rows_kernel")
    print(f"row kernel tile: {tile['rows']}x{tile['cols']} cells on {tile['threads'] // tile['cols']}x{tile['cols']} "
          f"threads ({tile['rows'] * tile['cols'] // tile['threads']} cells a thread), dynamic shared memory "
          f"{tile['smem']} B ({tile['smem_masked']} B masked), {tile['per_sm']} blocks an SM ({tile['per_sm_masked']} "
          f"masked); registers by form: " + ", ".join(f"{k} {v}" for k, v in sorted(regs.items())) + f" {tag}")
    for key, (m, nt_, h, fs, ps, ds, cs) in row_cases.items():
        shapes = []
        for what, grads, sums in (("forward", False, True), ("backward+sums", True, True), ("backward", True, False)):
            slab, tiles, blocks, resident = rw.launch_shape(m, fs, grads, sums)
            shapes.append(f"{what}: slabs of {slab} rows, {tiles} tiles, grid {blocks} blocks of 256 threads, "
                          f"{-(-tiles // resident)} wave(s) of {resident} resident")
        if m.cuda_model == "veltracer":
            X = fs[0].shape[1]
            idle = 1 - X / (-(-X // tile["rows"]) * tile["rows"])
            shapes.append(f"{tile['rows']}x{tile['cols']} tiles, {idle:.1%} of the threads own no cell at X = {X}")
        print(f"row kernel launches at {tuple(fs[0].shape)} ({key}): " + "; ".join(shapes) + f" {tag}")

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

    none = {name: 0 for name in counters.wrappers}

    # a. pallas_mg at 256^2 (the flagship's fused route).
    problem, state, _ = problems["256"]
    grad_mg = problem.make_loss_grad_fn(state)
    if grad_mg is None:
        fail("make_loss_grad_fn declined the flagship: the fused route did not apply")
    counters.zero()
    opt, losses, chunk_ms = train(torch, Adam, grad_mg, problem.domain.arrays_from_state(state), args.epochs)
    expect_counts(counters.read(), dict(none, backward_mg=len(losses)), "pallas_mg training at 256^2")
    launches["backward_mg_sums"] = counters.read()["backward_mg"]
    losses_unsharded = losses
    _, rel_depth1 = check_rows(losses, ref256, "training (pallas_mg)")
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
    heat_losses = losses
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
    plain_loss = heat_plain_big = zero_state_loss(*th.build(kernel="xla", **heat_big)[:2])
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
    plain_loss = wave_plain_big = zero_state_loss(*tw.build(kernel="xla", **wave_big)[:2])
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

    # h. The streaming pair, through autograd of the loss.
    def stream_path(problem, state, epochs, lr, what, keys):
        """Trains with autograd of the loss (make_loss_grad_fn must decline
        the streaming call); one stream forward and one stream backward an
        epoch and no other kernel."""
        if problem.make_loss_grad_fn(state) is not None:
            fail(f"{what}: make_loss_grad_fn took a streaming call")
        counters.zero()
        opt, losses, chunk_ms = train(torch, Adam, autograd_loss_grad_fn(torch, problem, state),
                                      problem.domain.arrays_from_state(state), epochs, lr=lr)
        n = len(losses)
        expect_counts(counters.read(), dict(none, forward_stream=n, backward_stream=n), what)
        for key in keys:
            launches[f"forward_stream_{key}"] = launches[f"backward_stream_{key}"] = n
        loops[what] = (opt, steady_ms(chunk_ms))
        return losses

    def against_route(losses, base, what, every=20):
        """Every `every`-epoch row within 1% of another route's losses,
        epoch 0 within 1e-5."""
        rel = {e: abs(losses[max(e - 1, 0)] - base[max(e - 1, 0)]) / abs(base[max(e - 1, 0)])
               for e in range(0, len(losses) + 1, every)}
        worst = max(rel, key=rel.get)
        print(f"{what}: epoch-0 loss {losses[0]!r} vs {base[0]!r} (rel {rel[0]:.2e}); worst {every}-epoch row epoch "
              f"{worst} ({100 * rel[worst]:.4f}%); final {losses[-1]!r} vs {base[len(losses) - 1]!r} {tag}")
        if rel[0] > 1e-5 or rel[worst] > 0.01:
            fail(f"{what}: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} {100 * rel[worst]:.3f}% (limit 1%)")

    def against_plain(losses, plain, what):
        rel0 = abs(losses[0] - plain) / abs(plain)
        print(f"{what}: {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain operator's {plain!r} "
              f"(rel {rel0:.2e}); final {losses[-1]!r} {tag}")
        if rel0 > 1e-5:
            fail(f"{what}: epoch-0 loss {losses[0]} differs from the plain operator's {plain} (limit 1e-5)")

    stream_op = lambda ctx: ctx.rowwise_terms(**vt._kernel_decl(ctx), stream=True)
    problem_s, state_s, _ = vt.build(*SIZES["256"], kernel="pallas", device=dev)
    problem_s.operator = stream_op
    losses = stream_path(problem_s, state_s, args.epochs, 0.01, "stream 256", ["256"])
    check_rows(losses, ref256, "training (stream, 256^2)")
    del problem_s, state_s
    problem_s, state_s, _ = vt.build(*SIZES["64"], kernel="pallas", device=dev)
    problem_s.operator = stream_op
    losses = stream_path(problem_s, state_s, STREAM_EPOCHS_64, 0.01, "stream 64", ["64"])
    check_rows(losses, ref64, "training (stream, 64^3)", gate_all=False, gated=(50,))
    del problem_s, state_s

    problem_s, state_s, _ = tw.build(kernel="pallas", **wave64)
    losses = stream_path(streaming(problem_s), state_s, len(losses_w), 1e-3, "stream wave 64", ["wave_64"])
    against_route(losses, losses_w, "training (stream wave 64^2 vs the slabbed route)")
    problem_s, state_s, _ = tw.build(kernel="pallas", **wave_big)
    losses = stream_path(streaming(problem_s), state_s, 40, 1e-3, "stream wave 1024", ["wave_1024"])
    against_plain(losses, wave_plain_big, "training (stream wave 1024^2)")

    problem_s, state_s, _ = th.build(
        nt=lane["nt"], nx=lane["nx"], infer_k=lane["infer_k"], imposed=lane["imposed"], nimp=lane["nimp"],
        seed=lane["seed"], kernel="pallas", device=dev,
    )
    net = state_s.fields["k_net"]
    net.weights = [torch.tensor(w, dtype=torch.float32, device=dev) for w in heat_ref["weights"]]
    net.biases = [torch.tensor(b, dtype=torch.float32, device=dev) for b in heat_ref["biases"]]
    losses = stream_path(streaming(problem_s), state_s, HEAT_STREAM_EPOCHS, 1e-3, "stream heat 64", ["heat_64"])
    against_route(losses, heat_losses, "training (stream heat 64^2 vs the slabbed route)")
    problem_s, state_s, _ = th.build(kernel="pallas", **heat_big)
    losses = stream_path(streaming(problem_s), state_s, HEAT_STREAM_EPOCHS_BIG, 1e-3, "stream heat 1024",
                         ["heat_1024"])
    against_plain(losses, heat_plain_big, "training (stream heat 1024^2)")
    del problem_s, state_s

    # i. Two-level fusion: the flagship with the hook at depth 2.
    problem2, state2, _ = vt.build(*SIZES["256"], kernel="pallas_mg", device=dev)
    hook = vt._mg_loss_and_grads.partial_depth
    vt._mg_loss_and_grads.partial_depth = lambda t0_shapes, dtype: 2
    try:
        grad_mg2 = problem2.make_loss_grad_fn(state2)
    finally:
        vt._mg_loss_and_grads.partial_depth = hook
    x0 = problem2.domain.arrays_from_state(state2)
    counters.zero()
    opt2, losses, chunk_ms = train(torch, Adam, grad_mg2, x0, args.epochs)
    expect_counts(counters.read(), dict(none, backward_mg2=len(losses)), "pallas_mg depth-2 training at 256^2")
    launches["backward_mg2_sums"] = len(losses)
    loops["pallas_mg depth 2 256"] = (opt2, steady_ms(chunk_ms))
    _, rel_depth2 = check_rows(losses, ref256, "training (pallas_mg, depth 2)")
    w1, w2 = max(rel_depth1, key=rel_depth1.get), max(rel_depth2, key=rel_depth2.get)
    print(f"worst rows against ref_velt_256.csv: depth 1 epoch {w1} ({100 * rel_depth1[w1]:.2f}%), depth 2 epoch "
          f"{w2} ({100 * rel_depth2[w2]:.2f}%) {tag}")
    x_r = [rand(*a.shape) / 3 for a in x0]
    (l1, _), g1 = grad_mg(x_r, problem.tracers)
    g1 = [a.clone() for a in g1]
    (l2, _), g2 = grad_mg2(x_r, problem2.tracers)
    errs = [close(a, b, 1e-5, GRAD_ATOL) for a, b in zip(g2, g1)]
    print(f"depth 2 vs depth 1 at a random state: loss {float(l2)!r} vs {float(l1)!r}, max|dgrad| "
          f"{max(e for e, _ in errs):.3e} {tag}")
    if abs(float(l2) - float(l1)) > TERMS_RTOL * abs(float(l1)) or not all(ok for _, ok in errs):
        fail("the depth-2 one-pass gradients leave depth 1's (rtol 1e-5, atol 1e-6 * max)")
    del g1, g2, x_r
    turns = {1: [], 2: []}
    opts = {1: Adam(grad_mg, x0, lr=0.01), 2: Adam(grad_mg2, x0, lr=0.01)}
    for _ in range(TURNS):
        for depth, o in opts.items():
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            o.run_chunk(TURN_EPOCHS)
            torch.cuda.synchronize()
            turns[depth].append((time.perf_counter() - t_start) * 1e3 / TURN_EPOCHS)
    print("pallas_mg 256^2 in turns, ms/epoch: " + "; ".join(
        f"depth {d}: " + ", ".join(f"{t:.4f}" for t in ts) + f" (median {statistics.median(ts):.4f})"
        for d, ts in turns.items()) + f" {tag}")
    del opts, opt2, grad_mg2, problem2, state2

    # j. The halo path on t:2,x:2: four shards of the card.
    from odil_torch import parallel

    mesh = parallel.mesh_from_spec(HALO_SPEC, devices=[dev] * HALO_SHARDS)
    halo_losses = {}
    for fuse, key, base in (("generic", "backward_halo", grad_p), ("mg", "backward_mg_local", grad_mg)):
        problem_q, state_q, _ = vt.build(*SIZES["256"], kernel="pallas_mg", device=dev, mesh=mesh, partition=HALO_PART)
        grad_q = problem_q.make_loss_grad_fn(state_q, halo=True, halo_fuse=fuse)
        if grad_q is None or grad_q.route != fuse:
            fail(f"make_loss_grad_fn(halo=True, halo_fuse={fuse!r}) gave route "
                 f"{None if grad_q is None else grad_q.route!r}")
        x0 = problem_q.domain.arrays_from_state(state_q)
        counters.zero()
        opt_q, losses, chunk_ms = train(torch, Adam, grad_q, x0, args.epochs)
        expect_counts(counters.read(), dict(none, **{key: HALO_SHARDS * len(losses)}), f"halo {fuse} training")
        launches[f"{key}_sums" if key == "backward_halo" else "backward_mg_local_sums"] = counters.read()[key]
        rows, rel = check_rows(losses, ref256, f"training (halo {fuse}, {HALO_SPEC}, {HALO_SHARDS} shards)")
        ref_rows = trajectory_rows(losses_unsharded)
        diff = {e: abs(rows[e] - ref_rows[e]) / abs(ref_rows[e]) for e in rows if e in ref_rows}
        worst = max(diff, key=diff.get)
        print(f"  halo {fuse} vs the unsharded pallas_mg run: epoch 0 {rows[0]!r} vs {ref_rows[0]!r} (rel "
              f"{diff[0]:.2e}); largest row difference epoch {worst}: {rows[worst]!r} vs {ref_rows[worst]!r} "
              f"({100 * diff[worst]:.4f}%) {tag}")
        if diff[0] > 1e-5:
            fail(f"halo {fuse}: epoch-0 loss {rows[0]} differs from the unsharded route's {ref_rows[0]} (limit 1e-5)")
        x_r = [rand(*a.shape) / 3 for a in x0]
        (l_q, _), g_q = grad_q(x_r, problem_q.tracers)
        g_q = [a.clone() for a in g_q]
        (l_u, _), g_u = base(x_r, problem.tracers)
        errs = [close(a, b, 1e-5, GRAD_ATOL) for a, b in zip(g_q, g_u)]
        print(f"  halo {fuse} vs the unsharded {'pallas' if fuse == 'generic' else 'pallas_mg'} one-pass at a random "
              f"state: loss {float(l_q)!r} vs {float(l_u)!r}, max|dgrad| {max(e for e, _ in errs):.3e} {tag}")
        if abs(float(l_q) - float(l_u)) > TERMS_RTOL * abs(float(l_u)) or not all(ok for _, ok in errs):
            fail(f"halo {fuse}: the one-pass loss and gradients leave the unsharded route's (rtol 1e-5, "
                 f"atol 1e-6 * max)")
        loops[f"halo {fuse} 256"] = (opt_q, steady_ms(chunk_ms))
        halo_losses[fuse] = (losses, grad_q)
        del g_q, g_u, x_r

    problem_q, state_q, _ = vt.build(*SIZES["512"], kernel="pallas_mg", device=dev, mesh=mesh, partition=HALO_PART)
    grad_q = problem_q.make_loss_grad_fn(state_q, halo=True, halo_fuse="mg")
    if grad_q is None or grad_q.route != "mg":
        fail("make_loss_grad_fn(halo=True, halo_fuse='mg') declined at 512^2")
    counters.zero()
    opt_q, losses, chunk_ms = train(torch, Adam, grad_q, problem_q.domain.arrays_from_state(state_q), HALO_EPOCHS_512)
    expect_counts(counters.read(), dict(none, backward_mg_local=HALO_SHARDS * len(losses)), "halo mg 512")
    launches["backward_mg_local_sums_512"] = counters.read()["backward_mg_local"]
    rel0 = abs(losses[0] - zero_loss) / abs(zero_loss)
    ms, n = steady_ms(chunk_ms)
    print(f"training (halo mg 512, {HALO_SPEC}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain "
          f"operator's {zero_loss!r} (rel {rel0:.2e}); final {losses[-1]!r}; {ms:.4f} ms/epoch {tag}")
    if rel0 > 1e-5:
        fail(f"halo mg 512: epoch-0 loss {losses[0]} differs from the plain operator's {zero_loss} (limit 1e-5)")
    loops["halo mg 512"] = (opt_q, (ms, n))
    del opt_q, grad_q, problem_q, state_q

    # k. The halo loss-only route: autograd of make_halo_loss_fn.
    problem_q, state_q, _ = vt.build(*SIZES["256"], kernel="pallas_mg", device=dev, mesh=mesh, partition=HALO_PART)
    counters.zero()
    opt_q, losses, chunk_ms = train(torch, Adam, autograd_loss_grad_fn(torch, problem_q, state_q, halo=True),
                                    problem_q.domain.arrays_from_state(state_q), HALO_LOSS_EPOCHS)
    n = HALO_SHARDS * len(losses)
    expect_counts(counters.read(), dict(none, forward_halo=n, backward_halo=n), "halo loss-only training")
    launches["forward_halo"], launches["backward_halo"] = n, n
    against_route(losses, halo_losses["generic"][0], "training (halo loss-only vs the halo generic route)", every=10)
    grad_q = halo_losses["generic"][1]
    x = [a.detach().clone().requires_grad_(True) for a in opt_q.x]
    loss_e, _ = problem_q.make_loss_fn(state_q, halo=True)[0](x, problem_q.tracers)
    grads_e = torch.autograd.grad(loss_e, x)
    (loss_t, _), grads_t = grad_q(opt_q.x, problem_q.tracers)
    e, ok = close_all(grads_e, grads_t)
    print(f"halo loss-only vs the halo generic route at the trained state: loss {float(loss_e)!r} vs "
          f"{float(loss_t)!r}, max|dgrad| {e:.3e} {tag}")
    if abs(float(loss_e) - float(loss_t)) > TERMS_RTOL * abs(float(loss_t)) or not ok:
        fail("the halo loss-only route and the halo generic route disagree")
    loops["halo loss-only 256"] = (opt_q, steady_ms(chunk_ms))
    del opt_q, problem_q, state_q, grads_e, grads_t, x

    # l. heat without its CUDA model: plain torch on the card.
    heat_plain_args = argparse.Namespace(
        infer_k=True, imposed="stripe", nimp=lane["nimp"], noise=0.0, seed=lane["seed"], kimp=2.0, kxreg=0.0,
        kxregdecay=0, ktreg=0.0, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=1, keep_init=0,
        solver="odil",
    )
    heat64 = dict(nt=lane["nt"], nx=lane["nx"], device=dev, args=heat_plain_args)
    problem_n, state_n, extra_n = th.build(kernel="pallas", **heat64)
    if th._row_model(Context(problem_n.domain, state_n, extra=extra_n, tracers=problem_n.tracers))[0].cuda_model:
        fail("heat with keep_init=0 declares a CUDA model")
    grad_n = problem_n.make_loss_grad_fn(state_n)
    if grad_n is None:
        fail("make_loss_grad_fn declined heat with keep_init=0")
    counters.zero()
    _, losses_n, chunk_ms = train(torch, Adam, grad_n, problem_n.domain.arrays_from_state(state_n), 50, lr=1e-3)
    expect_counts(counters.read(), dict(none, plain_on_card=len(losses_n)), "heat keep_init=0 training on the card")
    loops["heat 64 keep_init=0 (plain on card)"] = (None, steady_ms(chunk_ms))
    problem_x, state_x, _ = th.build(kernel="xla", **heat64)
    counters.zero()
    _, losses_x, _ = train(torch, Adam, autograd_loss_grad_fn(torch, problem_x, state_x),
                           problem_x.domain.arrays_from_state(state_x), 50, lr=1e-3)
    expect_counts(counters.read(), none, "heat keep_init=0 on the plain operator")
    against_route(losses_n, losses_x, "training (heat 64^2 keep_init=0, plain on card, vs the plain operator)",
                  every=10)
    del problem_n, state_n, grad_n, problem_x, state_x

    # m. The training harness: the two command-line examples through
    # util.optimize, each in a directory of its own under build/.
    m_launches, vt_rows, vt_ms = harness_phase(torch, counters, args.epochs, losses_unsharded,
                                               loops["pallas_mg 256"][1][0], tag)
    launches.update(m_launches)

    # n. The remaining CLIs at the converged lane's configurations; the heat
    # row kernels' launches on the heat CLI's path join phase e's.
    for name, n in cli_phase(torch, counters, heat_ref, heat_losses, loops["heat 64"][1][0], tag).items():
        launches[name] += n

    # o. Newton and Gauss-Newton: the run scripts' cases as CLIs.
    newton_phase(torch, counters, tag)

    # p. Heat and wave under --halo, plot epochs, asynchronous checkpoints and
    # compare.py.
    t_p = time.perf_counter()
    p_launches, halo1d_cases = halo1d_phase(torch, np, counters, heat_ref, vt_rows, vt_ms, args.epochs, report,
                                            {"heat": heat_plain_big, "wave": wave_plain_big}, tag)
    t_p = time.perf_counter() - t_p
    launches.update(p_launches)

    idle = [name for name in report if launches.get(name, 0) < 1]
    if idle:
        fail(f"kernels not launched on their paths: {idle}")

    # -- Phase 4: timing -------------------------------------------------------
    for route, (o, (ms, n)) in loops.items():
        print(f"training loop ({route}): {ms:.4f} ms/epoch (median of {n} chunks of {CHUNK} epochs "
              f"after the first) {tag}")
    for route in ("pallas_mg 256", "pallas 256", "heat 64", "stream 256", "pallas_mg depth 2 256", "halo generic 256",
                  "halo mg 256"):
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
    # The streaming kernels, each beside the slabbed launch on the same
    # inputs, and the two-level backward.
    slabbed, unlisted = {}, {}
    stream_cases = {size: (*row_model(size)[:2], 1, fields[size], (), (), row_model(size)[2]) for size in ("256", "64")}
    stream_cases.update({f"{w}_{size}": c for (w, size), c in cases_1d.items()})
    edge = {}  # stream kernel -> the bytes of the rows its slabs read again
    for key, (m, nt_, h, fs, ps, ds, cs) in stream_cases.items():
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        n_cells, f_in = fs[0].numel(), nbytes(fs + ps + ds + cs)
        plane = nbytes(fs) // fs[0].shape[0]
        for name, grads, sums in ((f"forward_stream_{key}", False, True), (f"backward_stream_{key}", True, False)):
            slab = rw.launch_shape(m, fs, grads, sums)[0]
            edge[name] = -(-fs[0].shape[0] // slab) * h * (2 if grads else 1) * plane
        ops_f, ops_b = ops_1d[key.split("_")[0]] if "_" in key else (OPS_ROWS_FORWARD, OPS_ROWS_BACKWARD)
        args_ = (m, nt_, h, fs, ps, ds, cs)
        timed[f"forward_stream_{key}"] = (
            lambda a=args_: rw.forward_stream_cuda(*a), lambda a=args_: rw._forward_plain(*a),
            f_in + 4 * nt_, ops_f * n_cells, "odil_tpu/ops/rowwise.py:676", rows_src,
        )
        slabbed[f"forward_stream_{key}"] = lambda a=args_: rw.forward_cuda(*a)
        for sums, name in ((False, f"backward_stream_{key}"), (True, f"backward_stream_sums_{key}")):
            entry = (
                lambda a=args_, gs=gs, s=sums: rw.backward_stream_cuda(*a, gs, s),
                lambda a=args_, gs=gs, s=sums: rw._backward_plain(*a, gs, s),
                f_in + nbytes(fs + ps) + 4 * nt_ * (2 if sums else 1), ops_b * n_cells, "odil_tpu/ops/rowwise.py:811",
                rows_src,
            )
            (unlisted if sums else timed)[name] = entry
            slabbed[name] = lambda a=args_, gs=gs, s=sums: rw.backward_cuda(*a, gs, s)
    lvl2_in, lvl2_out = nbytes(t0s + t1s + P2s + consts), nbytes(t0s + t1s + P2s)
    for sums, name in ((True, "backward_mg2_sums"), (False, "backward_mg2")):
        (timed if sums else unlisted)[name] = (
            lambda s=sums: rmg.backward_mg2_cuda(model, nterms, 1, f0s, f1s, t0s, t1s, P2s, consts, g, s),
            lambda s=sums: lvl2_plain(s),
            lvl2_in + lvl2_out + 4 * nterms * (2 if sums else 1),
            OPS_BACKWARD * cells + OPS_LVL2_PER_COARSE * t1s[0].numel(), "odil_tpu/ops/rowwise_mg.py:766", mg_src,
        )

    # The per-shard kernels at shard (1, 1)'s inputs, and the local mg
    # backward at the 512^2 shard.
    meta, hm, hfs, hcs, mm, mt0, mP, mh = halo_cases[3]
    n_h, h_in = hfs[0].numel(), nbytes(hfs + hcs + (hmask,))
    timed["forward_halo"] = (
        lambda: rw.forward_halo_cuda(hm, nterms, 1, hfs, (), (), hcs),
        lambda: rw._forward_plain(hm, nterms, 1, hfs, (), (), hcs),
        h_in + 4 * nterms, OPS_ROWS_FORWARD * n_h, "odil_tpu/ops/rowwise_tiled.py:272", rows_src,
    )
    for sums, name in ((True, "backward_halo_sums"), (False, "backward_halo")):
        timed[name] = (
            lambda s=sums: rw.backward_halo_cuda(hm, nterms, 1, hfs, (), (), hcs, g, s),
            lambda s=sums: rw._backward_plain(hm, nterms, 1, hfs, (), (), hcs, g, s),
            h_in + nbytes(hfs) + 4 * nterms * (2 if sums else 1), OPS_ROWS_BACKWARD * n_h,
            "odil_tpu/ops/rowwise_tiled.py:447", rows_src,
        )
    for name, args_, replaced in (
        ("backward_mg_local_sums", (mm, mt0, mP, mh, meta["x0"], hcs, g), "odil_tpu/ops/rowwise_mg.py:766"),
        ("backward_mg_local_sums_512", (mm512, mt512, mP512, mh512, x0_512, hcs512, g512h),
         "odil_tpu/ops/rowwise_mg_local_tiled.py:565"),
    ):
        m_, t0_, P_, h_, x0_, cs_, g_ = args_
        timed[name] = (
            lambda a=args_: rmg.backward_mg_local_cuda(a[0], nterms, 1, f0s, *a[1:]),
            lambda a=args_: rmg._backward_mg_local_plain(a[0], nterms, 1, f0s, *a[1:]),
            nbytes(t0_ + P_ + h_ + cs_ + (m_.halo[0],)) + nbytes(t0_ + P_ + h_) + 8 * nterms,
            OPS_BACKWARD * t0_[0].numel(), replaced, mg_src,
        )

    # The per-shard 1-D kernels at shard 1's inputs of the 64^2 and 1024^2
    # t:4 paths.
    for key, (m, nt_, h, fs, ps, ds, cs) in halo1d_cases.items():
        which = key.split("_")[0]
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        n_cells, f_in = fs[0].numel(), nbytes(fs + ps + ds + cs + (m.halo[0],))
        ops_f, ops_b = ops_1d[which]
        args_ = (m, nt_, h, fs, ps, ds, cs)
        timed[f"forward_halo_rows1d_{key}"] = (
            lambda a=args_: rw.forward_halo_rows1d_cuda(*a), lambda a=args_: rw._forward_plain(*a),
            f_in + 4 * nt_, ops_f * n_cells, "odil_tpu/ops/rowwise.py:385", rows_src,
        )
        for sums, name in ((True, f"backward_halo_rows1d_sums_{key}"), (False, f"backward_halo_rows1d_{key}")):
            timed[name] = (
                lambda a=args_, gs=gs, s=sums: rw.backward_halo_rows1d_cuda(*a, gs, s),
                lambda a=args_, gs=gs, s=sums: rw._backward_plain(*a, gs, s),
                f_in + nbytes(fs + ps) + 4 * nt_ * (2 if sums else 1), ops_b * n_cells,
                "odil_tpu/ops/rowwise.py:549", rows_src,
            )

    print_mg_splits()
    # A backward+sums of the row kernels, slabbed or streaming (the masked
    # one slabbed), is one launch (torch.profiler; after the training loops,
    # which a profiler session leaves slower on the host).
    for key, (m, nt_, h, fs, ps, ds, cs) in row_cases.items():
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        per_call = {}
        routes = (("slabbed", rw.backward_halo_cuda),) if m.halo is not None else (
            ("slabbed", rw.backward_cuda), ("streaming", rw.backward_stream_cuda))
        for route, call in routes:
            _, _, counts = kernel_split(torch, lambda: call(m, nt_, h, fs, ps, ds, cs, gs, True), reps=10)
            per_call[route] = counts
            if sum(counts.values()) > 1 + 1e-9:
                fail(f"the {route} backward+sums at {key} launched more than one kernel: {counts}")
        print(f"kernels per backward+sums call at {tuple(fs[0].shape)} ({key}): " + ", ".join(
            f"{r} {c}" for r, c in per_call.items()) + f" {tag}")
    lib_rows = rw._library()
    floor_ms = kernel_ms(torch, lambda: rw._raise_on(
        lib_rows, lib_rows.odil_empty_launch(torch.cuda.current_stream().cuda_stream), "odil_empty_launch"), 50)
    print(f"launch floor: an empty kernel {floor_ms:.4f} ms (a CUDA graph of 50 launches) {tag}")
    print(f"operations per residual cell in the bounds: OPS_HEAT_FORWARD {OPS_HEAT_FORWARD}, OPS_HEAT_BACKWARD "
          f"{OPS_HEAT_BACKWARD} (one network pass {OPS_HEAT_NET} and one param adjoint {OPS_HEAT_NET_VJP} a face), "
          f"OPS_WAVE_FORWARD {OPS_WAVE_FORWARD}, OPS_WAVE_BACKWARD {OPS_WAVE_BACKWARD}, OPS_ROWS_FORWARD "
          f"{OPS_ROWS_FORWARD}, OPS_ROWS_BACKWARD {OPS_ROWS_BACKWARD} {tag}")
    kernels = []
    for name, (kfn, pfn, nbyte, ops, replaced, source) in list(timed.items()) + list(unlisted.items()):
        ms = kernel_ms(torch, kfn, 50)
        plain_ms = time_ms(torch, pfn, 3)
        t_bytes = nbyte / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        beside = f", slabbed launch {kernel_ms(torch, slabbed[name], 50):.4f} ms" if name in slabbed else ""
        if name in edge:
            t_edge = max((nbyte + edge[name]) / HBM_BYTES_PER_S * 1e3, t_ops)
            beside += f", bound with the rows its slabs read again (+{edge[name]} bytes) {t_edge:.4g} ms"
        if name.endswith("_64"):
            beside += f", launch floor {floor_ms:.4f} ms"
        if name in unlisted:
            print(f"kernel {name} (no path runs it): {ms:.4f} ms{beside}, bound {bound_ms:.4g} ms ({bound_by}), "
                  f"plain {plain_ms:.4f} ms, max|d| {off_path[name]:.3e} {tag}")
            continue
        print(f"kernel {name}: {ms:.4f} ms{beside}, bound {bound_ms:.4g} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"{launches[name]} launches on its path {tag}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaced,
            "launches": launches[name], "max_abs_err": report[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

    print(f"seconds: phase p {t_p:.1f}, the script from its start (the kernels' build included) "
          f"{time.perf_counter() - t_main:.1f} {tag}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
