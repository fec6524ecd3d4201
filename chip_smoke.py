#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths once on one NVIDIA card.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py            # the full check (400 training epochs at 256^2)
    python3 chip_smoke.py --epochs 40   # shorter flagship training phases

Phases, any failure exits non-zero and prints no result:

1. Build: the CUDA libraries of ``odil_torch/csrc/`` (``rowwise_mg.cu``,
   ``rowwise.cu``, ``probes.cu``, the two ablation builds of
   ``rowwise_mg.cu`` (``ODIL_MG_ABLATION``), ``heat_net.cu`` for each of
   phase u's conductivity nets, and phases l, w and x's traced row models:
   the row functions traced at the start, before any kernel runs, their
   generated sources) compile with nvcc for sm_90a into
   ``build/odil_torch/``, one nvcc per source, variant, net or trace,
   started together; all but the first two are waited for before phase l.
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
   l. User row functions on 1-D planes on the traced kernels
      (``ops/rowtrace.py``: the row function traced to a ``rows1d.cuh`` row
      model with its adjoint, a library each, built at the start).  The row
      functions of heat (``keep_init=0``, ``keep_frozen=1``, the [1, 5, 5,
      1] net, stripe measurements) and wave reach ``ctx.rowwise_terms``
      bare, as a user's do (``RowModel(row_fn)``: no CUDA model, no hand
      adjoint).  Each library's build seconds, ptxas registers and spills.
      Kernels at 1024^2 (and heat's backward+sums at 64^2): forward,
      backward+sums, backward and the streaming pair against the plain
      version (autograd of the row function) in fp64 and against the hand
      kernel (heat_net.cu's [1, 5, 5, 1], rowwise.cu's wave) on the same
      inputs, the same bits call after call and streaming as slabbed.
      Paths: heat 64^2 trained 50 epochs through the one-pass route, one
      traced backward+sums an epoch and no ``plain_on_card``, epoch 0
      within 1e-5 and every 10-epoch row within 1% of the plain operator
      (``kernel="xla"``) trained the same way by autograd, and its
      loss-only path; heat and wave at 1024^2, 10 epochs one-pass and 10
      streaming (one stream forward and backward an epoch), epoch 0 within
      1e-5 of the plain operator, and their loss-only paths.  A row
      function the tracer refuses (a field read at x+2) runs
      ``plain_on_card`` with its reason, the CPU route's numbers.
   u. Every heat configuration on the row kernels (``csrc/heat_net.cu``, a
      library per conductivity net, built with the others at the start).
      Kernels: forward, backward+sums and backward against the plain version
      (the hand adjoint) in fp64 at 64^2 and 1024^2 (the converged lane's
      measurements, seeded random fields and net noise) for ``keep_init=0``,
      ``keep_frozen=0``, ``--arch_k 32 32`` with and without keep_frozen and
      ``--arch_k 16 16 16`` with both keep flags off; for the last, the
      streaming pair at 1024^2 (the slabbed launch's bits) and the masked
      per-shard kernels on the t:4 shards of 1024^2 (``close_floor``).
      Training: heat 64^2 with ``kernel="pallas"``, 50 epochs each with
      ``keep_init=0`` and with ``--arch_k 32 32 --keep_frozen 0``, one heat
      backward+sums an epoch and no ``plain_on_card``, epoch 0 within 1e-5
      and every 10-epoch row within 1% of ``kernel="xla"`` trained the same
      way, and the loss-only path; the last configuration at 1024^2 through
      the slabbed, streaming and per-shard (t:4) routes, 10 epochs each,
      epoch 0 within 1e-5 of the plain operator, and their loss-only paths.
      The CLI: ``odil_torch.examples.heat --Nt 256 --Nx 256 --infer_k 1
      --imposed stripe --arch_k 32 32 --keep_frozen 0``, 50 epochs, with
      ``--kernel pallas`` (one backward+sums an epoch plus the epoch-0
      evaluation's forward and sums-off backward) and ``--kernel xla``:
      epoch 0 within 1e-5, every row within 1%; both ms/epoch.  Before the
      kernels, each wide net's library (more than 48 params, the wide form
      of ``csrc/heat_wide.cuh``): ptxas's registers and spills, its build
      seconds, its blocks an SM and the passes a batch of its param
      phase.
   w. User row functions on 2-D planes and on a shard's block on the traced
      kernels (``ops/rowtrace.py``: a ``rows2d.cuh`` row model for (T, X, Y)
      planes, and the masked forms of both ranks; the libraries built with
      the others at the start).  Builds: the veltracer's row function at
      256^2 (also the shards') and 512^2, the generic case (``w_net_row_fn``:
      hist 2, params, (T, X, Y) and (T, 1, 1) data at (65,256,256)) and the
      shard models of heat ``keep_init=0`` and wave at 64^2 and 1024^2 (the
      first three of these phase l's libraries): each library's build
      seconds, ptxas registers and spills, blocks an SM.  Kernels: forward,
      backward+sums and backward (and the streaming pair unsharded) at
      (65,256,256)x3, (65,512,512)x3, shard (1, 1) of t:2,x:2's
      (34,130,256)x3 blocks with their (130,256) mask, the generic case, and
      shard 1 of the t:4 grids of heat and wave at 64^2 and 1024^2, each
      against the plain version in fp64 (``close_floor``) and the hand
      kernel on the same inputs (``rows_kernel``, ``rows1d_kernel<HeatRow
      /WaveRow, MODE, true>``), its bits call after call, streaming as
      slabbed.  Paths, the row functions bare (``user_row_function``): the
      veltracer on ``kernel="pallas"`` at (64,256,256) for W_EPOCHS
      epochs, one traced 2-D backward+sums an epoch and no other kernel of
      the row-wise or plain routes (the kernels of an epoch by name: no
      ``rows_kernel``), epoch 0 within 1e-5 and every row within 15% of
      ``ref_velt_256.csv``, every 10-epoch row within 1% of phase b's hand
      route, and its loss-only path; at 512^2, W_BIG_EPOCHS epochs, epoch 0
      within 1e-5 of the plain operator, and its loss-only path; streaming
      at 256^2, W_BIG_EPOCHS epochs; the halo generic route on t:2,x:2 at
      256^2, W_HALO_EPOCHS epochs, four masked traced backward+sums an
      epoch, epoch 0 within 1e-5 of the unsharded run, and its loss-only
      path; heat ``keep_init=0`` under ``--mesh t:4 --halo 1`` at 64^2,
      W_HEAT_EPOCHS epochs, four masked traced 1-D backward+sums an epoch,
      every 10-epoch row within 1% of the plain operator trained the same
      way, and its loss-only path; the generic case W_BIG_EPOCHS gradient
      steps through ``rowwise_loss_and_grads``.
   x. A user's row function on the mg route on the traced walk
      (``csrc/mg_rows2d.cuh``: the hand walk's rebuild and in-walk dP,
      ``csrc/mg_common.cuh``, with ``rows2d.cuh``'s model evaluation;
      ``Trace.mg_source``, built with the others at the start).  Builds:
      phase w's veltracer row function at 256^2 (also depth 2 and the
      shards') and 512^2 and its generic case, each library's build
      seconds, ptxas registers and spills, shared memory a block by form
      against ``rowtrace.mg2d_smem``, blocks an SM.
      Kernels: forward, backward+sums and backward at t0 (65,256,256)x3
      with P (33,128,128)x3; backward+sums at (65,512,512)x3; depth 2 with
      and without the sums (t1 (33,128,128)x3, P2 (17,64,64)x3); the local
      block of shard (1, 1) of t:2,x:2 at 256^2 and 512^2; the generic case
      with its params and data over a seeded level-1 partial -- each
      against the plain version in fp64 (``close_floor``) and the hand walk
      on the same inputs, its bits call after call, the launches on the
      built-in mg wrappers' counters and none on ``plain_on_card``.  Host:
      the median host time of X_HOST_CALLS backward+sums calls at 256^2
      from the dispatcher to its return, traced and hand route, and of the
      traced route's decision alone (not gated).  Paths,
      the row function bare through ``bare_row_model`` (a stand-in for
      ``vt._row_model`` within the phase): ``kernel="pallas_mg"`` at
      (64,256,256) for X_EPOCHS epochs, one traced backward+sums an epoch
      and no other kernel of the mg, row-wise or plain routes (the kernels
      of an epoch by name: the walk, no ``mg_rows_kernel``), epoch 0 within
      1e-5 and every row within 15% of ``ref_velt_256.csv``, every 10-epoch
      row within 1% of phase a's hand route, its ms/epoch beside a.'s, and
      its loss-only path; at 512^2, X_BIG_EPOCHS epochs, epoch 0 within 1e-5
      of the plain operator; at depth 2, X_HALO_EPOCHS epochs, every row
      within 1% of the depth-1 run; the halo mg route on t:2,x:2 at 256^2
      (X_HALO_EPOCHS epochs, four traced local walks an epoch, every row
      within 1% of the unsharded run) and 512^2 (X_HALO512_EPOCHS, epoch 0
      against the plain operator); the generic case X_BIG_EPOCHS Adam steps
      over its t0 terms, partial and params through
      ``rowwise_mg_loss_and_grads``; a refused row function (a read at x+2)
      on the mg route runs ``plain_on_card`` once with its reason.
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
      64^2 (``lbfgs``, HEAT_TMAX_EPOCHS epochs) against ``ref_heat_tmax.csv``
      at that epoch (norm_eqn 3, norm_imp 3, loss 10); wave 64^2
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
   q. Every mesh route on the mesh of four shards of the card.  q1:
      the run script's poisson gn case (64^2 fp64, plain CG, 3 epochs) under
      ``--mesh x:2,y:2 --halo 1`` (the halo residual map), its rows within
      the band phase o holds the unsharded case to (rtol 1e-7 or twice the
      JAX package's own spread), its ms/epoch and normal matvecs beside
      phase o's.  q2: the halo loss of velocity_from_tracer (64x256x256,
      ``pallas``, t:2,x:2) with ``mg_ladder="global"`` and ``"local"``, 20
      loss+grad evaluations each (autograd of ``make_halo_loss_fn``: four
      masked forwards and backwards an evaluation), at a seeded random state:
      the loss within 1e-5 of the unsharded pallas loss, the global ladder's
      gradients within ``close_floor`` of the local one's (the fp64 plain
      operator as the floor's reference); the ms of each.  q3:
      ``parallel.multi_start`` with 4 starts: poisson 64^2 in fp64 (plain
      torch, ``torch.func.vmap``; scale 0.5, Adam lr 0.001, 200 epochs), the
      batched loss at epoch 0 the mean of the instances' (rtol 1e-12) and
      every instance's loss lower at the end; heat 64^2 ``kernel="pallas"``
      (a loop over the instances; scale 0.05, 50 epochs), each instance's
      rows within 1e-5 of a single-start run from its start with the loss
      scaled by 1/4, one forward and one backward row kernel an instance and
      epoch; the batched ms/epoch beside four single runs.  q4: the GSPMD
      route (``--mesh`` without ``--halo``): ``poisson --mesh x:2,y:2``
      (case 0, cut to 200 epochs), ``heat --kernel pallas --mesh t:2,x:2``
      (200 epochs; the x partition that ``--halo`` refuses) and m.'s
      veltracer CLI on ``--mesh t:2,x:2``, each with train.csv rows equal to
      the unsharded CLI's (m.'s for veltracer) to the bit, the same
      launches, the ``mesh:`` line in its log, and its state on the card,
      placed without a copy.
   r. The halo route over several processes (``torch.distributed``): the
      script starts its own workers (``chip_smoke.py --dist-worker``), each
      joining the group through ``parallel.init_distributed`` with its
      backend and transport printed, and kills them on the way out.  r1:
      four processes share the card over gloo (NCCL refuses two ranks on one
      card), one shard of t:2,x:2 each, and train the flagship (64x256x256)
      through the generic and the MG-fused halo routes for 200 epochs each
      (j.'s first 200): epoch 0 within 1e-5 of j.'s, each process's
      epoch-0 gradient within 1e-5 of the single controller's on its block
      (max|diff| over the array's max|entry|), every row within twice the
      spread that one-ulp gradient noise opens in the single controller's
      rows (three seeds) of j.'s and within 15% of ``ref_velt_256.csv``, the
      losses the same on every process, one
      masked backward+sums (or one local-block mg backward) a process and
      epoch and no other kernel; the largest distance from j.'s rows and
      each route's ms/epoch beside j.'s printed.  r2: heat (e.'s net) and
      wave (fp32) at 64^2 on t:4 over two processes of two shards (gloo),
      200 epochs, against the single controller on the mesh of four shards
      of the card: epoch 0 within 1e-5, every 20-epoch row within twice the
      spread that one-ulp gradient noise opens in the single controller
      (three seeds, as p. holds heat) and at least g.'s 1%; two masked 1-D
      backward+sums a process and epoch.  r3: one process with NCCL at
      world size 1, the generic route for 50 epochs: its rows equal to j.'s
      first 50 to the bit.
   s. The other routes over several processes (the workers as in r.,
      ``routes_worker``), against the single controller on the mesh of four
      shards of the card.  s1: the flagship (64x256x256) ``pallas_mg`` on
      t:2,x:2 through the GSPMD route (no ``halo``), four processes sharing
      the card over gloo, 100 epochs: every process holds its blocks and
      gathers the whole arrays (``Problem.make_loss_fn``); epoch 0's loss,
      every process's block of the epoch-0 gradient and all 100 rows equal
      to the single controller's to the bit; one mg backward+sums a process
      and epoch, and the epoch-0 evaluation's forward and sums-off
      backward.  s2: its plain operator (``kernel="xla"``), the same
      route, 20 epochs: epoch 0 within 1e-6, each
      block of the epoch-0 gradient within ``close_floor`` (the fp64 plain
      operator as the floor's reference), every row within twice the spread
      that one-ulp gradient noise opens in the single controller's rows
      (three seeds); no kernel.  s3: q1's poisson gn CLI under ``--mesh
      x:2,y:2 --halo 1`` over two processes of two shards: rows within
      q1's band (rtol 1e-7 or twice the JAX package's own spread), every
      process's iterate the same bits after every step.  s4:
      ``multi_start`` with 4 starts on a batch axis over two processes, q3's
      poisson (rows within 1e-12 of q3's) and heat (``pallas``, rows within
      twice one-ulp noise's spread of q3's, each instance's rows within it
      too; one forward and one backward row kernel an instance and epoch),
      50 epochs.  s5: s1's problem in one process that has joined an NCCL
      group at world size 1: its mesh does not span processes, so no
      collective runs and the route is the one-process GSPMD route; 50
      epochs, rows and the epoch-0 gradient equal to s1's single
      controller's to the bit (joining NCCL changes no number; r3 holds
      the same for the halo route).  Each prints its
      ms/epoch, its collective rounds and the MB a process sends an epoch.
   t. The routes that open on a mesh over several processes in PR 16 (the
      workers as in r., ``spanning_worker``).  t1: the flagship
      (64x256x256, ``pallas_mg``) through ``util.optimize(args, "lbfgs",
      ...)`` on t:2,x:2 (the GSPMD route), four processes, 20 iterations:
      its rows and the whole iterate after every iteration equal to the
      single controller's (the mesh of four shards of the card) to the bit,
      the same iterate bits on every process; ms/iteration, evaluations and
      host syncs an iteration, the MB a process sends and the L-BFGS memory
      a process; one mg backward+sums a process and evaluation.  t2: the
      wave CLI (64^2 fp32 ``--kernel pallas``, its default L-BFGS, 200
      iterations) under ``--mesh t:2 --halo 1`` over two processes: epoch 0
      equal to the one-process run's on the same mesh to the bit, the rows
      within phase n's converged margins for wave (``ref_wave.csv``), the
      iterate the same bits on both processes after every iteration; one
      masked 1-D backward+sums a process and evaluation.  t3: the flagship's
      halo mg route on t:2,q:2 (q partitions no grid dimension: the
      processes along it are replicas), four processes, 100 Adam epochs:
      epoch 0 equal to the one-process run's on t:2 to the bit, its
      gradient within r1's limit and its rows inside twice the one-ulp band
      of that run; every process's gradient blocks and rows equal to the
      same route's on t:2 over two processes (no idle axis) to the bit; one
      local-block mg backward a process and epoch.  t4: ``multi_start`` on
      q3's heat (4 starts, 50 epochs) with the domain's t over two processes
      (every instance on each process's blocks) and on b:2,t:2 (the
      instances on b), a process a b index or a t index: batch rows within
      twice s4's one-ulp spread of q3's and each instance's rows within it
      too; one forward and one backward row kernel an instance and epoch on
      each process.  t5: every computing name of ``ctx.mod``
      (``backend.ModTorch``) on the card against the CPU: the same bits for
      the exact operations, 1e-6 relative for the others, the convolutions
      with TF32 off; ``random``'s shapes, dtypes, determinism and moments.
   v. The last two TPU kernels and the tools that run them
      (``csrc/probes.cu``: the roofline's copy3 and the kernel ablation's
      fma; ``ops/mg_ablation.py``: the ablation builds of the mg kernel).
      copy3 the bits of three clones and fma within rtol 1e-5 of its plain
      version at (65,256,256) and (65,512,512), the count of FFMA in the
      unrolled fma kernel (at least four chains of 128 a thread), the
      trivial-row and no-matmul builds against their own plain versions
      at both shapes (sums rtol 1e-5; gradients by ``close_floor``, the fp64
      plain version and the fp32 floor: the no-matmul build's rough fields
      leave a few cells where fp32 itself misses the gate); then
      ``odil_torch.tools.roofline`` and ``odil_torch.tools.kernel_ablation``
      (variants full, kernel-only, trivial-row, no-matmul, vpu; and vpu at
      512^2) run as a user runs them, at ``--length 20 --reps 3``, each with its launches counted and
      its JSON printed and finite, the full epoch with bf16 slots beside
      fp32 slots (ungated), and the copy3 chain at 512^2.  The measured
      ceilings (copy3's rate at 512^2, the larger fma rate) are printed
      beside the data sheet's, and every kernel's line and JSON entry gets
      ``bound_measured_ms``, its bound at those ceilings.
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
import contextlib
import csv
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PARITY = os.path.join(HERE, "docs", "parity_data")
sys.path.insert(0, HERE)
try:
    # The data-sheet rates and the fp32 operations a cell that the bounds use.
    from odil_torch.tools.roofline import (
        FP32_FLOPS, HBM_BYTES_PER_S, OPS_BACKWARD, OPS_FORWARD, OPS_HEAT_BACKWARD, OPS_HEAT_FORWARD, OPS_HEAT_NET,
        OPS_HEAT_NET_VJP, OPS_LVL2_PER_COARSE, OPS_NO_MATMUL_BACKWARD, OPS_ROWS_BACKWARD, OPS_ROWS_FORWARD,
        OPS_TRIVIAL_ROW_BACKWARD, OPS_WAVE_BACKWARD, OPS_WAVE_FORWARD, heat_net_ops, heat_ops,
    )
except ImportError as exc:
    print(f"chip_smoke: FAIL: no odil_torch package beside {__file__} ({exc}): run from a checkout of the repository",
          file=sys.stderr)
    sys.exit(1)
DEVICE = "cuda"
# The grids in cells: the flagship (the whole-plane TPU kernels), 64^3 (the
# blocked ones) and 512^2 (the x-tiled ones).
SIZES = {"256": (64, 256, 256), "64": (64, 64, 64), "512": (64, 512, 512)}
# The 1-D grids (T, N) of the heat and wave paths, and the narrow plane.
SIZES_1D = {"64": (64, 64), "1024": (1024, 1024)}
NARROW_1D = (7, 5)
HEAT_DATA = os.path.join(HERE, "odil_torch", "data", "heat_inverse_64.json")
HEAT_EPOCHS, HEAT_EVERY = 1500, 100
# Phase n's heat_tmax CLI: its epochs (the reference's rows run to 4000;
# held at its row of this epoch, a quarter of the depth for the script's
# time).
HEAT_TMAX_EPOCHS = 1000
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
# Phase r: the halo route over several processes.  r1: the flagship on
# HALO_SPEC with one shard a process (4 processes sharing the card over
# gloo), DIST_R1_EPOCHS epochs a route (the first half of phase j's rows:
# the script's time limit); r2: heat and wave at 64^2 on HALO1D_SPEC over 2
# processes of 2 shards, DIST_1D_EPOCHS epochs; r3: one process with NCCL,
# the flagship's generic route for DIST_NCCL_EPOCHS epochs.  A worker may
# take DIST_TIMEOUT seconds; the group's collectives time out after as long.
DIST_R1_EPOCHS, DIST_1D_PROCS, DIST_1D_EPOCHS, DIST_NCCL_EPOCHS = 200, 2, 200, 50
DIST_TIMEOUT = 300
# r1's epoch-0 gradient: each process's block of every array against the
# single controller's, max|difference| over the array's max|entry|.  A sum
# in another order moves an entry by a few fp32 ulps of the terms it adds;
# a cotangent lost or counted twice moves it by its own size.
DIST_GRAD_LIMIT = 1e-5
# Phase l: user row functions on 1-D planes (the bare row function: no CUDA
# model, no hand adjoint) on the traced kernels (odil_torch/ops/rowtrace.py).
# L_CASES: (model, size) of its kernel checks and paths, heat in phase l's
# configuration (keep_init=0, keep_frozen=1, the [1, 5, 5, 1] net, the
# converged lane's stripe measurements) and wave; L_EPOCHS a 64^2 run (a row
# every L_EVERY), L_BIG_EPOCHS a 1024^2 route.
L_CASES = (("heat", "64"), ("heat", "1024"), ("wave", "1024"))
L_EPOCHS, L_EVERY, L_BIG_EPOCHS = 50, 10, 10
# Phase u: every heat configuration on the row kernels.  U_CONFIGS: name ->
# (hidden widths of the conductivity net, keep_init, keep_frozen), each held
# to its plain version at SIZES_1D (the converged lane's measurements);
# U_TRAIN: the 64^2 training runs against kernel="xla" (U_EPOCHS epochs, a
# row every U_EVERY); U_BIG: the configuration whose slabbed, streaming and
# masked per-shard kernels run a 1024^2 path (U_BIG_EPOCHS epochs each);
# U_CLI_ARGV: the heat CLI at 256^2, --kernel pallas against --kernel xla.
U_CONFIGS = {
    "ki0": ((5, 5), 0, 1), "kf0": ((5, 5), 1, 0), "w32x32": ((32, 32), 1, 1), "w32x32_kf0": ((32, 32), 1, 0),
    "w16x16x16_ki0_kf0": ((16, 16, 16), 0, 0),
}
U_TRAIN, U_BIG = ("ki0", "w32x32_kf0"), "w16x16x16_ki0_kf0"
U_EPOCHS, U_EVERY, U_BIG_EPOCHS = 50, 10, 10
U_CLI_ARGV = ["--Nt", "256", "--Nx", "256", "--infer_k", "1", "--imposed", "stripe", "--arch_k", "32", "32",
              "--keep_frozen", "0", "--epochs", "50", "--history_every", "10", "--report_every", "10"]
# The unmasked forms of rows1d_kernel as built before its halo layer (SASS
# instructions by cuobjdump, registers by ptxas; measured on one NVIDIA H100
# 80GB HBM3 for rowwise.cu before the layer): the layer leaves them as they were.
ROWS1D_PINNED = {
    ("HeatRow", 1): (5376, 128), ("HeatRow", 2): (5984, 128), ("HeatRow", 3): (6448, 128),
    ("WaveRow", 1): (2744, 40), ("WaveRow", 2): (2456, 40), ("WaveRow", 3): (2904, 43),
}
# Phase v: the probes and the ablation builds of the mg kernel.  V_SIZES:
# the shapes where they are held to their plain versions and timed (the
# probes' 512^2 arrays exceed the L2: the HBM reading); the tools run as
# ``--length V_LENGTH --reps V_REPS`` (a warm-up chunk and V_REPS chunks of
# V_LENGTH calls), the ablation over V_VARIANTS; fma against its plain
# version within V_FMA_RTOL (one rounding a step against two, 128 steps).
V_SIZES = {"256": (65, 256, 256), "512": (65, 512, 512)}
V_LENGTH, V_REPS = 20, 3
V_VARIANTS = "full,kernel-only,trivial-row,no-matmul,vpu"
V_FMA_RTOL = 1e-5
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


def sass_opcount(path, kernel, opcode):
    """Instructions of ``opcode`` in the functions of a built library whose
    mangled name holds ``kernel`` (cuobjdump), or None where the toolkit has
    no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
    count, inside = 0, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "*/" in line and opcode in line.split("*/", 1)[1].replace(";", " ").split():
            count += 1
    return count


def start_builds(_build, jobs):
    """Starts one nvcc for each job (a source's name, ``(name, variant,
    defines)`` for a source built in variants, or ``("generated", name,
    text, label)`` for a generated source), all together: {name, "name
    variant" or "name label": future of ``compile_source`` or
    ``compile_generated``}."""
    jobs = [(j,) if isinstance(j, str) else tuple(j) for j in jobs]
    ex = concurrent.futures.ThreadPoolExecutor(len(jobs))
    futures = {}
    for j in jobs:
        if j[0] == "generated":
            futures[f"{j[1]} {j[3]}"] = ex.submit(_build.compile_generated, j[1], j[2])
        else:
            futures[" ".join(str(p) for p in j[:2])] = ex.submit(_build.compile_source, *j)
    ex.shutdown(wait=False)
    return futures


def report_builds(futures):
    """Waits for the builds of `futures` and prints ptxas's register and
    shared-memory report and each kernel's SASS instruction count.
    {name: (path, seconds, report)}."""
    results = {name: f.result() for name, f in futures.items()}
    for name, (path, seconds, log) in results.items():
        print(f"build: {os.path.relpath(path, HERE)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())
        for kernel, n in sass_counts(path).items():
            print(f"  sass: {n} instructions in {kernel}")
    return results


def build_all(_build, jobs=("rowwise_mg", "rowwise")):
    """start_builds, then report_builds."""
    return report_builds(start_builds(_build, jobs))


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
        from odil_torch.ops import mg_ablation, probes

        self.wrappers = {
            "backward_mg": rmg.backward_mg_cuda, "forward_mg": rmg.forward_mg_cuda,
            "backward_mg2": rmg.backward_mg2_cuda,
            "backward_rows": rw.backward_cuda, "forward_rows": rw.forward_cuda,
            "backward_stream": rw.backward_stream_cuda, "forward_stream": rw.forward_stream_cuda,
            "backward_halo": rw.backward_halo_cuda, "forward_halo": rw.forward_halo_cuda,
            "backward_mg_local": rmg.backward_mg_local_cuda, "plain_on_card": rw.plain_on_card,
            "backward_halo_rows1d": rw.backward_halo_rows1d_cuda, "forward_halo_rows1d": rw.forward_halo_rows1d_cuda,
            "copy3": probes.copy3_cuda, "fma": probes.fma_cuda,
            "backward_trivial_row": mg_ablation.backward_trivial_row_cuda,
            "backward_no_matmul": mg_ablation.backward_no_matmul_cuda,
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
    rows, _ = run("heat_tmax", ["--Nt", "64", "--Nx", "64", "--epochs", str(HEAT_TMAX_EPOCHS), "--history_every",
                                "200"], f"heat_tmax CLI (64^2 fp64, lbfgs, {HEAT_TMAX_EPOCHS} epochs)", lbfgs=True)
    ref_tmax = [r for r in read_rows("ref_heat_tmax.csv") if int(float(r["epoch"])) <= HEAT_TMAX_EPOCHS]
    converged_gate(rows, ref_tmax, {"norm_eqn": 3.0, "norm_imp": 3.0, "loss": 10.0}, "heat_tmax CLI", tag)
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


def rows_gate(got, want, columns, what, tag, rtol, spread=None, floor=True, only=None, whose="the JAX package's"):
    """Every value within rtol of the reference row's (`rtol` a number or a
    list by row; `whose` names the reference, by default the JAX package's
    rows), or twice `spread` (the JAX package's own spread by row and column
    when its CG operator changes by one ulp), or, with `floor`, both below
    1e-12 of epoch 0's loss (1e-6 of its norms); `only` limits the gate to
    those epochs.  Returns the largest relative distance; fails on any other
    value."""
    if [r[0] for r in got] != [r[0] for r in want]:
        fail(f"{what}: rows at epochs {[r[0] for r in got]}, {whose} at {[r[0] for r in want]}")
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
    print(f"{what}: largest relative distance from {whose} rows {worst:.3e} {tag}")
    if bad:
        fail(f"{what}: rows off {whose} (epoch, column, card, reference, limit): {bad[:6]}")
    return worst


def newton_phase(torch, counters, tag, extra_argv=()):
    """Phase o: the run scripts' Newton and Gauss-Newton cases as CLIs
    through ``util.optimize`` (no kernel on their path), each against the
    JAX package's rows of ``odil_torch/data/newton_rows.json``.  Prints each
    case's ms/epoch and wall time, a Newton epoch's split (the
    linearization's gradients on the card with their copy to the host, the
    assembly and the solve on the host, the update), a Gauss-Newton epoch's
    normal matvecs, CG iterations and host syncs, and the device of the
    iterate.  Returns poisson gn's (rows, ms/epoch, normal matvecs an
    epoch) with plain CG, for phase q.  extra_argv goes to every CLI (a
    rehearsal on the CPU passes --device)."""
    import shutil

    from odil_torch.examples import heat as heat_cli

    with open(NEWTON_DATA) as fh:
        data = json.load(fh)["cases"]
    none = dict.fromkeys(counters.read(), 0)
    last = {}  # the ms/epoch and normal matvecs an epoch of the last run

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
        last.update(ms=log_ms(log), matvecs=stats.get("matvecs", 0) / n)
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
        if name == "poisson_gn":
            poisson_gn = (rows, last["ms"], last["matvecs"])
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
    return poisson_gn


def dist_build(torch, np, model, mesh, dev, heat_ref):
    """Phase r's problems, built the same way in its workers and for the
    single controller: the flagship of phase j, heat of phase e (from its
    initial net) and wave of phase g (fp32), on `mesh`."""
    from odil_torch.models import heat as th
    from odil_torch.models import veltracer as vt
    from odil_torch.models import wave as tw

    if model == "flagship":
        return vt.build(*SIZES["256"], kernel="pallas_mg", device=dev, mesh=mesh, partition=HALO_PART)
    nt, nx = SIZES_1D["64"]
    if model == "wave":
        return tw.build(nt=nt, nx=nx, dtype=np.float32, kernel="pallas", device=dev, mesh=mesh, partition=HALO1D_PART)
    lane = heat_ref["config"]
    problem, state, extra = th.build(nt=lane["nt"], nx=lane["nx"], infer_k=True, imposed=lane["imposed"],
                                     nimp=lane["nimp"], seed=lane["seed"], kernel="pallas", device=dev, mesh=mesh,
                                     partition=HALO1D_PART)
    net = state.fields["k_net"]
    net.weights = [torch.tensor(w, dtype=torch.float32, device=dev) for w in heat_ref["weights"]]
    net.biases = [torch.tensor(b, dtype=torch.float32, device=dev) for b in heat_ref["biases"]]
    return problem, state, extra


# The runs of each phase-r job: (model, halo route, epochs, Adam's lr).
DIST_RUNS = {
    "r1": [("flagship", "generic", DIST_R1_EPOCHS, 0.01), ("flagship", "mg", DIST_R1_EPOCHS, 0.01)],
    "r2": [("heat", "generic", DIST_1D_EPOCHS, 1e-3), ("wave", "generic", DIST_1D_EPOCHS, 1e-3)],
    "r3": [("flagship", "generic", DIST_NCCL_EPOCHS, 0.01)],
}


def dist_worker(job, rank, world, port, out):
    """One process of a phase-r job (``chip_smoke.py --dist-worker``): joins
    the group (gloo for r1 and r2, whose processes share the card; NCCL for
    r3), trains each of the job's runs through the halo route on this
    process's arrays, and writes its losses, ms/epoch and kernel launches
    to ``<out>.<rank>.json``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import torch.distributed as dist

    from odil_torch import comm, parallel
    from odil_torch.ops import rowwise as rw
    from odil_torch.ops import rowwise_mg as rmg
    from odil_torch.optim import Adam

    backend = "nccl" if job == "r3" else "gloo"
    parallel.init_distributed(f"localhost:{port}", world, rank, backend=backend, timeout=DIST_TIMEOUT)
    dev = parallel.local_device()
    counters = Counters(rmg, rw)
    with open(HEAT_DATA) as fh:
        heat_ref = json.load(fh)
    result = {"backend": backend, "transport": comm.transport(), "device": str(dev), "runs": {}}
    for model, fuse, n, lr in DIST_RUNS[job]:
        spec, shards = (HALO_SPEC, HALO_SHARDS) if model == "flagship" else (HALO1D_SPEC, HALO1D_SHARDS)
        mesh = parallel.mesh_from_spec(spec) if world > 1 else parallel.mesh_from_spec(spec, devices=[dev] * shards)
        problem, state, _ = dist_build(torch, np, model, mesh, dev, heat_ref)
        grad_fn = problem.make_loss_grad_fn(state, halo=True, halo_fuse=fuse)
        if grad_fn is None or grad_fn.route != fuse:
            fail(f"phase {job}: make_loss_grad_fn(halo=True, halo_fuse={fuse!r}) gave "
                 f"{None if grad_fn is None else grad_fn.route!r} on process {rank}")
        x0 = parallel.shard_state_arrays(problem.domain, problem.domain.arrays_from_state(state))
        grad = grad_distance(torch, problem.domain, grad_fn, x0, f"{out}.grad_{fuse}.pt", rank) if job == "r1" else None
        counters.zero()
        _, losses, chunk_ms = train(torch, Adam, grad_fn, x0, n, lr=lr)
        result["runs"][f"{model} {fuse}"] = {
            "losses": losses, "ms": steady_ms(chunk_ms)[0], "counts": counters.read(), "grad": grad,
            "block": list(x0[0].shape), "shards": len([o for o in mesh.owners.reshape(-1) if o == rank]),
        }
    with open(f"{out}.{rank}.json", "w") as fh:
        json.dump(result, fh)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def grad_distance(torch, domain, grad_fn, x0, path, rank):
    """This process's epoch-0 gradient against the single controller's
    (the whole arrays saved in `path`): for each array, max|g - ref| over
    max|ref| on this process's block of it (``Domain.field_sharding``'s
    region; a non-grid array whole).  Returns the largest and its array."""
    _, grads = grad_fn(x0, {"epoch": 0})
    ref = torch.load(path)
    worst = (0.0, None)
    for i, (g, r) in enumerate(zip(grads, ref)):
        r = r.to(g.device)
        if r.ndim == domain.ndim:
            region = domain.field_sharding(shape=tuple(r.shape)).region(tuple(r.shape), rank)
            r = r[tuple(slice(lo, hi) for lo, hi in region)]
        if g.shape != r.shape:
            fail(f"phase r1: process {rank}'s gradient of array {i} has the shape {tuple(g.shape)}, its block of the "
                 f"single controller's {tuple(r.shape)}")
        rel = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        worst = max(worst, (rel, i), key=lambda w: w[0])
    return worst


def dist_out(job):
    """The stem of a phase-r job's files under build/."""
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    return os.path.join(HERE, "build", f"chip_smoke_{job}")


def dist_command(job, rank, world, port, out, epochs):
    """The command line of one phase-r worker."""
    return [sys.executable, os.path.abspath(__file__), "--epochs", str(epochs), "--dist-worker", job, str(rank),
            str(world), str(port), out]


def dist_launch(job, world, epochs, tag):
    """Runs the `world` processes of a phase-r job and reads their results
    (by rank); a process that fails, or outlasts DIST_TIMEOUT, fails the
    phase (the others are killed)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = dist_out(job)
    for r in range(world):
        if os.path.exists(f"{out}.{r}.json"):
            os.remove(f"{out}.{r}.json")
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    logs = [open(f"{out}.{r}.log", "w+") for r in range(world)]  # files, not pipes: no writer waits on a reader
    procs = [subprocess.Popen(dist_command(job, r, world, port, out, epochs), cwd=HERE, env=env, stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"phase {job}: a process outlasted {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"phase {job}: process {r} of {world} exited {p.returncode}: {text[-3000:]}")
        for line in text.splitlines():
            if line.startswith("init_distributed:"):
                print(f"  {job}: {line} {tag}")
    results = []
    for r in range(world):
        with open(f"{out}.{r}.json") as fh:
            results.append(json.load(fh))
    return results


def dist_phase(torch, np, counters, halo_losses, j_ms, ref256, heat_ref, epochs, tag):
    """Phase r (the module docstring): the halo route over several processes.
    `halo_losses`/`j_ms`: phase j's losses and ms/epoch by route (the single
    controller on the mesh of four shards of the card).  Returns the
    launches of the kernels on its paths, summed over the processes."""
    from odil_torch import parallel
    from odil_torch.optim import Adam

    dev = torch.device(DEVICE)
    launches = {}
    none = dict.fromkeys(counters.read(), 0)

    def same_on_every_rank(results, run):
        first = results[0]["runs"][run]["losses"]
        if any(r["runs"][run]["losses"] != first for r in results[1:]):
            fail(f"phase r: the {run} losses differ between the processes")
        return first

    def expect(results, run, key, per_rank):
        for rank, res in enumerate(results):
            expect_counts(res["runs"][run]["counts"], dict(none, **{key: per_rank}), f"phase r {run} on process {rank}")
        return per_rank * len(results)

    # r1: the flagship on t:2,x:2, one shard a process, four processes on the
    # card over gloo.  Before it, on the single controller (phase j's mesh
    # of four shards of the card): each route's epoch-0 gradient, saved for
    # the workers to meet on their blocks, and the spread that one-ulp
    # gradient noise opens in its rows (three seeds, as r2 and phase p).
    t_r = time.perf_counter()
    mesh = parallel.mesh_from_spec(HALO_SPEC, devices=[dev] * HALO_SHARDS)
    spreads = {}
    for fuse in ("generic", "mg"):
        j_rows = trajectory_rows(halo_losses[fuse])

        def single(seed=None):
            problem, state, _ = dist_build(torch, np, "flagship", mesh, dev, heat_ref)
            grad_fn = problem.make_loss_grad_fn(state, halo=True, halo_fuse=fuse)
            if grad_fn is None or grad_fn.route != fuse:
                fail(f"phase r1: the single controller's halo route is not {fuse!r}")
            return grad_fn if seed is None else one_ulp_moves(torch, grad_fn, seed, dev), problem, state

        grad_fn, problem, state = single()
        _, grads = grad_fn(problem.domain.arrays_from_state(state), {"epoch": 0})
        torch.save([g.detach().cpu() for g in grads], f"{dist_out('r1')}.grad_{fuse}.pt")
        del grad_fn, grads
        spread = 0.0
        for seed in ROUNDOFF_SEEDS:
            grad_fn, problem, state = single(seed)
            moved = trajectory_rows(train(torch, Adam, grad_fn, problem.domain.arrays_from_state(state),
                                          DIST_R1_EPOCHS, lr=DIST_RUNS["r1"][0][3])[1])
            spread = max(spread, max(abs(moved[e] - j_rows[e]) / abs(j_rows[e]) for e in moved))
        spreads[fuse] = spread
    results = dist_launch("r1", HALO_SHARDS, epochs, tag)
    for fuse, key, name in (("generic", "backward_halo", "backward_halo_sums"),
                            ("mg", "backward_mg_local", "backward_mg_local_sums")):
        run = f"flagship {fuse}"
        losses = same_on_every_rank(results, run)
        launches[name] = expect(results, run, key, len(losses))
        rows, j_rows = trajectory_rows(losses), trajectory_rows(halo_losses[fuse])
        ref_rel = {e: abs(rows[e] - ref256[e]) / abs(ref256[e]) for e in rows if e in ref256}
        j_rel = {e: abs(rows[e] - j_rows[e]) / abs(j_rows[e]) for e in rows if e in j_rows}
        worst_ref, worst_j = max(ref_rel, key=ref_rel.get), max(j_rel, key=j_rel.get)
        band = 2 * spreads[fuse]
        grads = [tuple(r["runs"][run]["grad"]) for r in results]
        grad_rel, grad_rank = max((g[0], n) for n, g in enumerate(grads))
        info = results[0]["runs"][run]
        print(f"r1 halo {fuse} over {len(results)} processes (gloo, {info['shards']} shard a process, block "
              f"{tuple(info['block'])}): {len(losses)} epochs, epoch 0 {rows[0]!r} vs phase j's {j_rows[0]!r} (rel "
              f"{j_rel[0]:.2e}, the same bits: {rows[0] == j_rows[0]}); epoch-0 gradient against the single "
              f"controller's, largest max|diff|/max|g| {grad_rel:.3e} (process {grad_rank}, array "
              f"{grads[grad_rank][1]}; limit {DIST_GRAD_LIMIT:.0e}); largest row distance from phase j's epoch "
              f"{worst_j} ({100 * j_rel[worst_j]:.4f}%) within {100 * band:.4f}% (one-ulp noise opens "
              f"{100 * spreads[fuse]:.4f}%); worst row against ref_velt_256.csv epoch {worst_ref} "
              f"({100 * ref_rel[worst_ref]:.2f}%); {launches[name]} launches of {key} ({len(results)} an epoch); "
              f"{info['ms']:.4f} ms/epoch (process 0) against phase j's {j_ms[fuse]:.4f} {tag}")
        if j_rel[0] > 1e-5:
            fail(f"r1 halo {fuse}: epoch-0 loss {rows[0]} differs from phase j's {j_rows[0]} (limit 1e-5)")
        if grad_rel > DIST_GRAD_LIMIT:
            fail(f"r1 halo {fuse}: process {grad_rank}'s epoch-0 gradient of array {grads[grad_rank][1]} leaves the "
                 f"single controller's by {grad_rel:.3e} of its largest entry (limit {DIST_GRAD_LIMIT:.0e})")
        if j_rel[worst_j] > band:
            fail(f"r1 halo {fuse}: epoch {worst_j} is {100 * j_rel[worst_j]:.4f}% from phase j's row, outside twice "
                 f"the one-ulp noise spread ({100 * band:.4f}%)")
        bad = [e for e, r in ref_rel.items() if r > 0.15]
        if ref_rel[0] > 1e-5 or bad:
            fail(f"r1 halo {fuse}: rows {bad} leave ref_velt_256.csv by more than 15% (epoch 0 rel {ref_rel[0]:.2e})")

    # r2: heat and wave on t:4 over two processes of two shards, against the
    # single controller on the mesh of four shards of the card.  The
    # processes add the gradient's rows that several shards read in another
    # order than the single controller, so the band is phase p's for heat:
    # twice the spread that one-ulp gradient noise opens in the single
    # controller's trajectory (three seeds), and at least g.'s 1%.
    results = dist_launch("r2", DIST_1D_PROCS, epochs, tag)
    mesh = parallel.mesh_from_spec(HALO1D_SPEC, devices=[dev] * HALO1D_SHARDS)
    every = 20
    for model in ("heat", "wave"):
        run = f"{model} generic"
        losses = same_on_every_rank(results, run)
        key = f"backward_halo_rows1d_sums_{model}_64"
        launches[key] = expect(results, run, "backward_halo_rows1d", HALO1D_SHARDS // DIST_1D_PROCS * len(losses))
        lr = DIST_RUNS["r2"][0][3]

        def single(seed=None):
            problem, state, _ = dist_build(torch, np, model, mesh, dev, heat_ref)
            grad_fn = problem.make_loss_grad_fn(state, halo=True)
            if seed is not None:
                grad_fn = one_ulp_moves(torch, grad_fn, seed, dev)
            return train(torch, Adam, grad_fn, problem.domain.arrays_from_state(state), len(losses), lr=lr)

        def distance(a, b):
            return {e: abs(a[max(e - 1, 0)] - b[max(e - 1, 0)]) / abs(b[max(e - 1, 0)])
                    for e in range(0, len(a) + 1, every)}

        counters.zero()
        _, base, chunk_ms = single()
        expect_counts(counters.read(), dict(none, backward_halo_rows1d=HALO1D_SHARDS * len(base)),
                      f"phase r {model} on the single controller")
        spread = max(max(distance(single(seed)[1], base).values()) for seed in ROUNDOFF_SEEDS)
        band = max(0.01, 2 * spread)
        rel = distance(losses, base)
        worst = max(rel, key=rel.get)
        print(f"r2 {model} 64^2 on {HALO1D_SPEC} over {len(results)} processes of "
              f"{results[0]['runs'][run]['shards']} shards (gloo): {len(losses)} epochs, epoch 0 {losses[0]!r} vs the "
              f"single controller's {base[0]!r} (rel {rel[0]:.2e}); worst {every}-epoch row epoch {worst} "
              f"({100 * rel[worst]:.4f}%) within {100 * band:.4f}% (one-ulp noise opens {100 * spread:.4f}%); final "
              f"{losses[-1]!r} vs {base[-1]!r}; {launches[key]} launches of the masked backward+sums; "
              f"{results[0]['runs'][run]['ms']:.4f} ms/epoch (process 0) against the single controller's "
              f"{steady_ms(chunk_ms)[0]:.4f} {tag}")
        if rel[0] > 1e-5 or rel[worst] > band:
            fail(f"r2 {model}: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} {100 * rel[worst]:.3f}% (limit "
                 f"{100 * band:.3f}%)")

    # r3: one process over NCCL at world size 1: phase j's generic route.
    (res,) = dist_launch("r3", 1, epochs, tag)
    run = res["runs"]["flagship generic"]
    losses = run["losses"]
    launches["backward_halo_sums"] += expect([res], "flagship generic", "backward_halo", HALO_SHARDS * len(losses))
    same = losses == halo_losses["generic"][: len(losses)]
    print(f"r3 halo generic, one process, backend {res['backend']} ({res['transport']}): {len(losses)} epochs, rows "
          f"equal to phase j's first {len(losses)} to the bit: {same}; {run['ms']:.4f} ms/epoch {tag}")
    if not same:
        fail("r3: the rows over NCCL at world size 1 differ from phase j's")
    print(f"phase r: {time.perf_counter() - t_r:.1f} s {tag}")
    return launches


# Phase s: the routes beside --halo over several processes.  Its jobs: s12
# (four processes sharing the card over gloo: the flagship's GSPMD route on
# MESH_SPEC, s1 pallas_mg and s2 its plain operator), s34 (two processes: s3
# the poisson gn CLI under --halo, s4 multi_start with the batch axis over
# the processes) and s5 (one process in an NCCL group, s1's problem).
ROUTES_EPOCHS = {"s1": 100, "s2": 20, "s4": 50, "s5": 50}
ROUTES_PROCS = {"s12": 4, "s34": 2, "s5": 1}
S2_LOSS_RTOL = 1e-6


def count_collectives(comm, world):
    """Counts this process's collective rounds and the bytes it sends in
    them (``comm._exchange`` and the all_gathers of ``psum_table``,
    ``allsum`` and the object gathers): {"rounds", "bytes"}, zeroed by the
    caller."""
    import torch.distributed as dist

    stats = {"rounds": 0, "bytes": 0}
    exchange, all_gather = comm._exchange, dist.all_gather

    def counted_exchange(sends, recvs):
        stats["rounds"] += 1
        stats["bytes"] += sum(t.numel() * t.element_size() for _, _, t in sends)
        return exchange(sends, recvs)

    def counted_all_gather(parts, t, *a, **k):
        stats["rounds"] += 1
        stats["bytes"] += t.numel() * t.element_size() * (world - 1)
        return all_gather(parts, t, *a, **k)

    comm._exchange, dist.all_gather = counted_exchange, counted_all_gather
    return stats


def block_of(domain, ref, rank):
    """This process's block of the whole array ``ref`` (``Domain.field_sharding``'s region)."""
    if ref.ndim != domain.ndim:
        return ref
    region = domain.field_sharding(shape=tuple(ref.shape)).region(tuple(ref.shape), rank)
    return ref[tuple(slice(lo, hi) for lo, hi in region)]


def routes_worker(job, rank, world, port, out):
    """One process of a phase-s job (``chip_smoke.py --dist-worker s..``):
    joins the group (gloo for s12 and s34, whose processes share the card;
    NCCL for s5), runs the job's routes on this process's blocks, and writes
    its rows, ms/epoch, collectives and launches to ``<out>.<rank>.json``."""
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import torch.distributed as dist

    from odil_torch import comm, newton, parallel
    from odil_torch.models import poisson as tpo
    from odil_torch.models import veltracer as vt
    from odil_torch.ops import rowwise as rw
    from odil_torch.ops import rowwise_mg as rmg
    from odil_torch.optim import Adam
    from odil_torch.optim.base import autograd_loss_grad_fn as loss_grad_of

    backend = "nccl" if job == "s5" else "gloo"
    parallel.init_distributed(f"localhost:{port}", world, rank, backend=backend,
                              device=None if DEVICE == "cuda" else DEVICE, timeout=DIST_TIMEOUT)
    dev = parallel.local_device()
    counters = Counters(rmg, rw)
    stats = count_collectives(comm, world)
    result = {"backend": backend, "transport": comm.transport(), "device": str(dev), "runs": {}}
    stem = os.path.join(os.path.dirname(out), "chip_smoke_s")

    def gspmd_run(name, kernel, epochs):
        mesh = parallel.mesh_from_spec(MESH_SPEC) if world > 1 else parallel.mesh_from_spec(MESH_SPEC,
                                                                                             devices=[dev] * 4)
        problem, state, _ = vt.build(*SIZES["256"], kernel=kernel, device=dev, mesh=mesh, partition=MESH_PART)
        domain = problem.domain
        counters.zero()
        loss0, grads0, *_ = problem.eval_loss_grad(state)
        eval_counts = counters.read()
        grad_fn = problem.make_loss_grad_fn(state) or loss_grad_of(problem.make_loss_fn(state)[0])
        x0 = parallel.shard_state_arrays(domain, domain.arrays_from_state(state))
        ref = torch.load(f"{stem}_{kernel}.pt")
        _, grads = grad_fn(x0, {"epoch": 0})
        mine = [block_of(domain, r.to(dev), rank) for r in ref["grads"]]
        if any(g.shape != r.shape for g, r in zip(grads, mine)):
            fail(f"phase {name}: process {rank}'s gradient blocks {[tuple(g.shape) for g in grads]}, the single "
                 f"controller's {[tuple(r.shape) for r in mine]}")
        grad = {
            "bits": all(torch.equal(g, r) for g, r in zip(grads, mine))
            and all(torch.equal(g, r) for g, r in zip(grads0, mine)),
            "max_rel": max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30) for g, r in zip(grads, mine)),
        }
        if "grads64" in ref:
            err, ok, worst = close_floor(grads, mine, [block_of(domain, r.to(dev), rank) for r in ref["grads64"]])
            grad.update(close_floor=ok, err=err, worst=worst_text(worst))
        counters.zero()
        stats.update(rounds=0, bytes=0)
        _, losses, chunk_ms = train(torch, Adam, grad_fn, x0, epochs, lr=0.01)
        result["runs"][name] = {
            "spans": domain.mesh.spans_processes, "loss0": float(loss0),
            "grad": grad, "eval_counts": eval_counts, "losses": losses, "ms": steady_ms(chunk_ms)[0],
            "counts": counters.read(), "rounds": stats["rounds"] / epochs, "mb": stats["bytes"] / epochs / 1e6,
            "block": list(x0[0].shape),
        }

    if job in ("s12", "s5"):
        for name, kernel in (("s1", "pallas_mg"), ("s2", "xla")) if job == "s12" else (("s5", "pallas_mg"),):
            gspmd_run(name, kernel, ROUTES_EPOCHS[name])
    else:
        # s3: the poisson gn CLI of q1 under --mesh x:2,y:2 --halo 1, each
        # process's iterate digested after every step.
        digests = []
        step = newton.gauss_newton_step

        def recorded(*a, **k):
            x, info = step(*a, **k)
            digests.append(hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest())
            return x, info

        newton.gauss_newton_step = recorded
        with open(NEWTON_DATA) as fh:
            case = json.load(fh)["cases"]["poisson_gn"]
        extra = [] if DEVICE == "cuda" else ["--device", DEVICE]
        stats.update(rounds=0, bytes=0)
        csv_rows, log, counts, (problem, state), seconds = run_cli(
            torch, counters, "poisson", case["argv"] + ["--mesh", MESH_SPEC_XY, "--halo", "1"] + extra)
        newton.gauss_newton_step = step
        epochs = problem.solver_stats["epochs"]
        result["runs"]["s3"] = {
            "rows": value_rows(csv_rows, case["columns"]), "digests": digests, "counts": counts,
            "ms": log_ms(log), "seconds": seconds, "matvecs": problem.solver_stats["matvecs"] / epochs,
            "rounds": stats["rounds"] / epochs, "mb": stats["bytes"] / epochs / 1e6,
        }
        # s4: multi_start with its batch axis over the processes, q3's cases.
        mesh = parallel.mesh_from_spec(f"b:{world}")
        with open(HEAT_DATA) as fh:
            lane = json.load(fh)["config"]
        builds = {
            "poisson": (lambda: tpo.build(n=64, ndim=2, args=argparse.Namespace(ref="osc", rhs="exact", osc_k=2.0,
                                                                                  mgloss=0),
                                          dtype=np.float64, device=dev), 0, 0.5),
            "heat": (lambda: heat_lane_build(torch, np, lane, dev), 2, 0.05),
        }
        for model, (build, seed, scale) in builds.items():
            p, st, _ = build()
            loss_b, stacked = parallel.multi_start(p, st, STARTS, seed=seed, scale=scale, mesh=mesh, batch_axis="b")
            loss_fn, _ = p.make_loss_fn(st)
            o = Adam(loss_grad_of(loss_b), stacked, lr=1e-3)

            def row():
                with torch.no_grad():
                    return [float(loss_fn([a[i] for a in o.x], p.tracers)[0]) for i in range(len(o.x[0]))]

            rows, losses, ms, counts = [row()], [], [], dict.fromkeys(counters.read(), 0)
            stats.update(rounds=0, bytes=0)
            for _ in range(ROUTES_EPOCHS["s4"] // CHUNK):
                counters.zero()
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                out_ = o.run_chunk(CHUNK, p.tracers)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t_start) * 1e3 / CHUNK)
                counts = {k: counts[k] + v for k, v in counters.read().items()}
                losses += out_.cpu().tolist()
                rows.append(row())
            result["runs"][f"s4 {model}"] = {
                "form": loss_b.form, "instances": loss_b.instances, "losses": losses, "rows": rows,
                "ms": steady_ms(ms)[0], "counts": counts, "rounds": stats["rounds"] / len(losses),
                "mb": stats["bytes"] / len(losses) / 1e6,
            }
    with open(f"{out}.{rank}.json", "w") as fh:
        json.dump(result, fh)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def routes_phase(torch, np, counters, heat_ref, q_refs, poisson_gn, j_ms, tag):
    """Phase s (the module docstring): the GSPMD route, Gauss-Newton and
    ``multi_start`` over several processes.  `q_refs`: phase q's rows and
    ms/epoch; `poisson_gn`: phase o's; `j_ms`: phase j's ms/epoch by halo
    route.  Returns the launches of the kernels on its paths, summed over
    the processes."""
    from odil_torch import parallel
    from odil_torch.models import veltracer as vt
    from odil_torch.optim import Adam
    from odil_torch.optim.base import autograd_loss_grad_fn as loss_grad_of

    dev = torch.device(DEVICE)
    none = dict.fromkeys(counters.read(), 0)
    t_s = time.perf_counter()
    stem = dist_out("s")

    def same_on_every_rank(results, run, key="losses"):
        first = results[0]["runs"][run][key]
        if any(r["runs"][run][key] != first for r in results[1:]):
            fail(f"phase s: the {run} {key} differ between the processes")
        return first

    # The single controller of s1, s2 and s5: the GSPMD route on the mesh of
    # four shards of the card (q4's unsharded evaluation), its epoch-0
    # gradient saved for the workers to meet on their blocks.
    single = {}
    mesh = parallel.mesh_from_spec(MESH_SPEC, devices=[dev] * 4)
    for kernel, epochs in (("pallas_mg", ROUTES_EPOCHS["s1"]), ("xla", ROUTES_EPOCHS["s2"])):
        problem, state, _ = vt.build(*SIZES["256"], kernel=kernel, device=dev, mesh=mesh, partition=MESH_PART)
        grad_fn = problem.make_loss_grad_fn(state) or loss_grad_of(problem.make_loss_fn(state)[0])
        x0 = problem.domain.arrays_from_state(state)
        loss0 = float(problem.eval_loss_grad(state)[0])
        ref = {"grads": [g.detach().cpu() for g in grad_fn(x0, {"epoch": 0})[1]]}
        spread = None
        if kernel == "xla":
            p64, s64, _ = vt.build(*SIZES["256"], kernel="xla", dtype=np.float64, device=dev)
            ref["grads64"] = [g.detach().cpu() for g in p64.eval_loss_grad(s64)[1]]
            del p64, s64
        torch.save(ref, f"{stem}_{kernel}.pt")
        _, losses, chunk_ms = train(torch, Adam, grad_fn, x0, epochs, lr=0.01)
        if kernel == "xla":
            spread = 0.0
            for seed in ROUNDOFF_SEEDS:
                moved = train(torch, Adam, one_ulp_moves(torch, grad_fn, seed, dev), x0, epochs, lr=0.01)[1]
                spread = max(spread, max(abs(a - b) / abs(b) for a, b in zip(moved, losses)))
        single[kernel] = (loss0, losses, steady_ms(chunk_ms)[0], spread)
        del problem, state, grad_fn, x0, ref

    launches = {}
    results = dist_launch("s12", ROUTES_PROCS["s12"], ROUTES_EPOCHS["s1"], tag)
    loss0, rows0, ms0, _ = single["pallas_mg"]
    run = "s1"
    losses = same_on_every_rank(results, run)
    infos = [r["runs"][run] for r in results]
    info = infos[0]
    per_rank = {k: v for k, v in info["counts"].items() if v}
    for rank, i in enumerate(infos):
        expect_counts(i["counts"], dict(none, backward_mg=len(losses), backward_mg_with_sums=len(losses)),
                      f"phase s1 on process {rank}")
        expect_counts(i["eval_counts"], dict(none, forward_mg=1, backward_mg=1),
                      f"phase s1's epoch 0 on process {rank}")
    launches["backward_mg_sums"] = len(losses) * len(infos)
    launches["forward_mg"] = launches["backward_mg"] = len(infos)
    bits = all(i["grad"]["bits"] for i in infos)
    print(f"s1 GSPMD pallas_mg (64x256x256, {MESH_SPEC}) over {len(results)} processes (gloo, one shard each, block "
          f"{tuple(info['block'])}): epoch 0 {info['loss0']!r} vs the single "
          f"controller's {loss0!r} (the same bits: {info['loss0'] == loss0}); every process's block of the epoch-0 "
          f"gradient the single controller's to the bit: {bits}; {len(losses)} rows equal to its to the bit: "
          f"{losses == rows0}; {info['ms']:.4f} ms/epoch (process 0) against the single controller's {ms0:.4f}, phase "
          f"q4's veltracer CLI {q_refs['q4 ms']['veltracer']:.4f} and phase j's mg halo route {j_ms['mg']:.4f}; an "
          f"epoch {info['rounds']:.1f} exchange rounds, {info['mb']:.3f} MB sent by process 0; launches a process "
          f"{per_rank} {tag}")
    if not info["spans"] or info["loss0"] != loss0 or not bits or losses != rows0:
        fail(f"s1: mesh over processes {info['spans']}, epoch 0 the same bits {info['loss0'] == loss0}, gradient "
             f"blocks the same bits {bits}, rows the same bits {losses == rows0}")

    run = "s2"
    loss0, rows0, ms0, spread = single["xla"]
    losses = same_on_every_rank(results, run)
    infos = [r["runs"][run] for r in results]
    info = infos[0]
    for rank, i in enumerate(infos):
        expect_counts(i["counts"], none, f"phase s2 on process {rank}")
    rel0 = abs(info["loss0"] - loss0) / abs(loss0)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, rows0)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    band = 2 * spread
    floor_ok = all(i["grad"]["close_floor"] for i in infos)
    print(f"s2 GSPMD xla (64x256x256 fp32, {MESH_SPEC}) over {len(results)} processes (gloo, one shard each): "
          f"epoch 0 {info['loss0']!r} vs the single controller's {loss0!r} (rel {rel0:.2e}, limit "
          f"{S2_LOSS_RTOL:.0e}); epoch-0 gradient blocks within close_floor on every process: {floor_ok} (largest "
          f"max|d| {max(i['grad']['err'] for i in infos):.3e}, process 0 {info['grad']['worst']}; the same bits "
          f"{all(i['grad']['bits'] for i in infos)}); {len(losses)} rows (the same bits {losses == rows0}), "
          f"the largest distance epoch {worst} ({100 * rel[worst]:.5f}%) within {100 * band:.5f}% (one-ulp noise "
          f"opens {100 * spread:.5f}%); {info['ms']:.4f} ms/epoch (process 0) against the single controller's "
          f"{ms0:.4f}; an epoch {info['rounds']:.1f} exchange rounds, {info['mb']:.3f} MB sent by process 0; no "
          f"kernel {tag}")
    if not info["spans"] or rel0 > S2_LOSS_RTOL or not floor_ok or rel[worst] > band:
        fail(f"s2: mesh over processes {info['spans']}, epoch 0 rel {rel0:.2e}, gradient within close_floor "
             f"{floor_ok}, epoch {worst} {100 * rel[worst]:.5f}% (band {100 * band:.5f}%)")

    # s3 and s4: two processes.  s4's band for heat: twice the spread that
    # one-ulp gradient noise opens in the single controller's batch rows
    # (q3's case, three seeds).
    lane = heat_ref["config"]
    p, st, _ = heat_lane_build(torch, np, lane, dev)
    loss_b, stacked = parallel.multi_start(p, st, STARTS, seed=2, scale=0.05)
    heat_rows = q_refs["q3 heat"]
    heat_spread = 0.0
    for seed in ROUNDOFF_SEEDS:
        o = Adam(one_ulp_moves(torch, loss_grad_of(loss_b), seed, dev), stacked, lr=1e-3)
        moved = sum((o.run_chunk(CHUNK, p.tracers).cpu().tolist() for _ in range(ROUTES_EPOCHS["s4"] // CHUNK)), [])
        heat_spread = max(heat_spread, max(abs(a - b) / abs(b) for a, b in zip(moved, heat_rows)))
    q_refs["q3 heat spread"] = heat_spread  # phase t's band for q3's heat rows
    del p, st, loss_b, stacked

    results = dist_launch("s34", ROUTES_PROCS["s34"], ROUTES_EPOCHS["s4"], tag)
    with open(NEWTON_DATA) as fh:
        case = json.load(fh)["cases"]["poisson_gn"]
    rows = same_on_every_rank(results, "s3", "rows")
    digests = [r["runs"]["s3"]["digests"] for r in results]
    same_x = all(d == digests[0] for d in digests) and len(digests[0]) > 0
    info = results[0]["runs"]["s3"]
    for rank, r in enumerate(results):
        expect_counts(r["runs"]["s3"]["counts"], none, f"phase s3 on process {rank}")
    what = (f"s3 poisson gn CLI (64^2 fp64, plain CG) under --mesh {MESH_SPEC_XY} --halo 1 over {len(results)} "
            f"processes of two shards (gloo)")
    q1_rows, q1_ms = q_refs["q1"]
    rows_gate(rows, q1_rows, case["columns"], what + " (rtol 1e-7 or twice the JAX package's own spread)", tag, 1e-7,
              spread=case["jax_spread"], whose="phase q1's")
    print(f"{what}: every process's iterate the same bits after each of {len(digests[0])} steps: {same_x}; "
          f"{info['ms']:.4f} ms/epoch, {info['matvecs']:.1f} normal matvecs an epoch, {info['rounds']:.1f} collective "
          f"rounds and {info['mb']:.3f} MB sent by process 0 an epoch; q1 {q1_ms:.4f} ms/epoch, phase o "
          f"{poisson_gn[1]:.4f} {tag}")
    if not same_x:
        fail("s3: the processes' iterates differ")
    for model, ref_rows, rtol in (("poisson", q_refs["q3 poisson"], 1e-12), ("heat", heat_rows, 2 * heat_spread)):
        run = f"s4 {model}"
        losses = same_on_every_rank(results, run)
        infos = [r["runs"][run] for r in results]
        ref = ref_rows[: len(losses)]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        inst_rel = 0.0
        for i in infos:
            for got, want in zip(i["rows"], q_refs["q3 heat rows"]) if model == "heat" else ():
                for n, k in enumerate(i["instances"]):
                    inst_rel = max(inst_rel, abs(got[n] - want[k]) / abs(want[k]))
        per = len(infos[0]["instances"])
        if model == "heat":
            for rank, i in enumerate(infos):
                expect_counts(i["counts"], dict(none, forward_rows=per * len(losses), backward_rows=per * len(losses)),
                              f"phase s4 heat on process {rank}")
            launches["forward_rows_heat_64"] = launches["backward_rows_heat_64"] = per * len(losses) * len(infos)
        instances = [i["instances"] for i in infos]
        print(f"s4 multi_start {model} ({STARTS} starts, batch axis over {len(results)} processes, instances "
              f"{instances}, form {infos[0]['form']}): {len(losses)} batch-mean rows against q3's, the largest "
              f"distance epoch {worst} ({rel[worst]:.3e}, limit {rtol:.3e}); "
              + (f"every instance's rows against q3's same instance largest rel {inst_rel:.2e}; " if model == "heat"
                 else "") + f"{infos[0]['ms']:.4f} ms/epoch (process 0), {infos[0]['rounds']:.1f} collective rounds "
              f"and {infos[0]['mb']:.6f} MB sent an epoch {tag}")
        if sorted(sum(instances, [])) != list(range(STARTS)) or rel[worst] > rtol or inst_rel > max(rtol, 1e-5):
            fail(f"s4 {model}: instances {instances}, epoch {worst} rel {rel[worst]:.3e} (limit {rtol:.3e}), instance "
                 f"rows rel {inst_rel:.2e}")

    (res,) = dist_launch("s5", ROUTES_PROCS["s5"], ROUTES_EPOCHS["s5"], tag)
    run = res["runs"]["s5"]
    rows0 = single["pallas_mg"][1]
    same = run["losses"] == rows0[: len(run["losses"])]
    expect_counts(run["counts"], dict(none, backward_mg=len(run["losses"]), backward_mg_with_sums=len(run["losses"])),
                  "phase s5")
    launches["backward_mg_sums"] += len(run["losses"])
    print(f"s5 GSPMD pallas_mg, one process in a group of one, backend {res['backend']} ({res['transport']}; the "
          f"mesh over processes: {run['spans']}, so no collective runs); "
          f"{len(run['losses'])} epochs, rows equal to s1's single controller's first {len(run['losses'])} to the bit: "
          f"{same}; epoch-0 gradient the same bits: {run['grad']['bits']}; {run['ms']:.4f} ms/epoch {tag}")
    if run["spans"] or not same or not run["grad"]["bits"]:
        fail("s5: the rows or the epoch-0 gradient over NCCL at world size 1 differ from the single controller's")
    print(f"phase s: {time.perf_counter() - t_s:.1f} s {tag}")
    return launches


# Phase t: the routes that open on a mesh over several processes in PR 16.
# Its jobs: t13 (four processes sharing the card over gloo: t1 the
# flagship's L-BFGS on the GSPMD route, t3 the flagship's halo mg route on a
# mesh with an idle axis) and t24 (two processes: t2 the wave CLI's L-BFGS
# under --halo, t4 multi_start on a domain mesh over the processes).  t5,
# the ctx.mod surface on the card, runs in the script's own process.
T_ITERS, T_HALO_EPOCHS = 20, 100
T_PROCS = {"t13": 4, "t24": 2}
T_IDLE_SPEC, T_IDLE_PART = "t:2,q:2", {"t": "t"}
T_WAVE_ARGV = ["--Nt", "64", "--Nx", "64", "--kernel", "pallas", "--double", "0", "--epochs", "200",
               "--history_every", "20", "--mesh", "t:2", "--halo", "1"]
# multi_start's forms on a domain mesh over the processes: form -> (mesh
# spec, owners or None for process-major, batch axis).  "a": the domain's t
# over the processes, every instance on each process's blocks; "b_b"/"b_t":
# one mesh for the domain (t) and the instances (b), a process a b index or
# a t index.
T_MS_FORMS = {"a": ("t:2", None, None), "b_b": ("b:2,t:2", None, "b"), "b_t": ("b:2,t:2", [[0, 1], [0, 1]], "b")}
# The ctx.mod names whose results are exact (no reduction, no rounding of
# a transcendental): the card's bits are the CPU's.
MOD_EXACT = {
    "abs", "argmax", "argmin", "broadcast_to", "clip", "concatenate", "floor", "full", "hstack", "maximum", "min",
    "max", "minimum", "moveaxis", "ones", "ones_like", "pad", "reshape", "roll", "square", "stack", "transpose",
    "where", "zeros", "zeros_like", "flatten", "relu", "cast", "gather_nd", "split_by_sizes", "array", "constant",
    "variable", "copy", "native", "meshgrid", "median", "arange",
}


def digest_iterates(lbfgs):
    """Records a digest of each whole L-BFGS iterate as the recursion meets
    it (``_Memory.direction``); returns (the list, a one-entry list of the
    seconds the digests took, a function that undoes the wrapping)."""
    import hashlib

    digests, spent = [], [0.0]
    direction = lbfgs._Memory.direction

    def recorded(self, x, g):
        t_start = time.perf_counter()
        digests.append(hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest())
        spent[0] += time.perf_counter() - t_start
        return direction(self, x, g)

    lbfgs._Memory.direction = recorded
    return digests, spent, lambda: setattr(lbfgs._Memory, "direction", direction)


def lbfgs_run(torch, counters, mesh, dev, stats=None):
    """t1's run: the flagship (64x256x256, pallas_mg) on `mesh` through
    ``util.optimize(args, "lbfgs", ...)``, T_ITERS iterations, a row every
    iteration.  Returns its rows, the digest of the whole iterate at each
    iteration and at the end, ms/iteration (the wall of util.optimize, its
    epoch-0 evaluation and the callback's state gathers included), the
    evaluations and host syncs an iteration, the memory, the launches and
    (with `stats`) the collective rounds and MB a process an iteration.  The
    iterates' digests (a host copy of the whole state each) are timed apart
    and left out of ms/iteration."""
    import hashlib

    from odil_torch import util
    from odil_torch.models import veltracer as vt
    from odil_torch.optim import lbfgs

    problem, state, _ = vt.build(*SIZES["256"], kernel="pallas_mg", device=dev, mesh=mesh, partition=MESH_PART)
    rows = []

    def callback(state, epoch, pinfo):
        rows.append(float(pinfo["loss"]))

    callback.every_epoch = True
    args = argparse.Namespace(epochs=T_ITERS, epoch_start=0, lr=0.01, halo=0)
    digests, spent, restore = digest_iterates(lbfgs)
    counters.zero()
    if stats is not None:
        stats.update(rounds=0, bytes=0)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    try:
        util.optimize(args, "lbfgs", problem, state, callback)
    finally:
        restore()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    opt = problem._active_optimizer
    digests.append(hashlib.sha256(opt.x.detach().cpu().numpy().tobytes()).hexdigest())
    out = {"rows": rows, "digests": digests, "ms": (seconds - spent[0]) * 1e3 / opt.evals, "iters": opt.evals,
           "digest_ms": spent[0] * 1e3 / opt.evals,
           "evals": opt.grad_evals / opt.evals, "syncs": opt.host_syncs / opt.evals,
           "memory_mb": opt.memory_bytes / 1e6, "memory_shape": list(opt.memory.s.shape), "counts": counters.read(),
           "grad_evals": opt.grad_evals, "spans": problem.domain.mesh.spans_processes}
    if stats is not None:
        out.update(rounds=stats["rounds"] / opt.evals, mb=stats["bytes"] / opt.evals / 1e6)
    return out


def idle_build(torch, mesh, dev, spec_part):
    """t3's problem: the flagship (64x256x256, pallas_mg) on `mesh`, its
    halo mg route."""
    from odil_torch.models import veltracer as vt

    problem, state, _ = vt.build(*SIZES["256"], kernel="pallas_mg", device=dev, mesh=mesh, partition=spec_part)
    grad_fn = problem.make_loss_grad_fn(state, halo=True, halo_fuse="mg")
    if grad_fn is None or grad_fn.route != "mg":
        fail(f"phase t3: the halo route on {mesh.shape} is {None if grad_fn is None else grad_fn.route!r}, not 'mg'")
    return problem, state, grad_fn


def idle_run(torch, Adam, grad_fn, domain, x0, counters, stats, stem, dev, rank):
    """t3's run on this process's blocks `x0`: the epoch-0 loss, the
    digest of the epoch-0 gradient's blocks and their largest distance from
    the one-process run's (saved under `stem`), T_HALO_EPOCHS Adam epochs,
    the launches, the collectives and the ms/epoch."""
    import hashlib

    ref = torch.load(f"{stem}_idle.pt")
    (loss0, _), grads = grad_fn(x0, {"epoch": 0})
    mine = [block_of(domain, r.to(dev), rank) for r in ref["grads"]]
    if any(g.shape != r.shape for g, r in zip(grads, mine)):
        fail(f"phase t3: process {rank}'s gradient blocks {[tuple(g.shape) for g in grads]}, the one-process run's "
             f"{[tuple(r.shape) for r in mine]}")
    rel = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30) for g, r in zip(grads, mine))
    digest = hashlib.sha256(b"".join(g.detach().cpu().numpy().tobytes() for g in grads)).hexdigest()
    counters.zero()
    stats.update(rounds=0, bytes=0)
    _, losses, chunk_ms = train(torch, Adam, grad_fn, x0, T_HALO_EPOCHS, lr=0.01)
    return {"loss0": float(loss0), "grad_rel": rel, "grad_digest": digest, "losses": losses,
            "ms": steady_ms(chunk_ms)[0], "counts": counters.read(), "rounds": stats["rounds"] / T_HALO_EPOCHS,
            "mb": stats["bytes"] / T_HALO_EPOCHS / 1e6, "block": list(x0[0].shape),
            "t_index": domain.mesh.box()["t"][0]}


def heat_lane_build(torch, np, lane, dev, mesh=None):
    """q3's heat problem (64^2, pallas), on `mesh` with t partitioned."""
    from odil_torch.models import heat as th

    return th.build(nt=lane["nt"], nx=lane["nx"], kernel="pallas", infer_k=True, imposed=lane["imposed"],
                    nimp=lane["nimp"], seed=lane["seed"], device=dev, mesh=mesh,
                    partition={"t": "t"} if mesh is not None else None)


def spanning_worker(job, rank, world, port, out):
    """One process of a phase-t job (``chip_smoke.py --dist-worker t..``):
    joins the group (gloo: the processes share the card), runs the job's
    routes on this process's blocks, and writes its rows, digests, ms,
    collectives and launches to ``<out>.<rank>.json``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import torch.distributed as dist

    from odil_torch import comm, parallel
    from odil_torch.ops import rowwise as rw
    from odil_torch.ops import rowwise_mg as rmg
    from odil_torch.optim import Adam, lbfgs
    from odil_torch.optim.base import autograd_loss_grad_fn as loss_grad_of

    parallel.init_distributed(f"localhost:{port}", world, rank, backend="gloo",
                              device=None if DEVICE == "cuda" else DEVICE, timeout=DIST_TIMEOUT)
    dev = parallel.local_device()
    counters = Counters(rmg, rw)
    stats = count_collectives(comm, world)
    result = {"transport": comm.transport(), "device": str(dev), "runs": {}}
    stem = os.path.join(os.path.dirname(out), "chip_smoke_t")
    if job == "t13":
        result["runs"]["t1"] = lbfgs_run(torch, counters, parallel.mesh_from_spec(MESH_SPEC), dev, stats)
        # t3: the halo mg route on t:2,q:2; q partitions nothing, so the
        # processes at q 0 and q 1 are replicas.
        problem, state, grad_fn = idle_build(torch, parallel.mesh_from_spec(T_IDLE_SPEC), dev, T_IDLE_PART)
        domain = problem.domain
        x0 = parallel.shard_state_arrays(domain, domain.arrays_from_state(state))
        result["runs"]["t3"] = idle_run(torch, Adam, grad_fn, domain, x0, counters, stats, stem, dev, rank)
    else:
        # t3's second reference: the same route on t:2 over the two processes
        # (no idle axis), which t3's replicas must meet to the bit.
        problem, state, grad_fn = idle_build(torch, parallel.mesh_from_spec("t:2"), dev, T_IDLE_PART)
        domain = problem.domain
        x0 = parallel.shard_state_arrays(domain, domain.arrays_from_state(state))
        result["runs"]["t3 ref"] = idle_run(torch, Adam, grad_fn, domain, x0, counters, stats, stem, dev, rank)
        # t2: the wave CLI (its default optimizer, L-BFGS) under --mesh t:2
        # --halo 1, one shard a process.
        extra = [] if DEVICE == "cuda" else ["--device", DEVICE]
        digests, _, restore = digest_iterates(lbfgs)
        stats.update(rounds=0, bytes=0)
        try:
            rows, log, counts, (problem, _), seconds = run_cli(torch, counters, "wave", T_WAVE_ARGV + extra)
        finally:
            restore()
        opt = problem._active_optimizer
        result["runs"]["t2"] = {
            "rows": rows, "digests": digests, "counts": counts, "ms": log_ms(log), "seconds": seconds,
            "iters": opt.evals, "grad_evals": opt.grad_evals, "syncs": opt.host_syncs / opt.evals,
            "memory_mb": opt.memory_bytes / 1e6, "rounds": stats["rounds"] / opt.evals,
            "mb": stats["bytes"] / opt.evals / 1e6, "spans": problem.domain.mesh.spans_processes,
        }
        # t4: multi_start on q3's heat problem with the domain's mesh over the
        # processes, in each form.
        with open(HEAT_DATA) as fh:
            lane = json.load(fh)["config"]
        for form, (spec, owners, batch_axis) in T_MS_FORMS.items():
            mesh = parallel.mesh_from_spec(spec)
            if owners is not None:
                mesh = parallel.Mesh(mesh.devices, mesh.axis_names, owners=owners)
            p, st, _ = heat_lane_build(torch, np, lane, dev, mesh)
            loss_b, stacked = parallel.multi_start(p, st, STARTS, seed=2, scale=0.05,
                                                   mesh=mesh if batch_axis else None, batch_axis=batch_axis)
            loss_fn, _ = p.make_loss_fn(st)
            o = Adam(loss_grad_of(loss_b), stacked, lr=1e-3)

            def row():
                with torch.no_grad():
                    return [float(loss_fn([a[i] for a in o.x], p.tracers)[0]) for i in range(len(o.x[0]))]

            rows, losses, ms, counts = [row()], [], [], dict.fromkeys(counters.read(), 0)
            stats.update(rounds=0, bytes=0)
            for _ in range(STARTS_KERNEL_EPOCHS // CHUNK):
                counters.zero()
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                out_ = o.run_chunk(CHUNK, p.tracers)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t_start) * 1e3 / CHUNK)
                counts = {k: counts[k] + v for k, v in counters.read().items()}
                losses += out_.cpu().tolist()
                rows.append(row())
            result["runs"][f"t4 {form}"] = {
                "form": loss_b.form, "instances": loss_b.instances, "losses": losses, "rows": rows,
                "ms": steady_ms(ms)[0], "counts": counts, "rounds": stats["rounds"] / len(losses),
                "mb": stats["bytes"] / len(losses) / 1e6, "block": list(stacked[0].shape),
            }
    with open(f"{out}.{rank}.json", "w") as fh:
        json.dump(result, fh)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def mod_cases(np):
    """name -> fn(mod, A) over fp32 numpy draws (A: numpy to the mod's
    tensors): every public name of the ctx.mod surface that computes."""
    rng = np.random.default_rng(16)
    x = rng.normal(size=(64, 48)).astype(np.float32)
    y = rng.normal(size=(64, 48)).astype(np.float32)
    p = (np.abs(x) + 0.5).astype(np.float32)  # the reductions' inputs: no cancellation to magnify roundoff
    c = rng.normal(size=(2, 3, 4)).astype(np.float32)
    idx = np.array([[0, 1], [63, 47], [5, 9]])
    conv_in = {nd: rng.normal(size=(33, 32, 16)[:nd]).astype(np.float32) for nd in (1, 2, 3)}
    conv_k = {nd: rng.normal(size=(3, 3, 3)[:nd]).astype(np.float32) for nd in (1, 2, 3)}
    tr_in = {nd: rng.normal(size=(2,) + (17, 16, 8)[:nd] + (3,)).astype(np.float32) for nd in (0, 1, 2, 3)}
    tr_k = {nd: rng.normal(size=(3, 3, 3)[:nd] + (3, 4)).astype(np.float32) for nd in (0, 1, 2, 3)}
    return {
        "abs": lambda m, A: m.abs(A(x)), "arange": lambda m, A: [m.arange(7), m.arange(0.0, 1.0, 0.125)],
        "arctan2": lambda m, A: m.arctan2(A(x), A(y)),
        "argmax": lambda m, A: [m.argmax(A(x)), m.argmax(A(x), axis=1)],
        "argmin": lambda m, A: [m.argmin(A(x)), m.argmin(A(x), axis=0)],
        "broadcast_to": lambda m, A: m.broadcast_to(A(x[0]), (5, 48)),
        "clip": lambda m, A: m.clip(A(x), -0.5, 0.5),
        "concatenate": lambda m, A: [m.concatenate([A(x), A(y)], axis=1), m.concatenate([A(x), A(y)], axis=None)],
        "cos": lambda m, A: m.cos(A(x)), "cosh": lambda m, A: m.cosh(A(x)),
        "cumsum": lambda m, A: [m.cumsum(A(p), axis=0), m.cumsum(A(p))],
        "einsum": lambda m, A: m.einsum("ij,kj->ik", A(p), A(p)), "exp": lambda m, A: m.exp(A(x)),
        "floor": lambda m, A: m.floor(A(3 * x)), "full": lambda m, A: [m.full((3, 4), 2.5), m.full(3, 2)],
        "hstack": lambda m, A: m.hstack([A(x), A(y)]),
        "linspace": lambda m, A: [m.linspace(0, 1, 65), m.linspace(-1, 1, 16, endpoint=False)],
        "log": lambda m, A: m.log(A(p)), "matmul": lambda m, A: m.matmul(A(p), A(p.T.copy())),
        "maximum": lambda m, A: m.maximum(A(x), A(y)), "mean": lambda m, A: [m.mean(A(p)), m.mean(A(p), axis=0)],
        "median": lambda m, A: [m.median(A(x)), m.median(A(x), axis=0)],
        "meshgrid": lambda m, A: list(m.meshgrid(A(x[0]), A(y[:, 0].copy()))),
        "minimum": lambda m, A: m.minimum(A(x), A(y)), "moveaxis": lambda m, A: m.moveaxis(A(c), 0, -1),
        "ones": lambda m, A: m.ones((3, 4)), "ones_like": lambda m, A: m.ones_like(A(x)),
        "pad": lambda m, A: [m.pad(A(x), ((1, 2), (3, 0)))] + [m.pad(A(x), 2, mode=k) for k in ("wrap", "edge")],
        "reshape": lambda m, A: m.reshape(A(x), (96, 32)), "roll": lambda m, A: m.roll(A(x), (1, -2), (0, 1)),
        "sin": lambda m, A: m.sin(A(x)), "sinh": lambda m, A: m.sinh(A(x)),
        "sqrt": lambda m, A: m.sqrt(A(np.abs(x))), "square": lambda m, A: m.square(A(x)),
        "stack": lambda m, A: m.stack([A(x), A(y)], axis=1), "std": lambda m, A: [m.std(A(p)), m.std(A(p), axis=1)],
        "sum": lambda m, A: [m.sum(A(p)), m.sum(A(p), axis=0)], "tanh": lambda m, A: m.tanh(A(x)),
        "transpose": lambda m, A: m.transpose(A(c)), "where": lambda m, A: m.where(A(x) > 0, A(x), 0.5),
        "zeros": lambda m, A: m.zeros((3, 4)), "zeros_like": lambda m, A: m.zeros_like(A(x)),
        "min": lambda m, A: [m.min(A(x)), m.min(A(x), axis=0)], "max": lambda m, A: [m.max(A(x)), m.max(A(x), axis=1)],
        "flatten": lambda m, A: m.flatten(A(x)), "relu": lambda m, A: m.relu(A(x)),
        "sigmoid": lambda m, A: m.sigmoid(A(x)), "norm": lambda m, A: m.norm(A(p)),
        "cast": lambda m, A: [m.cast(A(x), np.float64), m.cast(A(3 * x), np.int32)],
        "gather_nd": lambda m, A: m.gather_nd(A(x), A(idx)),
        "split_by_sizes": lambda m, A: m.split_by_sizes(A(x), [16, 48], axis=0),
        "array": lambda m, A: m.array(x), "constant": lambda m, A: m.constant(x),
        "variable": lambda m, A: m.variable(x), "copy": lambda m, A: m.copy(A(x)), "native": lambda m, A: m.native(x),
        "convolution": lambda m, A: [m.convolution(A(conv_in[nd]), A(conv_k[nd]), s, p) for nd in (1, 2, 3)
                                     for s in (1, 2) for p in ("VALID", "SAME")],
        "conv_transpose": lambda m, A: [m.conv_transpose(A(tr_in[nd]), A(tr_k[nd]), strides=s, padding=p)
                                        for nd in (0, 1, 2, 3) for s in (1, 2) for p in ("VALID", "SAME")],
    }


def mod_phase(torch, np, tag):
    """t5: every computing name of ``ModTorch`` on the card against its
    result on the CPU (the same fp32 inputs): a tensor on the card, of the
    CPU result's shape and dtype, the same bits where the operation is exact
    (``MOD_EXACT``), else within 1e-6 relative (atol 1e-6 of the largest
    entry); the convolutions with TF32 off; ``random`` on the card: its
    shapes, dtypes, a seed's draws twice the same and the moments of 1e6
    draws."""
    from odil_torch.backend import ModTorch

    card, cpu = ModTorch(DEVICE, x64=False), ModTorch("cpu", x64=False)
    bad, worst = [], (0.0, None)
    cases = mod_cases(np)
    for name, fn in cases.items():
        got = fn(card, lambda a: torch.from_numpy(a).to(DEVICE))
        want = fn(cpu, torch.from_numpy)
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        for g, w in zip(got, want):
            if g.device.type != torch.device(DEVICE).type or g.shape != w.shape or g.dtype != w.dtype:
                bad.append(f"{name}: {g.device} {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
                continue
            g = g.cpu()
            if name in MOD_EXACT or not w.is_floating_point():
                if not torch.equal(g, w):
                    bad.append(f"{name}: not the CPU's bits")
                continue
            err = float((g.double() - w.double()).abs().max()) if w.numel() else 0.0
            scale = float(w.double().abs().max()) if w.numel() else 1.0
            worst = max(worst, (err / max(scale, 1e-30), name), key=lambda t: t[0])
            if err > 1e-6 * max(scale, 1.0):
                bad.append(f"{name}: max|d| {err:.3e} (max|w| {scale:.3e})")
    tf32 = torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32
    card.random.set_seed(7)
    a = card.random.normal((1000000,), mean=1.5, stddev=2.0)
    card.random.set_seed(7)
    b = card.random.normal((1000000,), mean=1.5, stddev=2.0)
    u = card.random.uniform((1000000,), minval=-1.0, maxval=3.0)
    n = a.numel()
    moments = (abs(float(a.double().mean()) - 1.5) < 5 * 2.0 / n ** 0.5
               and abs(float(a.double().std()) - 2.0) < 5 * 2.0 / (2 * n) ** 0.5
               and abs(float(u.double().mean()) - 1.0) < 5 * (16 / 12) ** 0.5 / n ** 0.5
               and float(u.min()) >= -1.0 and float(u.max()) < 3.0)
    rand_ok = (a.device.type == u.device.type == torch.device(DEVICE).type and a.dtype == u.dtype == torch.float32
               and torch.equal(a, b) and moments and isinstance(card.random.next_key(), torch.Generator))
    print(f"t5 ctx.mod on the card: {len(cases)} names against the CPU, {sum(n in MOD_EXACT for n in cases)} held "
          f"to the bit; the largest relative distance of the others {worst[0]:.2e} ({worst[1]}); TF32 after the "
          f"convolutions: {tf32}; random on the card (shapes, dtypes, one seed's draws twice the same, moments of "
          f"1e6 draws): {rand_ok} {tag}")
    if bad or tf32 or not rand_ok:
        fail(f"t5: {bad[:10]}, TF32 {tf32}, random {rand_ok}")


def spanning_phase(torch, np, counters, q_refs, tag, extra_argv=()):
    """Phase t (the module docstring): L-BFGS over processes, --halo with an
    idle mesh axis over processes, multi_start on a domain mesh over the
    processes, and the ctx.mod surface on the card.  `q_refs`: phase q's
    rows (and s4's heat spread).  Returns the launches of the kernels on its
    paths, summed over the processes.  extra_argv goes to the wave CLI of
    this process (a rehearsal on the CPU passes --device)."""
    from odil_torch import parallel
    from odil_torch.optim import Adam, lbfgs

    dev = torch.device(DEVICE)
    none = dict.fromkeys(counters.read(), 0)
    t_t = time.perf_counter()
    stem = dist_out("t")
    launches = {}

    def same_on_every_rank(results, run, key):
        first = results[0]["runs"][run][key]
        if any(r["runs"][run][key] != first for r in results[1:]):
            fail(f"phase t: the {run} {key} differ between the processes")
        return first

    # The single controllers of t1 and t3 on the card: t1's L-BFGS on the mesh
    # of four shards of the card (the unsharded evaluation), t3's halo mg
    # route on t:2 of two shards of the card (its epoch-0 gradient saved for
    # the workers to meet on their blocks, and the spread that one-ulp
    # gradient noise opens in its rows, three seeds).
    single = lbfgs_run(torch, counters, parallel.mesh_from_spec(MESH_SPEC, devices=[dev] * 4), dev)
    one = parallel.mesh_from_spec("t:2", devices=[dev] * 2)
    problem, state, grad_fn = idle_build(torch, one, dev, T_IDLE_PART)
    x0 = problem.domain.arrays_from_state(state)
    torch.save({"grads": [g.detach().cpu() for g in grad_fn(x0, {"epoch": 0})[1]]}, f"{stem}_idle.pt")
    _, idle_rows, idle_ms = train(torch, Adam, grad_fn, x0, T_HALO_EPOCHS, lr=0.01)
    idle_spread = 0.0
    for seed in ROUNDOFF_SEEDS:
        moved = train(torch, Adam, one_ulp_moves(torch, grad_fn, seed, dev), x0, T_HALO_EPOCHS, lr=0.01)[1]
        idle_spread = max(idle_spread, max(abs(a - b) / abs(b) for a, b in zip(moved, idle_rows)))
    del problem, state, grad_fn, x0

    results13 = dist_launch("t13", T_PROCS["t13"], T_HALO_EPOCHS, tag)
    infos = [r["runs"]["t1"] for r in results13]
    rows = same_on_every_rank(results13, "t1", "rows")
    digests = same_on_every_rank(results13, "t1", "digests")
    info = infos[0]
    for rank, i in enumerate(infos):
        expect_counts(i["counts"], dict(none, forward_mg=1, backward_mg=i["grad_evals"] + 1,
                                        backward_mg_with_sums=i["grad_evals"]), f"phase t1 on process {rank}")
    launches["backward_mg_sums"] = sum(i["grad_evals"] for i in infos)
    launches["forward_mg"] = launches["backward_mg"] = len(infos)
    bits = rows == single["rows"] and digests == single["digests"]
    print(f"t1 L-BFGS pallas_mg (64x256x256, {MESH_SPEC}, the GSPMD route) over {len(infos)} processes (gloo): "
          f"{info['iters']} iterations; epoch 0 {rows[0]!r} vs the single controller's {single['rows'][0]!r}; "
          f"{len(rows)} rows and the whole iterate after every iteration equal to the single controller's to the "
          f"bit: {bits}; the same iterate bits on every process after each of {len(digests)} iterations: True; "
          f"{info['ms']:.4f} ms/iteration (process 0; util.optimize's wall, its epoch-0 evaluation and the callback's "
          f"state gathers included, the iterate's digests ({info['digest_ms']:.1f} ms an iteration) left out) against "
          f"the single controller's {single['ms']:.4f}; {info['evals']:.3f} "
          f"loss+grad evaluations and {info['syncs']:.3f} host syncs an iteration; {info['rounds']:.2f} collective "
          f"rounds and {info['mb']:.3f} MB sent by process 0 an iteration; L-BFGS memory {info['memory_mb']:.1f} MB "
          f"a process ({tuple(info['memory_shape'])} x2 fp32) {tag}")
    if not info["spans"] or not bits or len(rows) != T_ITERS + 1:
        fail(f"t1: mesh over processes {info['spans']}, rows and iterates the single controller's bits {bits}, "
             f"{len(rows)} rows")

    # t2 and t4: two processes.  t2's reference: the same CLI in this process
    # on t:2 of two shards of the card.
    digests0, _, restore = digest_iterates(lbfgs)
    try:
        wave_rows, wave_log, *_ = run_cli(torch, counters, "wave", T_WAVE_ARGV + list(extra_argv))
    finally:
        restore()
    results = dist_launch("t24", T_PROCS["t24"], T_HALO_EPOCHS, tag)
    rows = results[0]["runs"]["t2"]["rows"]
    if any([{k: v for k, v in r.items() if k not in NOT_VALUES} for r in res["runs"]["t2"]["rows"]]
           != [{k: v for k, v in r.items() if k not in NOT_VALUES} for r in rows] for res in results[1:]):
        fail("phase t: the t2 rows differ between the processes")
    digests = same_on_every_rank(results, "t2", "digests")
    infos = [r["runs"]["t2"] for r in results]
    for rank, i in enumerate(infos):
        expect_counts(i["counts"], dict(none, backward_halo_rows1d=i["grad_evals"],
                                        forward_rows=i["counts"]["forward_rows"],
                                        backward_rows=i["counts"]["backward_rows"]), f"phase t2 on process {rank}")
    launches["backward_halo_rows1d_sums_wave_64"] = sum(i["grad_evals"] for i in infos)
    info = infos[0]
    what = (f"t2 wave CLI (64^2 fp32 --kernel pallas, L-BFGS, 200 iterations) under --mesh t:2 --halo 1 over "
            f"{len(infos)} processes (gloo)")
    rows_bits = [float(r["loss"]) for r in rows] == [float(r["loss"]) for r in wave_rows]
    print(f"{what}: epoch 0 {rows[0]['loss']} vs the one-process run's {wave_rows[0]['loss']} (the same bits: "
          f"{rows[0]['loss'] == wave_rows[0]['loss']}); rows equal to it: {rows_bits}; the iterate the same bits on "
          f"both processes after each of {len(digests)} iterations: True (the one-process run's: "
          f"{digests == digests0}); "
          f"{info['ms']:.4f} ms/epoch (its train.log) against the one-process run's {log_ms(wave_log):.4f}; "
          f"{info['grad_evals'] / info['iters']:.3f} evaluations and {info['syncs']:.3f} host syncs an iteration; "
          f"{info['rounds']:.1f} collective rounds and {info['mb']:.4f} MB sent by process 0 an iteration; memory "
          f"{info['memory_mb']:.2f} MB {tag}")
    if not info["spans"] or rows[0]["loss"] != wave_rows[0]["loss"]:
        fail(f"t2: mesh over processes {info['spans']}, epoch 0 {rows[0]['loss']} vs {wave_rows[0]['loss']}")
    converged_gate(rows, read_rows("ref_wave.csv"), {"error_u": 1.3, "loss": 1.8}, what, tag)

    # t3 against the one-process run on t:2 (epoch 0 to the bit, the gradient
    # within r1's limit, the rows inside the one-ulp band) and against t24's
    # run of the same route on t:2 over two processes (no idle axis): every
    # replica's gradient blocks and rows to the bit.
    infos = [r["runs"]["t3"] for r in results13]
    refs = {r["runs"]["t3 ref"]["t_index"]: r["runs"]["t3 ref"] for r in results}
    losses = same_on_every_rank(results13, "t3", "losses")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, idle_rows)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    band = 2 * idle_spread
    grad_rel = max(i["grad_rel"] for i in infos)
    replica_bits = all(i["grad_digest"] == refs[i["t_index"]]["grad_digest"] for i in infos)
    ref_rows = refs[0]["losses"]
    for rank, i in enumerate(infos):
        expect_counts(i["counts"], dict(none, backward_mg_local=len(losses)), f"phase t3 on process {rank}")
    for i in refs.values():
        expect_counts(i["counts"], dict(none, backward_mg_local=len(losses)), "phase t3's reference over two processes")
    launches["backward_mg_local_sums"] = len(losses) * (len(infos) + len(refs))
    info = infos[0]
    print(f"t3 halo mg (64x256x256) on {T_IDLE_SPEC} (q partitions nothing: processes 0/1 and 2/3 are replicas) "
          f"over {len(infos)} processes (gloo, block {tuple(info['block'])}): epoch 0 {losses[0]!r} vs the one-process "
          f"t:2 run's {idle_rows[0]!r} (the same bits: {losses[0] == idle_rows[0]}); every process's gradient blocks "
          f"and {len(losses)} rows equal to those of the same route on t:2 over two processes to the bit: "
          f"{replica_bits and losses == ref_rows}; the epoch-0 gradient against the one-process run's, largest "
          f"max|diff|/max|g| {grad_rel:.3e} (limit {DIST_GRAD_LIMIT:.0e}); rows against the one-process run's (the "
          f"same bits {losses == idle_rows}), the largest distance epoch {worst} ({rel[worst]:.3e}) within "
          f"{band:.3e} (one-ulp noise opens {idle_spread:.3e}); {info['ms']:.4f} ms/epoch (process 0) against the "
          f"one-process run's {steady_ms(idle_ms)[0]:.4f} and two processes' {refs[0]['ms']:.4f}; "
          f"{info['rounds']:.1f} collective rounds and {info['mb']:.3f} MB sent by process 0 an epoch; one "
          f"local-block mg backward a process and epoch {tag}")
    if (losses[0] != idle_rows[0] or not replica_bits or losses != ref_rows or grad_rel > DIST_GRAD_LIMIT
            or rel[worst] > band):
        fail(f"t3: epoch 0 the same bits {losses[0] == idle_rows[0]}, replicas' gradient blocks and rows the "
             f"two-process run's {replica_bits} {losses == ref_rows}, gradient {grad_rel:.3e}, epoch {worst} rel "
             f"{rel[worst]:.3e} (band {band:.3e})")

    ref_rows, ref_inst = q_refs["q3 heat"], q_refs["q3 heat rows"]
    rtol = 2 * q_refs["q3 heat spread"]
    for form in T_MS_FORMS:
        run = f"t4 {form}"
        losses = same_on_every_rank(results, run, "losses")
        infos = [r["runs"][run] for r in results]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_rows)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        inst_rel = 0.0
        for i in infos:
            for got, want in zip(i["rows"], ref_inst):
                for n, k in enumerate(i["instances"]):
                    inst_rel = max(inst_rel, abs(got[n] - want[k]) / abs(want[k]))
        for rank, i in enumerate(infos):
            per = STARTS * len(losses)
            expect_counts(i["counts"], dict(none, forward_rows=per, backward_rows=per), f"phase t4 {form} on process {rank}")
        n = STARTS * len(losses) * len(infos)
        launches["forward_rows_heat_64"] = launches.get("forward_rows_heat_64", 0) + n
        launches["backward_rows_heat_64"] = launches.get("backward_rows_heat_64", 0) + n
        instances = [i["instances"] for i in infos]
        print(f"t4 multi_start heat 64^2 pallas, form {form} ({T_MS_FORMS[form][0]}, batch axis "
              f"{T_MS_FORMS[form][2]}; instances {instances}, stacked block {tuple(infos[0]['block'])}, loss_fn_b "
              f"{infos[0]['form']}): {len(losses)} batch-mean rows against q3's, the largest distance epoch {worst} "
              f"({rel[worst]:.3e}, limit {rtol:.3e}); every instance's rows against q3's same instance largest rel "
              f"{inst_rel:.2e}; {infos[0]['ms']:.4f} ms/epoch (process 0), {infos[0]['rounds']:.1f} collective rounds "
              f"and {infos[0]['mb']:.4f} MB sent an epoch {tag}")
        if infos[0]["form"] != "loop" or rel[worst] > rtol or inst_rel > max(rtol, 1e-5):
            fail(f"t4 {form}: form {infos[0]['form']}, epoch {worst} rel {rel[worst]:.3e} (limit {rtol:.3e}), "
                 f"instance rows rel {inst_rel:.2e}")

    mod_phase(torch, np, tag)
    print(f"phase t: {time.perf_counter() - t_t:.1f} s {tag}")
    return launches


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


def user_row_function(problem, rw):
    """The problem with every ``ctx.rowwise_terms`` call of its operator
    taking the bare row function, as a user's row function reaches it: no
    CUDA model, no hand adjoint (``rowwise.plain_on_card`` on the card)."""
    base = problem.operator

    def operator(ctx):
        call = ctx.rowwise_terms
        ctx.rowwise_terms = lambda model, *a, **k: call(rw.RowModel(model.row_fn), *a, **k)
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


class _Captured(Exception):
    pass


def rowwise_call(problem, state):
    """(the row model, (nterms, hist, fields, params, data, consts)) of a
    problem's row-wise call, captured from its operator: no row kernel
    runs."""
    from odil_torch.context import Context

    def capture(self, row_fn, keys, params=(), data=(), consts=(), nterms=1, hist=1, **kw):
        fields = tuple(self.field(k).detach() for k in keys)
        raise _Captured(row_fn, (nterms, hist, fields, tuple(p.detach() for p in params), tuple(data), tuple(consts)))

    import torch

    orig = Context.rowwise_terms
    Context.rowwise_terms = capture
    try:
        with torch.no_grad():
            problem.make_loss_fn(state)[0](problem.domain.arrays_from_state(state), problem.tracers)
    except _Captured as c:
        return c.args
    finally:
        Context.rowwise_terms = orig
    fail("the operator made no row-wise call")


def l_heat_args():
    """Phase l's heat configuration: keep_init=0, keep_frozen=1, the
    converged lane's stripe measurements."""
    with open(HEAT_DATA) as fh:
        lane = json.load(fh)["config"]
    return argparse.Namespace(
        infer_k=True, imposed="stripe", nimp=lane["nimp"], noise=0.0, seed=lane["seed"], kimp=2.0, kxreg=0.0,
        kxregdecay=0, ktreg=0.0, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=1, keep_init=0,
        solver="odil",
    )


def l_build(th, tw, np, which, size, dev, kernel="pallas", **kw):
    """(problem, state, extra) of phase l's configuration of `which` at
    SIZES_1D[size] (``kw``: a mesh and its partition)."""
    T, N = SIZES_1D[size]
    if which == "wave":
        return tw.build(nt=T, nx=N, dtype=np.float32, kernel=kernel, device=dev, **kw)
    return th.build(nt=T, nx=N, kernel=kernel, device=dev, args=l_heat_args(), **kw)


def traced_cases(th, tw, np, rw, dev):
    """{(model, size): (the bare row model, the hand model, the captured
    call, its traced CUDA counterpart)} of L_CASES: traced here, before any
    build, so that their libraries build with the others."""
    cases = {}
    for which, size in L_CASES:
        hand, call = rowwise_call(*l_build(th, tw, np, which, size, dev)[:2])
        user = rw.RowModel(hand.row_fn)
        spec, reason = rw._traced(user, *call)
        if spec is None:
            fail(f"phase l: the {which} row function at {size}^2 is refused by the tracer: {reason}")
        cases[(which, size)] = (user, hand, call, spec)
    return cases


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


def shard_records(torch, np, th, tw, heat_ref, which, T, N, dev, seed=14, heat_kw=None):
    """The recorded per-shard kernel calls (``halo._run_operators``) of heat
    (the converged lane's configuration, or the build arguments `heat_kw`)
    or wave (fp32) at (T, N) on the mesh t:4 of four shards of `dev`, at a
    seeded random state."""
    from odil_torch import halo, parallel

    mesh = parallel.mesh_from_spec(HALO1D_SPEC, devices=[dev] * HALO1D_SHARDS)
    lane = heat_ref["config"]
    if which == "heat":
        kw = heat_kw or dict(infer_k=True, imposed=lane["imposed"], nimp=lane["nimp"], seed=lane["seed"])
        p, s, _ = th.build(nt=T, nx=N, kernel="pallas", device=dev, mesh=mesh, partition=HALO1D_PART, **kw)
    else:
        p, s, _ = tw.build(nt=T, nx=N, dtype=np.float32, kernel="pallas", device=dev, mesh=mesh, partition=HALO1D_PART)
    rng = np.random.default_rng(seed)
    arrays = [torch.as_tensor((0.3 * rng.normal(size=tuple(a.shape))).astype(np.float32), device=dev)
              for a in p.domain.arrays_from_state(s)]
    plan = halo._HaloPlan(p, s)
    grid, params = halo._localize(p, plan, halo._mg_metas(p, s, plan), arrays)
    results = halo._run_operators(p, plan, halo._extended(plan, grid), params, p.tracers)
    return [r for ctx, _ in results for r in ctx.rowwise_deferred]


def one_ulp_moves(torch, grad_fn, seed, dev):
    """``grad_fn`` with every gradient entry moved one ulp up or down (a coin
    of the seed's generator for each entry and call): the size of the change
    a sum in another order makes."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def moved(arrays, tracers):
        out, grads = grad_fn(arrays, tracers)
        return out, [torch.where(torch.rand(g.shape, generator=gen, device=g.device) < 0.5,
                                 torch.nextafter(g, torch.full_like(g, float("inf"))),
                                 torch.nextafter(g, torch.full_like(g, -float("inf")))) for g in grads]

    return moved


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
        moved = one_ulp_moves(torch, problem.make_loss_grad_fn(state), seed, dev)
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


def traced_phase(torch, np, counters, cases, builds, report, launches, loops, tag):
    """Phase l (the module docstring): user row functions on 1-D planes on
    the traced kernels.  `cases`: traced_cases's.  Fills `report` and
    `launches` for the kernel table's entries of its paths and returns their
    timing entries (as main's `timed`), the hand kernels' calls on the same
    inputs and the slabbed launches beside the streaming ones."""
    from odil_torch.models import heat as th
    from odil_torch.models import wave as tw
    from odil_torch.ops import rowwise as rw
    from odil_torch.optim import Adam

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(19)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    none = dict.fromkeys(counters.read(), 0)
    wide = lambda ts: tuple(t.double() for t in ts)
    nbytes = lambda ts: 4 * sum(t.numel() for t in ts)
    source = "odil_torch/ops/rowtrace.py"
    timed, hand_calls, slabbed = {}, {}, {}

    for (which, size), (user, hand, call, spec) in cases.items():
        tr = spec.trace
        _, seconds, log = builds[f"rows1d_traced {which}_{size}"]
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        lib = spec.library(user)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = {m: n / sms for (_, m), n in lib._odil_rows1d_resident.items()}
        print(f"traced {which} row model at {size}^2 ({tr.name}): {tr.nfields} field, hist {tr.hist}, {tr.nterms} "
              f"terms, {tr.nparams} params, DUSED {tr.dused:#x}, {tr.ops_forward}/{tr.ops_backward} fp32 operations "
              f"a cell (forward/backward), BLOCKS_PER_SM {tr.blocks_per_sm}; built in {seconds:.1f} s; ptxas "
              f"registers {regs}, spill stores/loads {spills}; blocks an SM by mode {per_sm} {tag}")

    # l, kernels: the traced forward, backward+sums, backward and streaming
    # pair at 1024^2 against the plain version (autograd of the row
    # function) in fp64 and the hand kernel on the same inputs.
    for (which, size), (user, hand, call, spec) in cases.items():
        nt_, h, fs, ps, ds, cs_ = call
        fs = tuple(rand(*f.shape) + (0.5 if which == "heat" else 0.0) for f in fs)
        ps = tuple(p + rand(*p.shape) for p in ps)
        ds = tuple(d + rand(*d.shape) if i else d for i, d in enumerate(ds)) if which == "heat" else tuple(
            rand(*d.shape) for d in ds)
        c = (nt_, h, fs, ps, ds, cs_)
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        counters.zero()
        calls = (lambda: rw.forward_cuda(user, *c), lambda: rw.backward_cuda(user, *c, gs, True),
                 lambda: rw.backward_cuda(user, *c, gs, False), lambda: rw.forward_stream_cuda(user, *c),
                 lambda: rw.backward_stream_cuda(user, *c, gs, False))
        first = [f() for f in calls]
        again = [f() for f in calls]
        kf, (kd, kp, ks), (kd2, kp2, _), sf, (sd, sp, _) = first
        hf, (hd, hp, hs) = rw.forward_cuda(hand, *c), rw.backward_cuda(hand, *c, gs, True)
        pd, pp, psums = rw._backward_plain(user, nt_, h, wide(fs), wide(ps), wide(ds), wide(cs_), gs.double(), True)
        torch.cuda.synchronize()
        counts = counters.read()
        expect_counts(counts, dict(none, forward_rows=3, backward_rows=5, forward_stream=2, backward_stream=2),
                      f"the traced {which} kernels at {size}^2")
        bits = same_bits(torch, first, again) and same_bits(torch, [kf, (kd2, kp2)], [sf, (sd, sp)])
        e_f, ok_f = close(kf.double(), psums, TERMS_RTOL, 0.0)
        e_s, ok_s = close(ks.double(), psums, TERMS_RTOL, 0.0)
        e_g, ok_g = close_all([a.double() for a in kd + kp], list(pd) + list(pp))
        e_g2, ok_g2 = close_all([a.double() for a in kd2 + kp2], list(pd) + list(pp))
        e_sf, ok_sf = close(sf.double(), psums, TERMS_RTOL, 0.0)
        e_sg, ok_sg = close_all([a.double() for a in sd + sp], list(pd) + list(pp))
        e_hf, ok_hf = close(kf, hf, TERMS_RTOL, 0.0)
        e_hs, ok_hs = close(ks, hs, TERMS_RTOL, 0.0)
        e_hg, ok_hg = close_all(list(kd) + list(kp), list(hd) + list(hp))
        print(f"traced {which} kernels at {tuple(fs[0].shape)} against the plain version in fp64: forward max|d sums| "
              f"{e_f:.3e}, backward+sums max|d sums| {e_s:.3e} max|d (dfields, dparams)| {e_g:.3e}, backward {e_g2:.3e}, "
              f"stream forward {e_sf:.3e}, stream backward {e_sg:.3e}; against the hand kernel: forward {e_hf:.3e}, "
              f"sums {e_hs:.3e}, grads {e_hg:.3e}; the same bits call after call and streaming as slabbed: {bits} "
              f"{tag}")
        if not (ok_f and ok_s and ok_g and ok_g2 and ok_sf and ok_sg and ok_hf and ok_hs and ok_hg and bits):
            fail(f"a traced {which} kernel at {size}^2 disagrees: forward {ok_f}, sums {ok_s}, backward+sums {ok_g}, "
                 f"backward {ok_g2}, stream {ok_sf}/{ok_sg}, hand {ok_hf}/{ok_hs}/{ok_hg}, bits {bits}")
        del first, again, pd, pp
        key = f"traced_{which}_{size}"
        names = {"forward": f"forward_rows_{key}", "sums": f"backward_rows_sums_{key}",
                 "backward": f"backward_rows_{key}", "sforward": f"forward_stream_{key}",
                 "sbackward": f"backward_stream_{key}"}
        errors = {"forward": e_f, "sums": e_g, "backward": e_g2, "sforward": e_sf, "sbackward": e_sg}
        n_cells, f_in = fs[0].numel(), nbytes(fs + ps + ds + cs_)
        # The function's operations: the generator's count, or the hand
        # model's count of the same function where that is fewer (the traced
        # heat body runs the conductivity net at both faces of a cell, the
        # function needs one net a face; the generator counts both branches
        # of a where).
        hand_ops = {"heat": (OPS_HEAT_FORWARD, OPS_HEAT_BACKWARD), "wave": (OPS_WAVE_FORWARD, OPS_WAVE_BACKWARD)}[which]
        ops_f = min(spec.trace.ops_forward, hand_ops[0]) * n_cells
        ops_b = min(spec.trace.ops_backward, hand_ops[1]) * n_cells
        b_f, b_b = f_in + 4 * nt_, f_in + nbytes(fs + ps)
        # Each call takes the model: the traced one (user), the hand one, or
        # the plain version's (autograd of the bare row function).
        entries = {
            "forward": (lambda m, c=c: rw.forward_cuda(m, *c), lambda m, c=c: rw._forward_plain(m, *c), b_f, ops_f,
                        "odil_tpu/ops/rowwise.py:385"),
            "sums": (lambda m, c=c, gs=gs: rw.backward_cuda(m, *c, gs, True),
                     lambda m, c=c, gs=gs: rw._backward_plain(m, *c, gs, True), b_b + 8 * nt_, ops_b,
                     "odil_tpu/ops/rowwise.py:549"),
            "backward": (lambda m, c=c, gs=gs: rw.backward_cuda(m, *c, gs, False),
                         lambda m, c=c, gs=gs: rw._backward_plain(m, *c, gs, False), b_b + 4 * nt_, ops_b,
                         "odil_tpu/ops/rowwise.py:549"),
            "sforward": (lambda m, c=c: rw.forward_stream_cuda(m, *c), lambda m, c=c: rw._forward_plain(m, *c), b_f,
                         ops_f, "odil_tpu/ops/rowwise.py:676"),
            "sbackward": (lambda m, c=c, gs=gs: rw.backward_stream_cuda(m, *c, gs, False),
                          lambda m, c=c, gs=gs: rw._backward_plain(m, *c, gs, False), b_b + 4 * nt_, ops_b,
                          "odil_tpu/ops/rowwise.py:811"),
        }
        for what, (kfn, pfn, nb, ops, replaced) in entries.items():
            if size != "1024" and what != "sums":  # at 64^2 only what phase l's training runs
                continue
            name = names[what]
            report[name] = errors[what]
            timed[name] = (lambda kfn=kfn, u=user: kfn(u), lambda pfn=pfn, u=user: pfn(u), nb, ops, replaced, source)
            hand_calls[name] = lambda kfn=kfn, h=hand: kfn(h)
        slabbed[names["sforward"]] = lambda c=c, u=user: rw.forward_cuda(u, *c)
        slabbed[names["sbackward"]] = lambda c=c, gs=gs, u=user: rw.backward_cuda(u, *c, gs, False)

    def zero_state_loss(problem, state):
        loss_fn, _ = problem.make_loss_fn(state)
        with torch.no_grad():
            return float(loss_fn(problem.domain.arrays_from_state(state), problem.tracers)[0])

    def loss_only(problem, state, x, grad_fn, what):
        """The loss-only path at x: one traced forward and one traced
        backward; its loss and gradients against grad_fn's."""
        loss_fn, _ = problem.make_loss_fn(state)
        xs = [a.detach().clone().requires_grad_(True) for a in x]
        counters.zero()
        loss_e, _ = loss_fn(xs, problem.tracers)
        grads_e = torch.autograd.grad(loss_e, xs)
        torch.cuda.synchronize()
        expect_counts(counters.read(), dict(none, forward_rows=1, backward_rows=1), f"{what} loss-only path")
        (loss_t, _), grads_t = grad_fn(x, problem.tracers)
        e, ok = close_all(grads_e, grads_t)
        print(f"{what} loss-only vs one-pass route: loss {float(loss_e)!r} vs {float(loss_t)!r}, max|dgrad| {e:.3e} "
              f"{tag}")
        if abs(float(loss_e) - float(loss_t)) > TERMS_RTOL * abs(float(loss_t)) or not ok:
            fail(f"{what}: the loss-only path and the one-pass route disagree")

    def rel_rows(losses, base, every):
        rel = {e: abs(losses[max(e - 1, 0)] - base[max(e - 1, 0)]) / abs(base[max(e - 1, 0)])
               for e in range(0, len(losses) + 1, every)}
        return rel, max(rel, key=rel.get)

    # l. Heat 64^2 with its row function bare: the one-pass route on the
    # traced kernel, against the plain operator trained the same way.
    problem_n, state_n, _ = l_build(th, tw, np, "heat", "64", dev)
    user_row_function(problem_n, rw)
    grad_n = problem_n.make_loss_grad_fn(state_n)
    if grad_n is None:
        fail("make_loss_grad_fn declined heat's row function as a user row function")
    counters.zero()
    opt_n, losses_n, chunk_ms = train(torch, Adam, grad_n, problem_n.domain.arrays_from_state(state_n), L_EPOCHS,
                                      lr=1e-3)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses_n)),
                  "a user row function's training on the traced kernel")
    launches["backward_rows_sums_traced_heat_64"] = len(losses_n)
    loops["heat 64 keep_init=0 as a user row function (traced kernel)"] = (opt_n, steady_ms(chunk_ms))
    problem_x, state_x, _ = l_build(th, tw, np, "heat", "64", dev, kernel="xla")
    counters.zero()
    _, losses_x, chunk_x = train(torch, Adam, autograd_loss_grad_fn(torch, problem_x, state_x),
                                 problem_x.domain.arrays_from_state(state_x), L_EPOCHS, lr=1e-3)
    expect_counts(counters.read(), none, "heat keep_init=0 on the plain operator")
    rel, worst = rel_rows(losses_n, losses_x, L_EVERY)
    print(f"training (heat 64^2 keep_init=0 as a user row function, traced kernel, vs the plain operator): epoch-0 "
          f"loss {losses_n[0]!r} vs {losses_x[0]!r} (rel {rel[0]:.2e}); worst {L_EVERY}-epoch row epoch {worst} "
          f"({100 * rel[worst]:.4f}%); final {losses_n[-1]!r} vs {losses_x[-1]!r}; {steady_ms(chunk_ms)[0]:.4f} "
          f"ms/epoch against the plain operator's {steady_ms(chunk_x)[0]:.4f} {tag}")
    if rel[0] > 1e-5 or rel[worst] > 0.01:
        fail(f"phase l: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} {100 * rel[worst]:.3f}% (limit 1%)")
    loss_only(problem_n, state_n, opt_n.x, grad_n, "heat 64^2 as a user row function")
    del problem_n, state_n, grad_n, problem_x, state_x, opt_n

    # Heat and wave at 1024^2 with their row functions bare: the one-pass
    # route, the loss-only path and the streaming route (autograd of the
    # loss), epoch 0 within 1e-5 of the plain operator.
    for which in ("heat", "wave"):
        key = f"traced_{which}_1024"
        plain = zero_state_loss(*l_build(th, tw, np, which, "1024", dev, kernel="xla")[:2])
        problem_b, state_b, _ = l_build(th, tw, np, which, "1024", dev)
        user_row_function(problem_b, rw)
        grad_b = problem_b.make_loss_grad_fn(state_b)
        counters.zero()
        opt_b, losses, chunk_ms = train(torch, Adam, grad_b, problem_b.domain.arrays_from_state(state_b),
                                        L_BIG_EPOCHS, lr=1e-3)
        expect_counts(counters.read(), dict(none, backward_rows=len(losses)), f"{which} 1024^2 as a user row function")
        launches[f"backward_rows_sums_{key}"] = len(losses)
        rel0 = abs(losses[0] - plain) / abs(plain)
        loss_only(problem_b, state_b, opt_b.x, grad_b, f"{which} 1024^2 as a user row function")
        launches[f"forward_rows_{key}"] = launches[f"backward_rows_{key}"] = 1
        problem_s, state_s, _ = l_build(th, tw, np, which, "1024", dev)
        streaming(user_row_function(problem_s, rw))
        counters.zero()
        _, losses_s, chunk_s = train(torch, Adam, autograd_loss_grad_fn(torch, problem_s, state_s),
                                     problem_s.domain.arrays_from_state(state_s), L_BIG_EPOCHS, lr=1e-3)
        n = len(losses_s)
        expect_counts(counters.read(), dict(none, forward_stream=n, backward_stream=n),
                      f"{which} 1024^2 as a user row function, streaming")
        launches[f"forward_stream_{key}"] = launches[f"backward_stream_{key}"] = n
        rel_s = abs(losses_s[0] - plain) / abs(plain)
        print(f"training ({which} 1024^2 as a user row function, traced kernels): one-pass {len(losses)} epochs, "
              f"epoch-0 loss {losses[0]!r} vs the plain operator's {plain!r} (rel {rel0:.2e}), "
              f"{steady_ms(chunk_ms)[0]:.4f} ms/epoch; streaming {n} epochs, epoch 0 rel {rel_s:.2e}, "
              f"{steady_ms(chunk_s)[0]:.4f} ms/epoch (one chunk each, its set-up included) {tag}")
        if rel0 > 1e-5 or rel_s > 1e-5:
            fail(f"phase l: {which} 1024^2 epoch 0 rel {rel0:.2e} (one-pass), {rel_s:.2e} (streaming), limit 1e-5")
        del problem_b, state_b, grad_b, problem_s, state_s, opt_b

    # A row function the tracer refuses (a field read at x+2): the plain
    # version on the card, counted with its reason, the CPU route's numbers.
    def reach2(it, T_, rows, data_rows, params, consts):
        ((cur, prev),) = rows
        return ((cur - prev) * 10.0 - (torch.roll(cur, -2, -1) - 2 * cur + torch.roll(cur, 2, -1)),)

    refused = rw.RowModel(reach2)
    u = rand(*SIZES_1D["64"])
    counters.zero()
    sums, dfields, _ = rw.rowwise_loss_and_grads(refused, (u,), nterms=1, hist=1)
    torch.cuda.synchronize()
    expect_counts(counters.read(), dict(none, plain_on_card=1), "a refused row function")
    reason = rw._traced(refused, 1, 1, (u,), (), (), ())[1]
    cpu = rw.rowwise_loss_and_grads(refused, (u.cpu(),), nterms=1, hist=1)
    e_r, ok_r = close_all([sums.cpu(), dfields[0].cpu()], [cpu[0], cpu[1][0]])
    print(f"a refused row function (reach x+2) at 64^2: plain_on_card {counters.read()['plain_on_card']}, reason "
          f"{reason!r} (counted {rw.plain_on_card.reasons[reason]}); against the CPU route max|d| {e_r:.3e} {tag}")
    if reason is None or rw.plain_on_card.reasons[reason] < 1 or not ok_r:
        fail(f"the refused row function: reason {reason!r}, against the CPU route {ok_r}")
    return timed, hand_calls, slabbed


def wide_forms(builds, tag):
    """Phase u's heat_net.cu libraries of the wide form (nets of more than
    48 params, csrc/heat_wide.cuh): ptxas's registers and spills of each
    kernel, the build's seconds, the blocks an SM of each launch mode and
    the passes a batch of its param phase."""
    import torch

    from odil_torch.ops import rowwise as rw

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    modes = {1: "forward", 2: "backward", 3: "backward+sums", 5: "masked forward", 6: "masked backward",
             7: "masked backward+sums"}
    for widths in sorted({w for w, _, _ in U_CONFIGS.values()}):
        lib = rw._heat_net_library(widths)
        if not lib._odil_wide_rows:
            continue
        _, seconds, log = builds[" ".join(rw.heat_net_source(widths)[:2])]
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        per_sm = {modes[m]: n / sms for (_, m), n in lib._odil_rows1d_resident.items()}
        print(f"heat_net wide form [1, {', '.join(map(str, widths))}, 1]: built in {seconds:.1f} s; ptxas registers "
              f"{regs}, spill stores/loads {spills}; blocks an SM {per_sm}; {lib._odil_wide_rows} passes a batch "
              f"{tag}")


# Phase w: user row functions on 2-D planes and the masked traced forms.
# W_EPOCHS: the bare veltracer at 256^2 on kernel="pallas" (phase b's
# route); W_BIG_EPOCHS its 512^2, streaming and generic-case runs;
# W_HALO_EPOCHS its halo generic route on t:2,x:2; W_HEAT_EPOCHS heat
# keep_init=0 under --mesh t:4 --halo 1 at 64^2 (a row every L_EVERY).
W_EPOCHS, W_BIG_EPOCHS, W_HALO_EPOCHS, W_HEAT_EPOCHS = 100, 10, 20, 50
# The generic 2-D case: hist 2, params, (T, X, Y) and (T, 1, 1) data at the
# flagship's width.
W_NET_SHAPE = (65, 256, 256)


def w_net_row_fn(it, T_, rows, data_rows, params, consts):
    """Phase w's generic 2-D row function: two fields at hist 2, a [1, 4, 1]
    tanh net of u's previous row as a coefficient (its weights as params,
    read element by element), a (T, X, Y) data mask, a (T, 1, 1) data row and
    the row count."""
    import torch

    (u, um, umm), (v, vm, _) = rows
    mask, amp = data_rows
    W1, b1, W2, b2 = params
    k = sum(W2[0, i] * torch.tanh(W1[i, 0] * um + b1[i]) for i in range(4)) + b2[0]
    lap = sum(torch.roll(u, s, d) for s in (-1, 1) for d in (-2, -1)) - 4 * u
    r1 = (u - 2 * um + umm) - k * lap + v * (torch.roll(um, 1, -1) - torch.roll(um, -1, -2)) * amp
    r2 = torch.where(it == T_ - 1, v - vm, (v - torch.roll(vm, 1, -2)) * 0.5)
    return (r1 * mask, r2)


def w_cases(torch, np, th, tw, vt, rw, heat_ref, dev):
    """Phase w's traced cases, traced here before any build so that their
    libraries build with the others: {name: (the bare model, the hand model
    or None, the call, its traced counterpart)} -- the veltracer's row
    function at 256^2 and 512^2 (its steps differ), on shard 1 of the
    t:2,x:2 mesh at 256^2 (the 256^2 library), the generic case, and heat
    keep_init=0 and wave on shard 1 of the t:4 mesh at 64^2 and 1024^2 (the
    masked 1-D forms)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    cases = {}
    for size in ("256", "512"):
        hand, call = rowwise_call(*vt.build(*SIZES[size], kernel="pallas", device=dev)[:2])
        nt_, h, fs, ps, ds, cs = call
        call = (nt_, h, tuple(rand(*f.shape) for f in fs), ps, ds, cs)
        cases[f"velt_{size}"] = (rw.RowModel(hand.row_fn), hand, call)
    # Shard (1, 1)'s block of the halo generic route, its masked row model.
    user, hand, call = cases["velt_256"]
    mask, shards = halo_inputs(torch, rw, None, hand, call[5], SIZES["256"], rand, dev)
    meta, hm, fs, cs = shards[3][:4]
    cases["velt_shard"] = (rw.halo_model(user, *hm.halo), hm, (call[0], 1, fs, (), (), cs))
    T, X, Y = W_NET_SHAPE
    data = ((torch.rand((T, X, Y), generator=gen, device=dev) > 0.3).float(), rand(T, 1, 1))
    params = (rand(4, 1), rand(4), rand(1, 4), rand(1))
    cases["net"] = (rw.RowModel(w_net_row_fn), None, (2, 2, (rand(T, X, Y), rand(T, X, Y)), params, data, ()))
    for which in ("heat", "wave"):
        for size, (T, N) in SIZES_1D.items():
            recs = shard_records(torch, np, th, tw, heat_ref, which, T, N, dev, heat_kw=dict(args=l_heat_args()))
            r = recs[1]
            hand = r["row_fn"]
            a = [tuple(x.detach().contiguous() for x in r[k]) for k in ("fields", "params", "data", "consts")]
            cases[f"{which}_{size}_shard"] = (rw.halo_model(rw.RowModel(hand.inner.row_fn), *hand.halo), hand,
                                              (r["nterms"], r["hist"], *a))
    out = {}
    for name, (user, hand, call) in cases.items():
        spec, reason = rw._traced(user, *call)
        if spec is None:
            fail(f"phase w: the {name} row function is refused by the tracer: {reason}")
        out[name] = (user, hand, call, spec)
    return out


def w_builds(cases):
    """The build jobs of phase w's traced libraries (one a source)."""
    jobs = {}
    for name, (_, _, _, spec) in cases.items():
        tr = spec.trace
        jobs.setdefault(tr.source, ("generated", f"rows{tr.rank}d_traced", tr.source, f"w_{name}"))
    return list(jobs.values())


def user2d_phase(torch, np, counters, cases, builds, report, launches, loops, pallas_losses, zero_512, heat_ref, tag):
    """Phase w (the module docstring): user row functions on 2-D planes and
    on a shard's block on the traced kernels.  `cases`: w_cases's;
    `pallas_losses`: phase b's rows; `zero_512`: the plain operator's loss
    at 512^2 on the zero state.  Fills `report`, `launches` and `loops` and
    returns its timing entries (as main's `timed`), the hand kernels' calls
    on the same inputs and the slabbed launches beside the streaming
    ones."""
    from odil_torch import parallel
    from odil_torch.models import heat as th
    from odil_torch.models import veltracer as vt
    from odil_torch.models import wave as tw
    from odil_torch.ops import _build
    from odil_torch.ops import rowwise as rw
    from odil_torch.optim import Adam

    dev = torch.device(DEVICE)
    none = dict.fromkeys(counters.read(), 0)
    wide = lambda ts: tuple(t.double() for t in ts)
    nbytes = lambda ts: 4 * sum(t.numel() for t in ts)
    source = "odil_torch/ops/rowtrace.py"
    timed, hand_calls, slabbed = {}, {}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    seen = set()
    for name, (user, hand, call, spec) in cases.items():
        tr = spec.trace
        if tr.source in seen:
            continue
        seen.add(tr.source)
        # (a source shared with phase l's cases is built under its label)
        _, seconds, log = next(b for b in builds.values() if b[0].endswith(f"_{_build.generated_digest(tr.source)}.so"))
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        lib = spec.library(user)
        if tr.rank == 2:
            per_sm = {m: n / sms for m, n in lib._odil_rows2d_resident.items()}
            extra = f"shared memory a block {tr.smem[0]}/{tr.smem[1]} B (forward/backward), "
        else:
            per_sm = {m: n / sms for (_, m), n in lib._odil_rows1d_resident.items()}
            extra = ""
        print(f"traced {tr.rank}-D row model ({name}, {tr.name}): {tr.nfields} fields, hist {tr.hist}, {tr.nterms} "
              f"terms, {tr.nparams} params, DUSED {tr.dused:#x}, {tr.ops_forward}/{tr.ops_backward} fp32 operations "
              f"a cell, BLOCKS_PER_SM {tr.blocks_per_sm}, {extra}built in {seconds:.1f} s; ptxas registers {regs}, "
              f"spill stores/loads {spills}; blocks an SM by mode {per_sm} {tag}")

    # w, kernels: each case's forward, backward+sums and backward (and the
    # streaming pair unsharded) against the plain version in fp64 (with the
    # fp32 floor, as on a shard) and the hand kernel on the same inputs;
    # their bits call after call, and streaming as slabbed.
    hand_ops = {"velt": (OPS_ROWS_FORWARD, OPS_ROWS_BACKWARD), "heat": (OPS_HEAT_FORWARD, OPS_HEAT_BACKWARD),
                "wave": (OPS_WAVE_FORWARD, OPS_WAVE_BACKWARD)}
    # The kernel table's entries (the forms phase w's paths run) and the TPU
    # kernels they replace (forward, backward).
    table = {
        "velt_256": (("forward", "sums", "backward", "sforward", "sbackward"),
                     ("odil_tpu/ops/rowwise.py:174", "odil_tpu/ops/rowwise.py:292")),
        "velt_512": (("forward", "sums", "backward"),
                     ("odil_tpu/ops/rowwise_tiled.py:272", "odil_tpu/ops/rowwise_tiled.py:447")),
        "velt_shard": (("forward", "sums", "backward"),
                       ("odil_tpu/ops/rowwise_tiled.py:272", "odil_tpu/ops/rowwise_tiled.py:447")),
        "net": (("sums",), ("odil_tpu/ops/rowwise.py:174", "odil_tpu/ops/rowwise.py:292")),
        "heat_64_shard": (("forward", "sums", "backward"), ("odil_tpu/ops/rowwise.py:385", "odil_tpu/ops/rowwise.py:549")),
    }
    for name, (user, hand, call, spec) in cases.items():
        nt_, h, fs, ps, ds, cs_ = call
        masked = user.halo is not None
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        fwd, bwd = rw._halo_kernels(user, call) if masked else (rw.forward_cuda, rw.backward_cuda)
        calls = [lambda: fwd(user, *call), lambda: bwd(user, *call, gs, True), lambda: bwd(user, *call, gs, False)]
        if not masked:
            calls += [lambda: rw.forward_stream_cuda(user, *call),
                      lambda: rw.backward_stream_cuda(user, *call, gs, False)]
        counters.zero()
        first = [f() for f in calls]
        again = [f() for f in calls]
        torch.cuda.synchronize()
        counts = counters.read()
        kf, (kd, kp, ks), (kd2, kp2, _) = first[:3]
        bits = same_bits(torch, first, again)
        if not masked:
            sf, (sd, sp, _) = first[3:]
            bits = bits and same_bits(torch, [kf, (kd2, kp2)], [sf, (sd, sp)])
        pf = rw._forward_plain(user, nt_, h, *map(wide, (fs, ps, ds, cs_)))
        pd, pp, psums = rw._backward_plain(user, nt_, h, *map(wide, (fs, ps, ds, cs_)), gs.double(), True)
        pd32, pp32, _ = rw._backward_plain(user, nt_, h, fs, ps, ds, cs_, gs, True)
        e_f, ok_f = close(kf.double(), pf, TERMS_RTOL, 0.0)
        e_s, ok_s = close(ks.double(), psums, TERMS_RTOL, 0.0)
        e_g, ok_g, w1 = close_floor(list(kd) + list(kp), list(pd32) + list(pp32), list(pd) + list(pp))
        e_g2, ok_g2, w2 = close_floor(list(kd2) + list(kp2), list(pd32) + list(pp32), list(pd) + list(pp))
        ok_h, text_h = True, "no hand kernel (a user's own function)"
        if hand is not None:
            hf = fwd(hand, *call)
            hd, hp, hs = bwd(hand, *call, gs, True)
            e_hf, ok_hf = close(kf, hf, TERMS_RTOL, 0.0)
            e_hs, ok_hs = close(ks, hs, TERMS_RTOL, 0.0)
            e_hg, ok_hg, _ = close_floor(list(kd) + list(kp), list(hd) + list(hp), list(pd) + list(pp))
            ok_h = ok_hf and ok_hs and ok_hg
            text_h = f"the hand kernel: forward {e_hf:.3e}, sums {e_hs:.3e}, grads {e_hg:.3e}"
        counter = {w: k for k, w in counters.wrappers.items()}
        want = {counter[fwd]: 2, counter[bwd]: 4}
        if not masked:
            want.update(forward_stream=2, backward_stream=2)
        print(f"traced kernels ({name}) at {tuple(fs[0].shape)} against the plain version in fp64: forward max|d sums| "
              f"{e_f:.3e}, backward+sums max|d sums| {e_s:.3e} max|d (dfields, dparams)| {e_g:.3e}, backward {e_g2:.3e} "
              f"({worst_text(max(w1, w2, key=lambda w: w[2]))}); against {text_h}; the same bits call after call"
              f"{'' if masked else ' and streaming as slabbed'}: {bits} {tag}")
        expect_counts(counts, dict(none, **want), f"phase w's kernel checks ({name})")
        if not (ok_f and ok_s and ok_g and ok_g2 and ok_h and bits):
            fail(f"a traced kernel ({name}) disagrees: forward {ok_f}, sums {ok_s}, backward+sums {ok_g}, backward "
                 f"{ok_g2}, hand {ok_h}, bits {bits}")
        del first, again, pd, pp, pd32, pp32
        if name not in table:
            continue
        forms, rep = table[name]
        which = name.split("_")[0]
        tr = spec.trace
        n_cells = fs[0].numel()
        f_in = nbytes(fs + ps + ds + cs_ + ((user.halo[0],) if masked else ()))
        ops = hand_ops.get(which, (tr.ops_forward, tr.ops_backward))
        ops_f, ops_b = min(tr.ops_forward, ops[0]) * n_cells, min(tr.ops_backward, ops[1]) * n_cells
        b_f, b_b = f_in + 4 * nt_, f_in + nbytes(fs + ps)
        pre = {"velt_shard": "halo", "heat_64_shard": "halo_rows1d"}.get(name, "rows")
        key = f"traced2d_{name}" if tr.rank == 2 else f"traced_{name}"
        # Each call takes the model: the traced one (user), the hand one, or
        # the plain version's (autograd of the bare row function).
        entries = {
            "forward": (f"forward_{pre}_{key}", lambda m, c=call, f=fwd: f(m, *c),
                        lambda m, c=call: rw._forward_plain(m, *c), b_f, ops_f, rep[0], e_f),
            "sums": (f"backward_{pre}_sums_{key}", lambda m, c=call, g_=gs, b=bwd: b(m, *c, g_, True),
                     lambda m, c=call, g_=gs: rw._backward_plain(m, *c, g_, True), b_b + 8 * nt_, ops_b, rep[1], e_g),
            "backward": (f"backward_{pre}_{key}", lambda m, c=call, g_=gs, b=bwd: b(m, *c, g_, False),
                         lambda m, c=call, g_=gs: rw._backward_plain(m, *c, g_, False), b_b + 4 * nt_, ops_b, rep[1],
                         e_g2),
        }
        if not masked:
            entries["sforward"] = (f"forward_stream_{key}", lambda m, c=call: rw.forward_stream_cuda(m, *c),
                                   lambda m, c=call: rw._forward_plain(m, *c), b_f, ops_f,
                                   "odil_tpu/ops/rowwise.py:676", close(sf.double(), pf, TERMS_RTOL, 0.0)[0])
            entries["sbackward"] = (f"backward_stream_{key}",
                                    lambda m, c=call, g_=gs: rw.backward_stream_cuda(m, *c, g_, False),
                                    lambda m, c=call, g_=gs: rw._backward_plain(m, *c, g_, False), b_b + 4 * nt_,
                                    ops_b, "odil_tpu/ops/rowwise.py:811", e_g2)
            if "sforward" in forms:
                slabbed[f"forward_stream_{key}"] = lambda c=call, u=user: rw.forward_cuda(u, *c)
                slabbed[f"backward_stream_{key}"] = lambda c=call, g_=gs, u=user: rw.backward_cuda(u, *c, g_, False)
        for form in forms:
            ename, kfn, pfn, nb, ops_, rep_, err = entries[form]
            report[ename] = err
            timed[ename] = (lambda kfn=kfn, u=user: kfn(u), lambda pfn=pfn, u=user: pfn(u), nb, ops_, rep_, source)
            if hand is not None:
                hand_calls[ename] = lambda kfn=kfn, hm=hand: kfn(hm)

    def loss_only(problem, state, x, grad_fn, what, want, halo=False):
        """The loss-only path at x (make_loss_fn + autograd): its launches
        against `want`, its loss and gradients against grad_fn's."""
        loss_fn, _ = problem.make_loss_fn(state, halo=halo)
        xs = [a.detach().clone().requires_grad_(True) for a in x]
        counters.zero()
        loss_e, _ = loss_fn(xs, problem.tracers)
        grads_e = torch.autograd.grad(loss_e, xs)
        torch.cuda.synchronize()
        expect_counts(counters.read(), dict(none, **want), f"{what} loss-only path")
        (loss_t, _), grads_t = grad_fn(x, problem.tracers)
        e, ok = close_all(grads_e, grads_t)
        print(f"{what} loss-only vs one-pass route: loss {float(loss_e)!r} vs {float(loss_t)!r}, max|dgrad| {e:.3e} "
              f"{tag}")
        if abs(float(loss_e) - float(loss_t)) > TERMS_RTOL * abs(float(loss_t)) or not ok:
            fail(f"{what}: the loss-only path and the one-pass route disagree")

    def rel_rows(losses, base, every):
        rel = {e: abs(losses[max(e - 1, 0)] - base[max(e - 1, 0)]) / abs(base[max(e - 1, 0)])
               for e in range(0, len(losses) + 1, every)}
        return rel, max(rel, key=rel.get)

    ref256 = read_ref("ref_velt_256.csv")
    what = "the veltracer's row function bare, 256^2 pallas (traced 2-D kernel)"
    problem_b, state_b, _ = vt.build(*SIZES["256"], kernel="pallas", device=dev)
    user_row_function(problem_b, rw)
    grad_b = problem_b.make_loss_grad_fn(state_b)
    if grad_b is None:
        fail("make_loss_grad_fn declined the veltracer's row function as a user row function")
    counters.zero()
    opt_b, losses_b, chunk_ms = train(torch, Adam, grad_b, problem_b.domain.arrays_from_state(state_b), W_EPOCHS)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses_b)), what)
    launches["backward_rows_sums_traced2d_velt_256"] = len(losses_b)
    rows = trajectory_rows(losses_b)
    rel = {e: abs(rows[e] - ref256[e]) / abs(ref256[e]) for e in rows if e in ref256}
    worst = max(rel, key=rel.get)
    rel_b, worst_b = rel_rows(losses_b, pallas_losses, CHUNK)
    _, _, names = kernel_split(torch, lambda: grad_b(opt_b.x, problem_b.tracers), reps=3)
    ms_b = steady_ms(chunk_ms)
    print(f"training ({what}): {len(losses_b)} epochs, epoch-0 loss {rows[0]!r} (ref_velt_256.csv {ref256[0]!r}, rel "
          f"{rel[0]:.2e}); worst reference row epoch {worst} ({100 * rel[worst]:.2f}%); worst {CHUNK}-epoch row against "
          f"phase b's hand route epoch {worst_b} ({100 * rel_b[worst_b]:.4f}%); {ms_b[0]:.4f} ms/epoch; the kernels of "
          f"an epoch {sorted(names)} {tag}")
    if rel[0] > 1e-5 or rel[worst] > 0.15 or rel_b[worst_b] > 0.01:
        fail(f"{what}: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} {100 * rel[worst]:.2f}% from the "
             f"reference (limit 15%), epoch {worst_b} {100 * rel_b[worst_b]:.3f}% from phase b (limit 1%)")
    if not any("rows2d_kernel" in n for n in names) or any("rows_kernel<" in n for n in names):
        fail(f"{what}: an epoch launched {sorted(names)}, not the traced 2-D kernel alone")
    loss_only(problem_b, state_b, opt_b.x, grad_b, what, dict(forward_rows=1, backward_rows=1))
    launches["forward_rows_traced2d_velt_256"] = launches["backward_rows_traced2d_velt_256"] = 1
    loops["pallas 256, the veltracer's row function bare (traced 2-D kernel)"] = (opt_b, ms_b)
    del problem_b, state_b, grad_b

    what = "the veltracer's row function bare, 512^2 pallas (traced 2-D kernel)"
    problem5, state5, _ = vt.build(*SIZES["512"], kernel="pallas", device=dev)
    user_row_function(problem5, rw)
    grad5 = problem5.make_loss_grad_fn(state5)
    counters.zero()
    opt5, losses, chunk_ms = train(torch, Adam, grad5, problem5.domain.arrays_from_state(state5), W_BIG_EPOCHS)
    expect_counts(counters.read(), dict(none, backward_rows=len(losses)), what)
    launches["backward_rows_sums_traced2d_velt_512"] = len(losses)
    rel0 = abs(losses[0] - zero_512) / abs(zero_512)
    print(f"training ({what}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain operator's {zero_512!r} "
          f"(rel {rel0:.2e}); {steady_ms(chunk_ms)[0]:.4f} ms/epoch {tag}")
    if rel0 > 1e-5:
        fail(f"{what}: epoch 0 rel {rel0:.2e} (limit 1e-5)")
    loss_only(problem5, state5, opt5.x, grad5, what, dict(forward_rows=1, backward_rows=1))
    launches["forward_rows_traced2d_velt_512"] = launches["backward_rows_traced2d_velt_512"] = 1
    del problem5, state5, grad5, opt5

    what = "the veltracer's row function bare, 256^2 streaming (traced 2-D kernels)"
    problem_s, state_s, _ = vt.build(*SIZES["256"], kernel="pallas", device=dev)
    streaming(user_row_function(problem_s, rw))
    counters.zero()
    _, losses, chunk_ms = train(torch, Adam, autograd_loss_grad_fn(torch, problem_s, state_s),
                                problem_s.domain.arrays_from_state(state_s), W_BIG_EPOCHS)
    n = len(losses)
    expect_counts(counters.read(), dict(none, forward_stream=n, backward_stream=n), what)
    launches["forward_stream_traced2d_velt_256"] = launches["backward_stream_traced2d_velt_256"] = n
    rel0 = abs(losses[0] - ref256[0]) / abs(ref256[0])
    rel_s, worst_s = rel_rows(losses, losses_b, CHUNK)
    print(f"training ({what}): {n} epochs, epoch-0 loss {losses[0]!r} (rel {rel0:.2e} to ref_velt_256.csv); worst "
          f"{CHUNK}-epoch row against the one-pass route epoch {worst_s} ({100 * rel_s[worst_s]:.4f}%); "
          f"{steady_ms(chunk_ms)[0]:.4f} ms/epoch {tag}")
    if rel0 > 1e-5 or rel_s[worst_s] > 0.01:
        fail(f"{what}: epoch 0 rel {rel0:.2e} (limit 1e-5), epoch {worst_s} {100 * rel_s[worst_s]:.3f}% (limit 1%)")
    del problem_s, state_s

    what = f"the veltracer's row function bare, halo generic on {HALO_SPEC} (masked traced 2-D kernels)"
    mesh = parallel.mesh_from_spec(HALO_SPEC, devices=[dev] * HALO_SHARDS)
    problem_q, state_q, _ = vt.build(*SIZES["256"], kernel="pallas", device=dev, mesh=mesh, partition=HALO_PART)
    user_row_function(problem_q, rw)
    grad_q = problem_q.make_loss_grad_fn(state_q, halo=True, halo_fuse="generic")
    if grad_q is None or grad_q.route != "generic":
        fail(f"{what}: the route is {getattr(grad_q, 'route', None)}")
    counters.zero()
    opt_q, losses, chunk_ms = train(torch, Adam, grad_q, problem_q.domain.arrays_from_state(state_q), W_HALO_EPOCHS)
    expect_counts(counters.read(), dict(none, backward_halo=HALO_SHARDS * len(losses)), what)
    launches["backward_halo_sums_traced2d_velt_shard"] = HALO_SHARDS * len(losses)
    rel_q, worst_q = rel_rows(losses, losses_b, CHUNK)
    print(f"training ({what}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the unsharded traced run's "
          f"{losses_b[0]!r} (rel {rel_q[0]:.2e}); worst {CHUNK}-epoch row epoch {worst_q} ({100 * rel_q[worst_q]:.4f}%); "
          f"{steady_ms(chunk_ms)[0]:.4f} ms/epoch {tag}")
    if rel_q[0] > 1e-5:
        fail(f"{what}: epoch 0 rel {rel_q[0]:.2e} (limit 1e-5)")
    loss_only(problem_q, state_q, opt_q.x, grad_q, what, dict(forward_halo=HALO_SHARDS, backward_halo=HALO_SHARDS),
              halo=True)
    launches["forward_halo_traced2d_velt_shard"] = launches["backward_halo_traced2d_velt_shard"] = HALO_SHARDS
    del problem_q, state_q, grad_q, opt_q

    what = f"heat keep_init=0 as a user row function on {HALO1D_SPEC} --halo, 64^2 (masked traced 1-D kernels)"
    mesh1 = parallel.mesh_from_spec(HALO1D_SPEC, devices=[dev] * HALO1D_SHARDS)
    problem_h, state_h, _ = l_build(th, tw, np, "heat", "64", dev, mesh=mesh1, partition=HALO1D_PART)
    user_row_function(problem_h, rw)
    grad_h = problem_h.make_loss_grad_fn(state_h, halo=True)
    if grad_h is None or grad_h.route != "generic":
        fail(f"{what}: the route is {getattr(grad_h, 'route', None)}")
    counters.zero()
    opt_h, losses_h, chunk_ms = train(torch, Adam, grad_h, problem_h.domain.arrays_from_state(state_h), W_HEAT_EPOCHS,
                                      lr=1e-3)
    expect_counts(counters.read(), dict(none, backward_halo_rows1d=HALO1D_SHARDS * len(losses_h)), what)
    launches["backward_halo_rows1d_sums_traced_heat_64_shard"] = HALO1D_SHARDS * len(losses_h)
    problem_x, state_x, _ = l_build(th, tw, np, "heat", "64", dev, kernel="xla", mesh=mesh1, partition=HALO1D_PART)
    counters.zero()
    _, losses_x, chunk_x = train(torch, Adam, autograd_loss_grad_fn(torch, problem_x, state_x, halo=True),
                                 problem_x.domain.arrays_from_state(state_x), W_HEAT_EPOCHS, lr=1e-3)
    expect_counts(counters.read(), none, f"{what}: the plain operator")
    rel_h, worst_h = rel_rows(losses_h, losses_x, L_EVERY)
    ms_h = steady_ms(chunk_ms)
    print(f"training ({what}) vs the plain operator the same way: epoch-0 loss {losses_h[0]!r} vs {losses_x[0]!r} (rel "
          f"{rel_h[0]:.2e}); worst {L_EVERY}-epoch row epoch {worst_h} ({100 * rel_h[worst_h]:.4f}%); {ms_h[0]:.4f} "
          f"ms/epoch against the plain operator's {steady_ms(chunk_x)[0]:.4f} {tag}")
    if rel_h[worst_h] > 0.01:
        fail(f"{what}: epoch {worst_h} {100 * rel_h[worst_h]:.3f}% from the plain operator (limit 1%)")
    loss_only(problem_h, state_h, opt_h.x, grad_h, what,
              dict(forward_halo_rows1d=HALO1D_SHARDS, backward_halo_rows1d=HALO1D_SHARDS), halo=True)
    launches["forward_halo_rows1d_traced_heat_64_shard"] = HALO1D_SHARDS
    launches["backward_halo_rows1d_traced_heat_64_shard"] = HALO1D_SHARDS
    loops["heat 64 keep_init=0 as a user row function on t:4 --halo (traced masked kernel)"] = (opt_h, ms_h)
    del problem_h, state_h, grad_h, problem_x, state_x

    # The generic case's fields and params trained by Adam through
    # rowwise_loss_and_grads, the public one-pass entry.
    user, _, call, _ = cases["net"]
    nt_, h, fs, ps, ds, cs_ = call

    def grad_net(x, tracers):
        sums, dfields, dparams = rw.rowwise_loss_and_grads(user, x[:2], params=x[2:], data=ds, nterms=nt_, hist=h)
        terms = sums / fs[0].numel()
        return (terms.sum(), (list(terms), [terms.sum()])), list(dfields) + list(dparams)

    counters.zero()
    _, losses, _ = train(torch, Adam, grad_net, [t.clone() for t in fs + ps], W_BIG_EPOCHS, lr=1e-3)
    expect_counts(counters.read(), dict(none, backward_rows=W_BIG_EPOCHS), "the generic 2-D case's training")
    launches["backward_rows_sums_traced2d_net"] = W_BIG_EPOCHS
    plain = float(rw._forward_plain(user, nt_, h, *map(wide, (fs, ps, ds, cs_))).sum()) / fs[0].numel()
    rel0 = abs(losses[0] - plain) / abs(plain)
    print(f"the generic 2-D case (hist 2, params, data) at {W_NET_SHAPE}: {W_BIG_EPOCHS} Adam epochs through "
          f"rowwise_loss_and_grads, loss {losses[0]!r} -> {losses[-1]!r}, epoch 0 against the plain version in fp64 "
          f"rel {rel0:.2e} {tag}")
    if rel0 > 1e-5 or not losses[-1] < losses[0]:
        fail(f"the generic 2-D case: epoch 0 rel {rel0:.2e} (limit 1e-5), losses {losses}")
    return timed, hand_calls, slabbed


# X_EPOCHS: the bare veltracer on kernel="pallas_mg" at 256^2 (phase a's
# route); X_BIG_EPOCHS its 512^2 run and the generic case's Adam loop;
# X_HALO_EPOCHS its halo mg route on t:2,x:2 and its depth-2 run at 256^2;
# X_HALO512_EPOCHS the halo mg route at 512^2.
X_EPOCHS, X_BIG_EPOCHS, X_HALO_EPOCHS, X_HALO512_EPOCHS = 100, 10, 20, 10
X_HOST_CALLS = 200  # the calls that time the mg route's host work
X_F0, X_F1 = (0.7, 1.1, 0.9), (0.8, 1.2, 0.6)  # the level factors of the kernel checks' inputs


def x_reach2_row_fn(it, T_, rows, data_rows, params, consts):
    """A row function on the veltracer's fields that reads u two cells away
    along x: past the traced kernels' reach (phase x's refused function)."""
    import torch

    (u, up), _, _ = rows
    return (u - torch.roll(up, 2, -2),) * 6


def x_cases(torch, rw, rmg, w, dev):
    """Phase x's traced mg cases, traced here before any build so that their
    libraries build with the others: {name: (form, the bare model, the hand
    model or None, the call's inputs, its traced counterpart)} -- the
    veltracer's row function at 256^2 and 512^2 on the whole plane (the
    models and const planes of phase w's cases), at depth 2 at 256^2, on
    shard (1, 1) of t:2,x:2 at 256^2 and 512^2 (the local blocks of
    ``halo_inputs``), and phase w's generic case (``w_net_row_fn``: hist 2,
    params, data) over a level-1 partial."""
    gen = torch.Generator(device=dev).manual_seed(22)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    cases = {}
    for size in ("256", "512"):
        user, hand, (nt_, h, fs, _, _, cs), _ = w[f"velt_{size}"]
        T, X, Y = fs[0].shape
        t0s = tuple(rand(T, X, Y) for _ in range(3))
        coarse = tuple(rand(T // 2 + 1, X // 2, Y // 2) for _ in range(3))
        inputs = dict(nterms=nt_, hist=h, f0s=X_F0, t0s=t0s, coarse=coarse, consts=cs, params=(), data=())
        cases[f"velt_{size}"] = ("whole", user, hand, inputs)
        if size == "256":
            Tc = T // 2 + 1
            t1s = tuple(rand(Tc, X // 2, Y // 2) for _ in range(3))
            P2 = tuple(rand(Tc // 2 + 1, X // 4, Y // 4) for _ in range(3))
            cases["velt_lvl2"] = ("lvl2", user, hand, dict(inputs, coarse=P2, t1s=t1s, f1s=X_F1))
        _, shards = halo_inputs(torch, rw, rmg, hand, cs, SIZES[size], rand, dev)
        meta, _, _, hcs, mm, mt0, mP, mh = shards[3]
        cases["velt_shard" if size == "256" else "velt_shard_512"] = (
            "local", rw.halo_model(user, *mm.halo), mm,
            dict(inputs, t0s=mt0, coarse=mP, heads=mh, x0=meta["x0"], consts=hcs))
    user, _, (nt_, h, fs, ps, ds, cs), _ = w["net"]
    T, X, Y = fs[0].shape
    coarse = tuple(rand(T // 2 + 1, X // 2, Y // 2) for _ in fs)
    cases["net"] = ("whole", user, None, dict(nterms=nt_, hist=h, f0s=X_F0[:2], t0s=fs, coarse=coarse, consts=cs,
                                               params=ps, data=ds))
    out = {}
    for name, (form, user, hand, a) in cases.items():
        call = (a["nterms"], a["hist"], a["t0s"], a["params"], a["data"], a["consts"])
        spec, reason = rmg._traced_mg(user, call, form, a["coarse"][0].shape[1] if form == "local" else None)
        if spec is None:
            fail(f"phase x: the {name} row function has no traced mg walk: {reason}")
        out[name] = (form, user, hand, a, spec)
    return out


def x_builds(cases):
    """The build jobs of phase x's traced mg libraries (one a source)."""
    jobs = {}
    for name, (_, _, _, _, spec) in cases.items():
        src = spec.trace.mg_source
        jobs.setdefault(src, ("generated", "mg2d_traced", src, f"x_{name}"))
    return list(jobs.values())


@contextlib.contextmanager
def bare_row_model(vt, rw):
    """Within the block, ``vt._row_model`` gives the veltracer's row function
    bare (no CUDA model, no hand adjoint), as a user's variant of the
    flagship's residual reaches the mg route (``operator_fused_mg``, its
    ``loss_and_grads`` and the halo mg route's declaration)."""
    hand = vt._row_model

    def bare(ctx):
        model, nterms = hand(ctx)
        return rw.RowModel(model.row_fn), nterms

    vt._row_model = bare
    try:
        yield
    finally:
        vt._row_model = hand


def x_calls(rmg, form, model, a, g, sums):
    """The kernel wrapper's call of a phase x case's form on `model` (the
    bare one, or the hand one on the same inputs)."""
    nt_, h, f0s, t0s, coarse, cs, ps, ds = (a[k] for k in ("nterms", "hist", "f0s", "t0s", "coarse", "consts",
                                                             "params", "data"))
    if form == "lvl2":
        return rmg.backward_mg2_cuda(model, nt_, h, f0s, a["f1s"], t0s, a["t1s"], coarse, cs, g, sums, ps, ds)
    if form == "local":
        return rmg.backward_mg_local_cuda(model, nt_, h, f0s, t0s, coarse, a["heads"], a["x0"], cs, g, ps, ds)
    if g is None:
        return rmg.forward_mg_cuda(model, nt_, h, f0s, t0s, coarse, cs, ps, ds)
    return rmg.backward_mg_cuda(model, nt_, h, f0s, t0s, coarse, cs, g, sums, ps, ds)


def x_plain(torch, rmg, rw, form, model, a, g, sums, wide):
    """The plain version of a phase x case's form (in fp64 where `wide`):
    (cotangents..., sums); the forward's sums alone where g is None."""
    cast = (lambda ts: tuple(t.double() for t in ts)) if wide else tuple
    nt_, h, f0s = a["nterms"], a["hist"], a["f0s"]
    t0s, coarse, cs, ps, ds = (cast(a[k]) for k in ("t0s", "coarse", "consts", "params", "data"))
    g = g.double() if wide and g is not None else g
    if g is None:
        return (rmg._forward_mg_plain(model, nt_, h, f0s, t0s, coarse, cs, ps, ds),)
    if form == "lvl2":
        t1s = cast(a["t1s"])
        d0, dP1, dpar, s = rmg._backward_mg_plain(model, nt_, h, f0s, t0s, coarse, cs, g, sums, (t1s, a["f1s"]), ps,
                                                  ds)
        W1x, W1y = rmg._interp_matrices(*coarse[0].shape[1:], t0s[0].dtype, t0s[0].device)
        return (d0,) + rmg._split_dp1(dP1, a["f1s"], W1x, W1y) + (dpar, s)
    if form == "local":
        if wide:
            model = rw.halo_model(model.inner, model.halo[0].double(), *model.halo[1:])
        return rmg._backward_mg_local_plain(model, nt_, h, f0s, t0s, coarse, cast(a["heads"]), a["x0"], cs, g, ps, ds)
    return rmg._backward_mg_plain(model, nt_, h, f0s, t0s, coarse, cs, g, sums, None, ps, ds)


def mg_user_phase(torch, np, counters, cases, builds, report, launches, loops, losses_mg, zero_512, tag):
    """Phase x (the module docstring): a user's row function on the mg route
    on the traced walk.  `cases`: x_cases's; `losses_mg`: phase a's rows;
    `zero_512`: the plain operator's loss at 512^2 on the zero state.  Fills
    `report`, `launches` and `loops` and returns its timing entries (as
    main's `timed`), those of the forms no path runs, their errors, and the
    hand kernels' calls on the same inputs."""
    from odil_torch import parallel
    from odil_torch.models import veltracer as vt
    from odil_torch.ops import _build
    from odil_torch.ops import rowwise as rw
    from odil_torch.ops import rowwise_mg as rmg
    from odil_torch.optim import Adam

    dev = torch.device(DEVICE)
    none = {name: 0 for name in counters.wrappers}
    nbytes = lambda ts: 4 * sum(t.numel() for t in ts)
    source = "odil_torch/csrc/mg_rows2d.cuh"
    timed, unlisted, off_path, hand_calls = {}, {}, {}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    seen = set()
    for name, (form, user, hand, a, spec) in cases.items():
        tr = spec.trace
        src = tr.mg_source
        if src in seen:
            continue
        seen.add(src)
        _, seconds, log = next(b for b in builds.values() if b[0].endswith(f"_{_build.generated_digest(src)}.so"))
        lib = rmg._mg_library(src)
        smem = {f: lib.odil_mg2d_smem(rmg._MG_FORM[f], 3) for f in ("whole", "lvl2", "local")}
        reckoned = {f: rowtrace_smem(tr, f) for f in smem}
        per_sm = {k: n / sms for k, n in lib._odil_mg2d_resident.items()}
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        print(f"traced mg walk ({name}, {tr.name}): {tr.nfields} fields, hist {tr.hist}, {tr.nterms} terms, "
              f"{tr.nparams} params, {tr.nstaged} staged cotangent planes, {tr.ops_forward}/{tr.ops_backward} fp32 "
              f"operations a cell, shared memory a backward block {smem} B (rowtrace.mg2d_smem {reckoned}), built "
              f"in {seconds:.1f} s; ptxas registers {regs}, spill stores/loads {spills}; blocks an SM by (form, mode) "
              f"{per_sm} {tag}")
        if smem != reckoned:
            fail(f"phase x: rowtrace.mg2d_smem reckons other bytes than the walk's Smem for {name}")

    # x, kernels: each case's forms against the plain version in fp64 (with
    # the fp32 floor) and the hand kernel on the same inputs; their bits
    # call after call; the launches on the built-in wrappers' counters.
    table = {  # name: {form: (entry name, the TPU kernel it replaces, on a path)}
        "velt_256": {"sums": ("backward_mg_sums_traced_velt_256", "odil_tpu/ops/rowwise_mg.py:766", True),
                     "backward": ("backward_mg_traced_velt_256", "odil_tpu/ops/rowwise_mg.py:766", True),
                     "forward": ("forward_mg_traced_velt_256", "odil_tpu/ops/rowwise_mg.py:336", True)},
        "velt_512": {"sums": ("backward_mg_sums_traced_velt_512", "odil_tpu/ops/rowwise_mg_tiled.py:490", True)},
        "velt_lvl2": {"sums": ("backward_mg2_sums_traced_velt_256", "odil_tpu/ops/rowwise_mg.py:766", True),
                      "backward": ("backward_mg2_traced_velt_256", "odil_tpu/ops/rowwise_mg.py:766", False)},
        "velt_shard": {"sums": ("backward_mg_local_sums_traced_velt_shard", "odil_tpu/ops/rowwise_mg.py:766", True)},
        "velt_shard_512": {"sums": ("backward_mg_local_sums_traced_velt_shard_512",
                                    "odil_tpu/ops/rowwise_mg_local_tiled.py:565", True)},
        "net": {"sums": ("backward_mg_sums_traced_net", "odil_tpu/ops/rowwise_mg.py:766", True)},
    }
    wrapper = {"whole": "backward_mg", "lvl2": "backward_mg2", "local": "backward_mg_local"}
    for name, (form, user, hand, a, spec) in cases.items():
        tr = spec.trace
        nt_ = a["nterms"]
        g = torch.linspace(0.5, 1.5, nt_, device=dev) / a["t0s"][0].numel()
        forms = {"sums": True} if form == "local" else {"sums": True, "backward": False}
        if form == "whole":
            forms["forward"] = None
        # (every name the calls take bound now: the timing calls them after the loop)
        run = lambda m, f, form=form, a=a, g=g, forms=forms: x_calls(rmg, form, m, a, None if forms[f] is None else g,
                                                                      bool(forms[f]))
        counters.zero()
        first = {f: run(user, f) for f in forms}
        again = {f: run(user, f) for f in forms}
        torch.cuda.synchronize()
        counts = counters.read()
        bits = same_bits(torch, list(first.values()), list(again.values()))
        want = dict(none, **{wrapper[form]: 2 * sum(f != "forward" for f in forms)})
        if form == "whole":
            want.update(forward_mg=2, backward_mg_with_sums=2)
        expect_counts(counts, want, f"phase x's kernel checks ({name})")
        errs, oks, texts, p64s = {}, [], [], {}
        flat = lambda out: [t for x in out[:-1] for t in (x if isinstance(x, tuple) else (x,))]
        for f, sums in forms.items():
            gf = None if sums is None else g
            k = first[f]
            p64 = p64s[f] = x_plain(torch, rmg, rw, form, user, a, gf, bool(sums), True)
            p32 = x_plain(torch, rmg, rw, form, user, a, gf, bool(sums), False)
            if sums is None:
                e, ok = close(k.double(), p64[0], TERMS_RTOL, 0.0)
                errs[f], texts = e, texts + [f"forward max|d sums| {e:.3e}"]
                oks.append(ok)
                continue
            e, ok, w_ = close_floor(flat(k), flat(p32), flat(p64))
            errs[f] = e
            oks.append(ok)
            text = f"{f} max|d grads| {e:.3e} ({worst_text(w_)})"
            if sums:
                e_s, ok_s = close(k[-1].double(), p64[-1], TERMS_RTOL, 0.0)
                oks.append(ok_s)
                text += f", max|d sums| {e_s:.3e}"
            texts.append(text)
        ok_h, text_h = True, "no hand kernel (a user's own function)"
        if hand is not None:
            ks = {f: first[f] for f in forms}
            hs = {f: run(hand, f) for f in forms}
            torch.cuda.synchronize()
            parts = []
            for f, sums in forms.items():
                if sums is None:
                    e, ok = close(ks[f], hs[f], TERMS_RTOL, 0.0)
                else:
                    e, ok, _ = close_floor(flat(ks[f]), flat(hs[f]), flat(p64s[f]))
                ok_h = ok_h and ok
                parts.append(f"{f} {e:.3e}")
            text_h = "the hand kernel: " + ", ".join(parts)
        print(f"traced mg walk ({name}, {form}) at {tuple(a['t0s'][0].shape)} against the plain version in fp64: "
              + "; ".join(texts) + f"; against {text_h}; the same bits call after call: {bits} {tag}")
        if not (all(oks) and ok_h and bits):
            fail(f"a traced mg kernel ({name}) disagrees: plain {oks}, hand {ok_h}, bits {bits}")
        del first, again, p64s
        t0s, coarse, cs, ps, ds = (a[k] for k in ("t0s", "coarse", "consts", "params", "data"))
        n_cells = t0s[0].numel()
        ops_f, ops_b = min(tr.ops_forward, OPS_FORWARD) * n_cells, min(tr.ops_backward, OPS_BACKWARD) * n_cells
        if name == "net":
            ops_f, ops_b = tr.ops_forward * n_cells, tr.ops_backward * n_cells
        ins = t0s + coarse + cs + ps + ds + tuple(a.get("t1s", ())) + tuple(a.get("heads", ()))
        ins += (user.halo[0],) if form == "local" else ()
        outs = t0s + coarse + ps + tuple(a.get("t1s", ())) + tuple(a.get("heads", ()))
        if form == "lvl2":
            ops_b += OPS_LVL2_PER_COARSE * a["t1s"][0].numel()
        for f, sums in forms.items():
            ename, replaced, on_path = table[name].get(f, (f"{f}_traced_{name}", None, False))
            gf = None if sums is None else g
            nb = nbytes(ins) + 4 * nt_ if sums is None else nbytes(ins) + nbytes(outs) + 4 * nt_ * (2 if sums else 1)
            entry = (lambda f=f, run=run, user=user: run(user, f),
                     lambda gf=gf, s=bool(sums), form=form, user=user, a=a: x_plain(torch, rmg, rw, form, user, a, gf, s,
                                                                                    False),
                     nb, ops_f if sums is None else ops_b, replaced or "odil_tpu/ops/rowwise_mg.py:766", source)
            if on_path:
                timed[ename], report[ename] = entry, errs[f]
                if hand is not None:
                    hand_calls[ename] = lambda f=f, run=run, hm=hand: run(hm, f)
            else:
                unlisted[ename], off_path[ename] = entry, errs[f]

    # x, host: the host time of one mg call from the dispatcher to its
    # return (kernels queued, not waited for), the traced route against the
    # hand route on the same inputs, and the traced route's decision alone
    # (the trace's fingerprint, its cache and the walk's refusals).
    _, user, hand, a, _ = cases["velt_256"]
    g = torch.full((a["nterms"],), 1.0 / a["t0s"][0].numel(), device=dev)
    args = (a["nterms"], a["hist"], a["f0s"], a["t0s"], a["coarse"], a["consts"], g, True)
    call = (a["nterms"], a["hist"], a["t0s"], (), (), a["consts"])
    host = {}
    for what, fn in (("traced route", lambda: rmg._backward_mg(user, *args)),
                     ("hand route", lambda: rmg._backward_mg(hand, *args)),
                     ("traced route's decision", lambda: rmg._mg_kernel(user, call))):
        fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(X_HOST_CALLS):
            t = time.perf_counter()
            fn()
            per.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        host[what] = statistics.median(per)
    print("host ms a call of _backward_mg at (65, 256, 256), dispatch to return, median of "
          f"{X_HOST_CALLS}: " + ", ".join(f"{k} {v:.4f}" for k, v in host.items()) + f" {tag}")

    def rel_rows(losses, base, every):
        rel = {e: abs(losses[max(e - 1, 0)] - base[max(e - 1, 0)]) / abs(base[max(e - 1, 0)])
               for e in range(0, len(losses) + 1, every)}
        return rel, max(rel, key=rel.get)

    def loss_only(problem, state, x, grad_fn, what, want):
        """The loss-only path at x (make_loss_fn + autograd): its launches
        against `want`, its loss and gradients against grad_fn's."""
        loss_fn, _ = problem.make_loss_fn(state)
        xs = [t.detach().clone().requires_grad_(True) for t in x]
        counters.zero()
        loss_e, _ = loss_fn(xs, problem.tracers)
        grads_e = torch.autograd.grad(loss_e, xs)
        torch.cuda.synchronize()
        expect_counts(counters.read(), dict(none, **want), f"{what} loss-only path")
        (loss_t, _), grads_t = grad_fn(x, problem.tracers)
        e, ok = close_all(grads_e, grads_t)
        print(f"{what} loss-only vs one-pass route: loss {float(loss_e)!r} vs {float(loss_t)!r}, max|dgrad| {e:.3e} "
              f"{tag}")
        if abs(float(loss_e) - float(loss_t)) > TERMS_RTOL * abs(float(loss_t)) or not ok:
            fail(f"{what}: the loss-only path and the one-pass route disagree")

    def walked(fn, what):
        """The kernels of one call of fn by name: the traced walk's, not the
        hand walk's."""
        _, _, names = kernel_split(torch, fn, reps=3)
        if not any("walk_kernel" in n for n in names) or any("mg_rows_kernel" in n for n in names):
            fail(f"{what}: a call launched {sorted(names)}, not the traced mg walk")
        return sorted(names)

    ref256 = read_ref("ref_velt_256.csv")
    with bare_row_model(vt, rw):
        what = "the veltracer's row function bare, 256^2 pallas_mg (traced mg walk)"
        problem_b, state_b, _ = vt.build(*SIZES["256"], kernel="pallas_mg", device=dev)
        grad_b = problem_b.make_loss_grad_fn(state_b)
        if grad_b is None:
            fail(f"{what}: make_loss_grad_fn declined the fused route")
        counters.zero()
        opt_b, losses_b, chunk_ms = train(torch, Adam, grad_b, problem_b.domain.arrays_from_state(state_b), X_EPOCHS)
        n = len(losses_b)
        expect_counts(counters.read(), dict(none, backward_mg=n), what)
        launches["backward_mg_sums_traced_velt_256"] = n
        rows = trajectory_rows(losses_b)
        rel = {e: abs(rows[e] - ref256[e]) / abs(ref256[e]) for e in rows if e in ref256}
        worst = max(rel, key=rel.get)
        rel_b, worst_b = rel_rows(losses_b, losses_mg, CHUNK)
        names = walked(lambda: grad_b(opt_b.x, problem_b.tracers), what)
        ms_b = steady_ms(chunk_ms)
        print(f"training ({what}): {n} epochs, epoch-0 loss {rows[0]!r} (ref_velt_256.csv {ref256[0]!r}, rel "
              f"{rel[0]:.2e}); worst reference row epoch {worst} ({100 * rel[worst]:.2f}%); worst {CHUNK}-epoch row "
              f"against phase a's hand route epoch {worst_b} ({100 * rel_b[worst_b]:.4f}%); {ms_b[0]:.4f} ms/epoch "
              f"against the hand route's {loops['pallas_mg 256'][1][0]:.4f}; the kernels of an epoch {names} {tag}")
        if rel[0] > 1e-5 or rel[worst] > 0.15 or rel_b[worst_b] > 0.01:
            fail(f"{what}: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} {100 * rel[worst]:.2f}% from the "
                 f"reference (limit 15%), epoch {worst_b} {100 * rel_b[worst_b]:.3f}% from phase a (limit 1%)")
        loss_only(problem_b, state_b, opt_b.x, grad_b, what, dict(forward_mg=1, backward_mg=1))
        launches["forward_mg_traced_velt_256"] = launches["backward_mg_traced_velt_256"] = 1
        loops["pallas_mg 256, the veltracer's row function bare (traced mg walk)"] = (opt_b, ms_b)
        del problem_b, state_b, grad_b

        what = "the veltracer's row function bare, 512^2 pallas_mg (traced mg walk)"
        problem5, state5, _ = vt.build(*SIZES["512"], kernel="pallas_mg", device=dev)
        grad5 = problem5.make_loss_grad_fn(state5)
        counters.zero()
        opt5, losses, chunk_ms = train(torch, Adam, grad5, problem5.domain.arrays_from_state(state5), X_BIG_EPOCHS)
        expect_counts(counters.read(), dict(none, backward_mg=len(losses)), what)
        launches["backward_mg_sums_traced_velt_512"] = len(losses)
        rel0 = abs(losses[0] - zero_512) / abs(zero_512)
        print(f"training ({what}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain operator's "
              f"{zero_512!r} (rel {rel0:.2e}); {steady_ms(chunk_ms)[0]:.4f} ms/epoch {tag}")
        if rel0 > 1e-5:
            fail(f"{what}: epoch 0 rel {rel0:.2e} (limit 1e-5)")
        del problem5, state5, grad5, opt5

        what = "the veltracer's row function bare, 256^2 pallas_mg at depth 2 (traced two-level walk)"
        problem2, state2, _ = vt.build(*SIZES["256"], kernel="pallas_mg", device=dev)
        hook = vt._mg_loss_and_grads.partial_depth
        vt._mg_loss_and_grads.partial_depth = lambda t0_shapes, dtype: 2
        try:
            grad2 = problem2.make_loss_grad_fn(state2)
        finally:
            vt._mg_loss_and_grads.partial_depth = hook
        counters.zero()
        opt2, losses, chunk_ms = train(torch, Adam, grad2, problem2.domain.arrays_from_state(state2), X_HALO_EPOCHS)
        expect_counts(counters.read(), dict(none, backward_mg2=len(losses)), what)
        launches["backward_mg2_sums_traced_velt_256"] = len(losses)
        rel2, worst2 = rel_rows(losses, losses_b, CHUNK)
        names = walked(lambda: grad2(opt2.x, problem2.tracers), what)
        print(f"training ({what}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the depth-1 run's "
              f"{losses_b[0]!r} (rel {rel2[0]:.2e}); worst {CHUNK}-epoch row epoch {worst2} "
              f"({100 * rel2[worst2]:.4f}%); {steady_ms(chunk_ms)[0]:.4f} ms/epoch; the kernels of an epoch {names} "
              f"{tag}")
        if rel2[0] > 1e-5 or rel2[worst2] > 0.01:
            fail(f"{what}: epoch 0 rel {rel2[0]:.2e} (limit 1e-5), epoch {worst2} {100 * rel2[worst2]:.3f}% from "
                 f"the depth-1 run (limit 1%)")
        del problem2, state2, grad2, opt2

        mesh = parallel.mesh_from_spec(HALO_SPEC, devices=[dev] * HALO_SHARDS)
        for size, epochs, key in (("256", X_HALO_EPOCHS, "velt_shard"), ("512", X_HALO512_EPOCHS, "velt_shard_512")):
            what = f"the veltracer's row function bare, halo mg on {HALO_SPEC} at {size}^2 (traced local walk)"
            problem_q, state_q, _ = vt.build(*SIZES[size], kernel="pallas_mg", device=dev, mesh=mesh,
                                             partition=HALO_PART)
            grad_q = problem_q.make_loss_grad_fn(state_q, halo=True, halo_fuse="mg")
            if grad_q is None or grad_q.route != "mg":
                fail(f"{what}: the route is {getattr(grad_q, 'route', None)}")
            counters.zero()
            opt_q, losses, chunk_ms = train(torch, Adam, grad_q, problem_q.domain.arrays_from_state(state_q), epochs)
            expect_counts(counters.read(), dict(none, backward_mg_local=HALO_SHARDS * len(losses)), what)
            launches[f"backward_mg_local_sums_traced_{key}"] = HALO_SHARDS * len(losses)
            if size == "256":
                rel_q, worst_q = rel_rows(losses, losses_b, CHUNK)
                text = (f"vs the unsharded traced run's {losses_b[0]!r} (rel {rel_q[0]:.2e}); worst {CHUNK}-epoch row "
                        f"epoch {worst_q} ({100 * rel_q[worst_q]:.4f}%)")
                bad = rel_q[0] > 1e-5 or rel_q[worst_q] > 0.01
            else:
                rel0 = abs(losses[0] - zero_512) / abs(zero_512)
                text, bad = f"vs the plain operator's {zero_512!r} (rel {rel0:.2e})", rel0 > 1e-5
            print(f"training ({what}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} {text}; "
                  f"{steady_ms(chunk_ms)[0]:.4f} ms/epoch {tag}")
            if bad:
                fail(f"{what}: leaves its reference ({text})")
            del problem_q, state_q, grad_q, opt_q

    # The generic case's t0 terms, coarse partial and params trained by Adam
    # through rowwise_mg_loss_and_grads, the public one-pass entry.
    form, user, _, a, _ = cases["net"]
    nt_, h, f0s, ds = a["nterms"], a["hist"], a["f0s"], a["data"]

    def grad_net(x, tracers):
        terms, (dt0, dP, dparams) = rmg.rowwise_mg_loss_and_grads(user, x[:2], x[2:4], f0s, params=x[4:], data=ds,
                                                                  nterms=nt_, hist=h)
        total = sum(terms)
        return (total, (list(terms), [total])), list(dt0) + list(dP) + list(dparams)

    counters.zero()
    _, losses, _ = train(torch, Adam, grad_net, [t.clone() for t in a["t0s"] + a["coarse"] + a["params"]],
                         X_BIG_EPOCHS, lr=1e-3)
    expect_counts(counters.read(), dict(none, backward_mg=X_BIG_EPOCHS), "the generic mg case's training")
    launches["backward_mg_sums_traced_net"] = X_BIG_EPOCHS
    plain = float(x_plain(torch, rmg, rw, "whole", user, a, None, True, True)[0].sum()) / a["t0s"][0].numel()
    rel0 = abs(losses[0] - plain) / abs(plain)
    print(f"the generic mg case (hist 2, params, data) at {tuple(a['t0s'][0].shape)}: {X_BIG_EPOCHS} Adam epochs "
          f"through rowwise_mg_loss_and_grads, loss {losses[0]!r} -> {losses[-1]!r}, epoch 0 against the plain version "
          f"in fp64 rel {rel0:.2e} {tag}")
    if rel0 > 1e-5 or not losses[-1] < losses[0]:
        fail(f"the generic mg case: epoch 0 rel {rel0:.2e} (limit 1e-5), losses {losses}")

    # A refused row function on the mg route: plain torch on the card, its
    # reason counted; no kernel wrapper moves.
    _, _, _, a, _ = cases["velt_256"]
    refused = rw.RowModel(x_reach2_row_fn)
    reasons = dict(rw.plain_on_card.reasons)
    counters.zero()
    terms, _ = rmg.rowwise_mg_loss_and_grads(refused, a["t0s"], a["coarse"], a["f0s"], consts=a["consts"],
                                             nterms=a["nterms"], hist=1)
    torch.cuda.synchronize()
    new = {r: n - reasons.get(r, 0) for r, n in rw.plain_on_card.reasons.items() if n != reasons.get(r, 0)}
    print(f"a refused row function on the mg route (reach x+2): plain_on_card with {new}, loss {float(sum(terms))!r} "
          f"{tag}")
    expect_counts(counters.read(), dict(none, plain_on_card=1), "phase x's refused function")
    if len(new) != 1 or "reach" not in next(iter(new)):
        fail(f"phase x: the refused function's reason is not counted: {new}")
    return timed, unlisted, off_path, hand_calls


def rowtrace_smem(tr, form):
    """rowtrace.mg2d_smem of a trace's backward block of `form`."""
    from odil_torch.ops import rowtrace

    return rowtrace.mg2d_smem(tr.nfields, tr.hist, tr.nterms, tr.nparams, tr.nstaged, True, form)


# The mesh routes of phase q: the mesh of four shards of the card, the
# evaluations of the global ladder, multi_start's starts and epochs, and the
# GSPMD CLIs' epochs.
MESH_SPEC, MESH_PART = "t:2,x:2", {"t": "t", "x": "x"}


def configs_phase(torch, np, counters, heat_ref, report, launches, loops, tag, extra_argv=()):
    """Phase u (the module docstring): every heat configuration on the row
    kernels.  Fills `report` and `launches` for the kernel table's entries
    of its paths and returns their timing entries (as main's `timed`), the
    streaming entries' slabbed launches, the bytes their slabs read again,
    and its row cases for the launch checks."""
    from odil_torch import parallel
    from odil_torch.context import Context
    from odil_torch.models import heat as th
    from odil_torch.ops import rowwise as rw
    from odil_torch.optim import Adam

    t_u = time.perf_counter()
    dev = torch.device(DEVICE)
    lane = heat_ref["config"]
    gen = torch.Generator(device=dev).manual_seed(17)
    rand = lambda *shape: 0.3 * torch.randn(shape, generator=gen, device=dev)
    none = dict.fromkeys(counters.read(), 0)
    wide = lambda ts: tuple(t.double() for t in ts)
    nbytes = lambda ts: 4 * sum(t.numel() for t in ts)
    source = "odil_torch/csrc/heat_net.cu"

    def build_kw(config):
        widths, ki, kf = U_CONFIGS[config]
        return dict(arch_k=widths, args=argparse.Namespace(
            infer_k=True, imposed=lane["imposed"], nimp=lane["nimp"], noise=0.0, seed=lane["seed"], kimp=2.0,
            kxreg=0.0, kxregdecay=0, ktreg=0.0, ktregdecay=0, kwreg=0.0, kwregdecay=0, kmax=0.1, keep_frozen=kf,
            keep_init=ki, solver="odil"))

    def case(config, T, N):
        """row_case_1d of a configuration: seeded random fields, the build's
        data and consts, its conductivity net plus seeded noise."""
        p, s, e = th.build(nt=T, nx=N, multigrid=False, kernel="pallas", device=dev, **build_kw(config))
        model, names, params = th._row_model(Context(p.domain, s, extra=e, tracers=p.tracers))
        if model.cuda_model != "heat" or model.row_vjp is None or rw._heat_library(model) is rw._library():
            fail(f"heat {config}: the row model {model.cuda_model!r} does not take the heat_net.cu kernels")
        params = tuple(q + rand(*q.shape) for q in params)
        zero = torch.zeros((1, 1), device=dev)
        u0 = e.init_u
        consts = (u0, torch.roll(u0, 1, 0), torch.roll(u0, -1, 0), torch.arange(N, dtype=torch.float32, device=dev),
                  zero, zero)
        return model, len(names), 1, (rand(T, N) + 0.5,), params, (e.imp_mask, e.imp_u + rand(T, N)), consts

    timed, slabbed, edge, row_cases = {}, {}, {}, {}
    entries = {"ki0": "64", "w32x32_kf0": "64", U_BIG: "1024"}  # the kernel table's configurations and sizes

    # u, kernels: forward, backward+sums and backward of every configuration
    # against the plain version in fp64 at 64^2 and 1024^2.
    for config in U_CONFIGS:
        for size, (T, N) in SIZES_1D.items():
            c = case(config, T, N)
            m, nt_, h, fs, ps, ds, cs_ = c
            gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
            kf = rw.forward_cuda(*c)
            kd, kp, ks = rw.backward_cuda(*c, gs, True)
            kd2, kp2, _ = rw.backward_cuda(*c, gs, False)
            pf = rw._forward_plain(m, nt_, h, wide(fs), wide(ps), wide(ds), wide(cs_))
            pd, pp, psums = rw._backward_plain(m, nt_, h, wide(fs), wide(ps), wide(ds), wide(cs_), gs.double(), True)
            torch.cuda.synchronize()
            e_f, ok_f = close(kf.double(), pf, TERMS_RTOL, 0.0)
            e_s, ok_s = close(ks.double(), psums, TERMS_RTOL, 0.0)
            e_g, ok_g = close_all([a.double() for a in kd + kp], list(pd) + list(pp))
            e_g2, ok_g2 = close_all([a.double() for a in kd2 + kp2], list(pd) + list(pp))
            e_p = max(float((a.double() - b).abs().max()) for a, b in zip(kp, pp))
            shape = rw.launch_shape(m, fs, True, True)
            print(f"heat {config} kernels at {tuple(fs[0].shape)} (net {[1, *U_CONFIGS[config][0], 1]}, "
                  f"{sum(p.numel() for p in ps)} params, keep_init {U_CONFIGS[config][1]}, keep_frozen "
                  f"{U_CONFIGS[config][2]}): forward max|d sums| {e_f:.3e} (rel {rel_err(kf, pf):.2e}), backward+sums "
                  f"max|d sums| {e_s:.3e} max|d (dfields, dparams)| {e_g:.3e} (dparams {e_p:.3e}), backward "
                  f"{e_g2:.3e}; backward+sums launch (slab, tiles, blocks, resident) {shape} {tag}")
            if not (ok_f and ok_s and ok_g and ok_g2):
                fail(f"a heat {config} kernel disagrees with its plain version at {tuple(fs[0].shape)}: forward {ok_f}, "
                     f"sums {ok_s}, backward+sums {ok_g}, backward {ok_g2}")
            if entries.get(config) != size:
                continue
            key = f"heat_{config}_{size}"
            report[f"forward_rows_{key}"], report[f"backward_rows_sums_{key}"] = e_f, e_g
            report[f"backward_rows_{key}"] = e_g2
            row_cases[key] = c
            ops_f, ops_b = heat_ops(U_CONFIGS[config][0], U_CONFIGS[config][2])
            n_cells, f_in = fs[0].numel(), nbytes(fs + ps + ds + cs_)
            timed[f"forward_rows_{key}"] = (lambda c=c: rw.forward_cuda(*c), lambda c=c: rw._forward_plain(*c),
                                            f_in + 4 * nt_, ops_f * n_cells, "odil_tpu/ops/rowwise.py:385", source)
            for sums, name in ((True, f"backward_rows_sums_{key}"), (False, f"backward_rows_{key}")):
                timed[name] = (lambda c=c, gs=gs, s=sums: rw.backward_cuda(*c, gs, s),
                               lambda c=c, gs=gs, s=sums: rw._backward_plain(*c, gs, s),
                               f_in + nbytes(fs + ps) + 4 * nt_ * (2 if sums else 1), ops_b * n_cells,
                               "odil_tpu/ops/rowwise.py:549", source)
            if config != U_BIG:
                continue
            # The streaming pair at 1024^2: the plain version's numbers and the
            # slabbed launch's bits.
            calls = (lambda: rw.forward_stream_cuda(*c), lambda: rw.backward_stream_cuda(*c, gs, True),
                     lambda: rw.backward_stream_cuda(*c, gs, False))
            sf, (sd, sp, ss), (sd2, sp2, _) = first = [f() for f in calls]
            again = [f() for f in calls]
            torch.cuda.synchronize()
            bits = same_bits(torch, first, again) and same_bits(torch, first, [kf, (kd, kp, ks), (kd2, kp2, None)])
            e_sf, ok_sf = close(sf.double(), pf, TERMS_RTOL, 0.0)
            e_ss, ok_ss = close(ss.double(), psums, TERMS_RTOL, 0.0)
            e_sg, ok_sg = close_all([a.double() for a in sd + sp], list(pd) + list(pp))
            e_sg2, ok_sg2 = close_all([a.double() for a in sd2 + sp2], list(pd) + list(pp))
            print(f"heat {config} stream kernels at {tuple(fs[0].shape)}: forward max|d sums| {e_sf:.3e}, backward "
                  f"max|d grads| {e_sg2:.3e}, backward+sums max|d sums| {e_ss:.3e} max|d grads| {e_sg:.3e}; the same "
                  f"bits call after call and as the slabbed launch: {bits} {tag}")
            if not (ok_sf and ok_ss and ok_sg and ok_sg2 and bits):
                fail(f"a heat {config} streaming kernel disagrees with its plain version or its own bits: forward "
                     f"{ok_sf}, sums {ok_ss}, backward+sums {ok_sg}, backward {ok_sg2}, bits {bits}")
            report[f"forward_stream_{key}"], report[f"backward_stream_{key}"] = e_sf, e_sg2
            plane = nbytes(fs) // fs[0].shape[0]
            timed[f"forward_stream_{key}"] = (lambda c=c: rw.forward_stream_cuda(*c), lambda c=c: rw._forward_plain(*c),
                                              f_in + 4 * nt_, ops_f * n_cells, "odil_tpu/ops/rowwise.py:676", source)
            timed[f"backward_stream_{key}"] = (lambda c=c, gs=gs: rw.backward_stream_cuda(*c, gs, False),
                                               lambda c=c, gs=gs: rw._backward_plain(*c, gs, False),
                                               f_in + nbytes(fs + ps) + 4 * nt_, ops_b * n_cells,
                                               "odil_tpu/ops/rowwise.py:811", source)
            slabbed[f"forward_stream_{key}"] = lambda c=c: rw.forward_cuda(*c)
            slabbed[f"backward_stream_{key}"] = lambda c=c, gs=gs: rw.backward_cuda(*c, gs, False)
            for name, grads, sums in ((f"forward_stream_{key}", False, True), (f"backward_stream_{key}", True, False)):
                edge[name] = -(-fs[0].shape[0] // rw.launch_shape(m, fs, grads, sums)[0]) * h * (2 if grads else 1) * plane
            del first, again

    # The masked per-shard kernels on the t:4 shards of 1024^2 (U_BIG).
    T, N = SIZES_1D["1024"]
    key = f"heat_{U_BIG}_1024"
    recs = shard_records(torch, np, th, None, heat_ref, "heat", T, N, dev, heat_kw=build_kw(U_BIG))
    errs = {"f": 0.0, "s": 0.0, "g": 0.0, "g2": 0.0}
    for i, r in enumerate(recs):
        m, nt_, h = r["row_fn"], r["nterms"], r["hist"]
        a = [tuple(x.detach().contiguous() for x in r[k]) for k in ("fields", "params", "data", "consts")]
        a64 = [tuple(x.double() for x in t) for t in a]
        gs = torch.full((nt_,), 1.0 / a[0][0].numel(), device=dev)
        kf = rw.forward_halo_rows1d_cuda(m, nt_, h, *a)
        kd, kp, ks = rw.backward_halo_rows1d_cuda(m, nt_, h, *a, gs, True)
        kd2, kp2, _ = rw.backward_halo_rows1d_cuda(m, nt_, h, *a, gs, False)
        pd, pp, _ = rw._backward_plain(m, nt_, h, *a, gs, True)
        wf = rw._forward_plain(m, nt_, h, *a64)
        wd, wp, ws = rw._backward_plain(m, nt_, h, *a64, gs.double(), True)
        torch.cuda.synchronize()
        e_f, ok_f = close(kf.double(), wf, TERMS_RTOL, 0.0)
        e_s, ok_s = close(ks.double(), ws, TERMS_RTOL, 0.0)
        e_g, ok_g, _ = close_floor(list(kd) + list(kp), list(pd) + list(pp), list(wd) + list(wp))
        e_g2, ok_g2, _ = close_floor(list(kd2) + list(kp2), list(pd) + list(pp), list(wd) + list(wp))
        if not (ok_f and ok_s and ok_g and ok_g2):
            fail(f"a per-shard heat {U_BIG} kernel disagrees with its plain version at shard {i}: forward {ok_f}, "
                 f"sums {ok_s}, backward+sums {ok_g}, backward {ok_g2}")
        errs = {"f": max(errs["f"], e_f), "s": max(errs["s"], e_s), "g": max(errs["g"], e_g), "g2": max(errs["g2"], e_g2)}
        if i == 1:
            c = (m, nt_, h) + tuple(a)
    print(f"per-shard heat {U_BIG} kernels on the {HALO1D_SHARDS} shards of {T}x{N} (t:4): forward max|d sums| "
          f"{errs['f']:.3e}, backward+sums max|d sums| {errs['s']:.3e} max|d (dfields, dparams)| {errs['g']:.3e}, "
          f"backward {errs['g2']:.3e}, against the fp64 plain version with the fp32 floor {tag}")
    report[f"forward_halo_rows1d_{key}"] = errs["f"]
    report[f"backward_halo_rows1d_sums_{key}"], report[f"backward_halo_rows1d_{key}"] = errs["g"], errs["g2"]
    m, nt_, h, fs, ps, ds, cs_ = c
    gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
    ops_f, ops_b = heat_ops(U_CONFIGS[U_BIG][0], U_CONFIGS[U_BIG][2])
    n_cells, f_in = fs[0].numel(), nbytes(fs + ps + ds + cs_ + (m.halo[0],))
    timed[f"forward_halo_rows1d_{key}"] = (lambda c=c: rw.forward_halo_rows1d_cuda(*c),
                                           lambda c=c: rw._forward_plain(*c),
                                           f_in + 4 * nt_, ops_f * n_cells, "odil_tpu/ops/rowwise.py:385", source)
    for sums, name in ((True, f"backward_halo_rows1d_sums_{key}"), (False, f"backward_halo_rows1d_{key}")):
        timed[name] = (lambda c=c, gs=gs, s=sums: rw.backward_halo_rows1d_cuda(*c, gs, s),
                       lambda c=c, gs=gs, s=sums: rw._backward_plain(*c, gs, s),
                       f_in + nbytes(fs + ps) + 4 * nt_ * (2 if sums else 1), ops_b * n_cells,
                       "odil_tpu/ops/rowwise.py:549", source)
    row_cases[f"{key} shard 1"] = c
    del recs
    t_kernels = time.perf_counter() - t_u

    def zero_state_loss(problem, state):
        loss_fn, _ = problem.make_loss_fn(state)
        with torch.no_grad():
            return float(loss_fn(problem.domain.arrays_from_state(state), problem.tracers)[0])

    def loss_only(problem, state, x, grad_fn, what, want, halo=False):
        """The loss-only path at x, its launches against `want`, its loss and
        gradients against grad_fn's."""
        counters.zero()
        (loss_e, _), grads_e = autograd_loss_grad_fn(torch, problem, state, halo=halo)(x, problem.tracers)
        torch.cuda.synchronize()
        expect_counts(counters.read(), want, f"{what} loss-only path")
        (loss_t, _), grads_t = grad_fn(x, problem.tracers)
        e, ok = close_all(grads_e, grads_t)
        print(f"{what} loss-only vs one-pass route: loss {float(loss_e)!r} vs {float(loss_t)!r}, max|dgrad| {e:.3e} "
              f"{tag}")
        if abs(float(loss_e) - float(loss_t)) > TERMS_RTOL * abs(float(loss_t)) or not ok:
            fail(f"{what}: the loss-only path and the one-pass route disagree")

    def against(losses, base, what, every):
        rel = {e: abs(losses[max(e - 1, 0)] - base[max(e - 1, 0)]) / abs(base[max(e - 1, 0)])
               for e in range(0, len(losses) + 1, every)}
        worst = max(rel, key=rel.get)
        print(f"{what}: epoch-0 loss {losses[0]!r} vs {base[0]!r} (rel {rel[0]:.2e}); worst {every}-epoch row epoch "
              f"{worst} ({100 * rel[worst]:.4f}%); final {losses[-1]!r} vs {base[len(losses) - 1]!r} {tag}")
        if rel[0] > 1e-5 or rel[worst] > 0.01:
            fail(f"{what}: epoch 0 rel {rel[0]:.2e} (limit 1e-5), epoch {worst} {100 * rel[worst]:.3f}% (limit 1%)")

    # u, training: heat 64^2 in the kernel route against kernel="xla" trained
    # the same way.
    for config in U_TRAIN:
        what = f"heat 64^2 {config}"
        problem, state, _ = th.build(nt=lane["nt"], nx=lane["nx"], kernel="pallas", device=dev, **build_kw(config))
        grad = problem.make_loss_grad_fn(state)
        if grad is None:
            fail(f"make_loss_grad_fn declined {what}")
        counters.zero()
        opt, losses, chunk_ms = train(torch, Adam, grad, problem.domain.arrays_from_state(state), U_EPOCHS, lr=1e-3)
        expect_counts(counters.read(), dict(none, backward_rows=len(losses)), f"training ({what}, pallas)")
        key = f"heat_{config}_64"
        launches[f"backward_rows_sums_{key}"] = len(losses)
        loss_only(problem, state, opt.x, grad, what, dict(none, forward_rows=1, backward_rows=1))
        launches[f"forward_rows_{key}"] = launches[f"backward_rows_{key}"] = 1
        loops[f"{what} (kernel)"] = (opt, steady_ms(chunk_ms))
        problem_x, state_x, _ = th.build(nt=lane["nt"], nx=lane["nx"], kernel="xla", device=dev, **build_kw(config))
        counters.zero()
        _, losses_x, chunk_x = train(torch, Adam, autograd_loss_grad_fn(torch, problem_x, state_x),
                                     problem_x.domain.arrays_from_state(state_x), U_EPOCHS, lr=1e-3)
        expect_counts(counters.read(), none, f"training ({what}, xla)")
        loops[f"{what} (plain operator)"] = (None, steady_ms(chunk_x))
        against(losses, losses_x, f"training ({what}, pallas vs xla; {loops[f'{what} (kernel)'][1][0]:.4f} vs "
                f"{loops[f'{what} (plain operator)'][1][0]:.4f} ms/epoch)", U_EVERY)
        del opt, problem, state, problem_x, state_x

    # U_BIG at 1024^2: the slabbed, streaming and per-shard routes, epoch 0
    # against the plain operator.
    T, N = SIZES_1D["1024"]
    key = f"heat_{U_BIG}_1024"
    plain = zero_state_loss(*th.build(nt=T, nx=N, kernel="xla", device=dev, **build_kw(U_BIG))[:2])
    mesh = parallel.mesh_from_spec(HALO1D_SPEC, devices=[dev] * HALO1D_SHARDS)
    for route in ("slabbed", "streaming", "halo"):
        what = f"heat 1024^2 {U_BIG} ({route})"
        part = dict(mesh=mesh, partition=HALO1D_PART) if route == "halo" else {}
        problem, state, _ = th.build(nt=T, nx=N, kernel="pallas", device=dev, **part, **build_kw(U_BIG))
        arrays = problem.domain.arrays_from_state(state)
        n = U_BIG_EPOCHS
        if route == "streaming":
            streaming(problem)
            if problem.make_loss_grad_fn(state) is not None:
                fail(f"{what}: make_loss_grad_fn took a streaming call")
            counters.zero()
            opt, losses, chunk_ms = train(torch, Adam, autograd_loss_grad_fn(torch, problem, state), arrays, n, lr=1e-3)
            expect_counts(counters.read(), dict(none, forward_stream=n, backward_stream=n), what)
            launches[f"forward_stream_{key}"] = launches[f"backward_stream_{key}"] = n
        else:
            grad = problem.make_loss_grad_fn(state, halo=route == "halo")
            if grad is None or (route == "halo" and grad.route != "generic"):
                fail(f"{what}: the one-pass route is {getattr(grad, 'route', None)}")
            counters.zero()
            opt, losses, chunk_ms = train(torch, Adam, grad, arrays, n, lr=1e-3)
            if route == "halo":
                expect_counts(counters.read(), dict(none, backward_halo_rows1d=HALO1D_SHARDS * n), what)
                loss_only(problem, state, opt.x, grad, what, dict(
                    none, backward_halo_rows1d=HALO1D_SHARDS, forward_halo_rows1d=HALO1D_SHARDS), halo=True)
                launches[f"backward_halo_rows1d_sums_{key}"] = HALO1D_SHARDS * n
                launches[f"forward_halo_rows1d_{key}"] = launches[f"backward_halo_rows1d_{key}"] = HALO1D_SHARDS
            else:
                expect_counts(counters.read(), dict(none, backward_rows=n), what)
                loss_only(problem, state, opt.x, grad, what, dict(none, forward_rows=1, backward_rows=1))
                launches[f"backward_rows_sums_{key}"] = n
                launches[f"forward_rows_{key}"] = launches[f"backward_rows_{key}"] = 1
        rel0 = abs(losses[0] - plain) / abs(plain)
        ms, _ = steady_ms(chunk_ms)
        print(f"training ({what}): {len(losses)} epochs, epoch-0 loss {losses[0]!r} vs the plain operator's "
              f"{plain!r} (rel {rel0:.2e}); final {losses[-1]!r}; {ms:.4f} ms/epoch {tag}")
        if rel0 > 1e-5:
            fail(f"{what}: epoch-0 loss {losses[0]} differs from the plain operator's {plain} (limit 1e-5)")
        del opt, problem, state, arrays

    # u, the CLI: --kernel pallas against --kernel xla at 256^2.
    rows, cli_ms = {}, {}
    for kernel in ("pallas", "xla"):
        out, log, counts, _, seconds = run_cli(torch, counters, "heat", U_CLI_ARGV + ["--kernel", kernel] + list(extra_argv))
        epochs = int(U_CLI_ARGV[U_CLI_ARGV.index("--epochs") + 1])
        want = dict(none, backward_rows=epochs + 1, forward_rows=1) if kernel == "pallas" else none
        expect_counts(counts, want, f"heat CLI --kernel {kernel} ({' '.join(U_CLI_ARGV)})")
        rows[kernel] = {int(r["epoch"]): float(r["loss"]) for r in out}
        cli_ms[kernel] = log_ms(log)
        print(f"heat CLI --kernel {kernel} {' '.join(U_CLI_ARGV)}: {log_ms(log):.4f} ms/epoch, {seconds:.2f} s wall; "
              f"launches {counts} {tag}")
    if sorted(rows["pallas"]) != sorted(rows["xla"]):
        fail(f"heat CLI: rows at epochs {sorted(rows['pallas'])} with pallas, {sorted(rows['xla'])} with xla")
    rel = {e: abs(rows["pallas"][e] - rows["xla"][e]) / abs(rows["xla"][e]) for e in rows["xla"]}
    worst = max(rel, key=rel.get)
    print(f"heat CLI --kernel pallas vs --kernel xla ({' '.join(U_CLI_ARGV)}): {cli_ms['pallas']:.4f} vs "
          f"{cli_ms['xla']:.4f} ms/epoch; epoch 0 rel {rel[0]:.2e}; worst row epoch {worst} ({100 * rel[worst]:.4f}%) "
          f"{tag}")
    if rel[0] > 1e-5 or rel[worst] > 0.01:
        fail(f"heat CLI: --kernel pallas parts from --kernel xla (epoch 0 rel {rel[0]:.2e}, limit 1e-5; epoch {worst} "
             f"{100 * rel[worst]:.3f}%, limit 1%)")
    print(f"phase u: {time.perf_counter() - t_u:.1f} s (its kernel checks {t_kernels:.1f} s) {tag}")
    return timed, slabbed, edge, row_cases


MESH_SPEC_XY = "x:2,y:2"
LADDER_EVALS = 20
STARTS, STARTS_PLAIN_EPOCHS, STARTS_KERNEL_EPOCHS = 4, 200, 50
GSPMD_EPOCHS, GSPMD_EVERY = 200, 20


def mesh_phase(torch, np, counters, heat_lane, vt_rows, vt_ms, vt_epochs, poisson_gn, tag, extra_argv=()):
    """Phase q: every mesh route on the card.  q1 Gauss-Newton under --halo
    (the halo residual map), q2 the global multigrid ladder of the halo
    loss, q3 ``parallel.multi_start`` on a plain and a kernel route, q4 the
    GSPMD route (``--mesh`` without ``--halo``) of three CLIs.  `vt_rows`,
    `vt_ms`: phase m's veltracer CLI rows and ms/epoch; `poisson_gn`: phase
    o's plain-CG poisson gn rows, ms/epoch and normal matvecs an epoch.
    Returns the launches of the kernels on phase q's paths and the rows and
    ms/epoch that phase s holds its processes to.  extra_argv goes to every
    CLI (a rehearsal on the CPU passes --device)."""
    import argparse

    from odil_torch import parallel
    from odil_torch.halo import make_halo_loss_fn
    from odil_torch.models import poisson as tpo
    from odil_torch.models import veltracer as vt
    from odil_torch.optim import Adam
    from odil_torch.optim.base import autograd_loss_grad_fn as loss_grad_of

    none = dict.fromkeys(counters.read(), 0)
    dev = torch.device(DEVICE)
    launches, keep = {}, {"q4 ms": {}}

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    def mesh_line(log, spec):
        want = f"mesh: {parallel.mesh_from_spec(spec, devices=[dev] * 4).shape}"
        if not any(want in line for line in log):
            fail(f"the CLI's train.log has no line '{want}'")

    # q1. The run script's poisson gn case under --mesh x:2,y:2 --halo 1:
    # rows within the band phase o holds the unsharded case to.
    with open(NEWTON_DATA) as fh:
        case = json.load(fh)["cases"]["poisson_gn"]
    rows0, ms0, mv0 = poisson_gn
    what = f"poisson gn CLI (64^2 fp64, plain CG) under --mesh {MESH_SPEC_XY} --halo 1"
    csv_rows, log, counts, (problem, state), seconds = run_cli(
        torch, counters, "poisson", case["argv"] + ["--mesh", MESH_SPEC_XY, "--halo", "1"] + list(extra_argv))
    expect_counts(counts, none, what)
    mesh_line(log, MESH_SPEC_XY)
    rows = value_rows(csv_rows, case["columns"])
    rows_gate(rows, rows0, case["columns"], what + " (rtol 1e-7 or twice the JAX package's own spread)", tag, 1e-7,
              spread=case["jax_spread"], whose="phase o's unsharded")
    keep["q1"] = (rows, log_ms(log))
    stats = problem.solver_stats
    if {a.device.type for a in problem.domain.arrays_from_state(state)} != {dev.type}:
        fail(f"{what}: the iterate is not on {dev}")
    print(f"{what}: {log_ms(log):.4f} ms/epoch, {stats['matvecs'] / stats['epochs']:.1f} normal matvecs an epoch, "
          f"{seconds:.2f} s wall; unsharded (phase o) {ms0:.4f} ms/epoch, {mv0:.1f} normal matvecs an epoch {tag}")

    # q2. The halo loss of velocity_from_tracer (pallas, 64x256x256, t:2,x:2)
    # with the global and the local multigrid ladder: autograd of
    # make_halo_loss_fn at a seeded random state.
    nt, nx, ny = SIZES["256"]
    mesh = parallel.mesh_from_spec(MESH_SPEC, devices=[dev] * 4)
    p, s, _ = vt.build(nt=nt, nx=nx, ny=ny, kernel="pallas", device=dev, mesh=mesh, partition=MESH_PART)
    gen = torch.Generator(device=dev).manual_seed(21)
    x = [0.3 * torch.randn(tuple(a.shape), generator=gen, device=dev) for a in p.domain.arrays_from_state(s)]
    p0, s0, _ = vt.build(nt=nt, nx=nx, ny=ny, kernel="pallas", device=dev)
    p64, s64, _ = vt.build(nt=nt, nx=nx, ny=ny, kernel="xla", dtype=np.float64, device=dev)
    refs = {}
    for name, (pr, st, xs) in {"fp32": (p0, s0, x), "fp64": (p64, s64, [a.double() for a in x])}.items():
        leaves = [a.clone().requires_grad_(True) for a in xs]
        loss, _ = pr.make_loss_fn(st)[0](leaves, pr.tracers)
        refs[name] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    del p0, s0, p64, s64
    ladder = {}
    for name in ("global", "local"):
        fn, _ = make_halo_loss_fn(p, s, mg_ladder=name)
        counters.zero()
        ms = []
        for _ in range(LADDER_EVALS):
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            leaves = [a.clone().requires_grad_(True) for a in x]
            loss, _ = fn(leaves, p.tracers)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t_start) * 1e3)
        counts = counters.read()
        expect_counts(counts, dict(none, forward_halo=4 * LADDER_EVALS, backward_halo=4 * LADDER_EVALS),
                      f"halo loss with the {name} ladder")
        ladder[name] = (float(loss.detach()), grads, statistics.median(ms[1:]))
        launches[f"q2 {name}"] = nonzero(counts)
    rel = {k: abs(v[0] - refs["fp32"][0]) / abs(refs["fp32"][0]) for k, v in ladder.items()}
    rel64 = {k: abs(v[0] - refs["fp64"][0]) / abs(refs["fp64"][0]) for k, v in ladder.items()}
    err, ok, worst = close_floor(ladder["global"][1], ladder["local"][1], refs["fp64"][1])
    print(f"halo loss (64x256x256 pallas, {MESH_SPEC}, autograd of make_halo_loss_fn, {LADDER_EVALS} evaluations "
          f"each): global ladder {ladder['global'][2]:.4f} ms, local {ladder['local'][2]:.4f} ms a loss+grad "
          f"(median after the first); loss rel to the unsharded pallas loss {rel['global']:.2e} / {rel['local']:.2e}, "
          f"to the fp64 plain operator {rel64['global']:.2e} / {rel64['local']:.2e}; gradients global vs local "
          f"max|d| {err:.3e}, {worst_text(worst)} {tag}")
    if max(rel.values()) > 1e-5:
        fail(f"halo loss: rel {rel} to the unsharded loss (limit 1e-5)")
    if not ok:
        fail(f"halo loss: the global ladder's gradients off the local ladder's beyond close_floor ({worst_text(worst)})")
    del p, s, fn, x, refs, ladder, grads, leaves

    # q3. multi_start: poisson 64^2 (plain torch, fp64, vmap) and heat 64^2
    # (kernel route, fp32, a loop over the instances).
    args = argparse.Namespace(ref="osc", rhs="exact", osc_k=2.0, mgloss=0)
    p, s, _ = tpo.build(n=64, ndim=2, args=args, dtype=np.float64, device=dev)
    loss_b, stacked = parallel.multi_start(p, s, STARTS, seed=0, scale=0.5)
    loss_fn, _ = p.make_loss_fn(s)

    def instance_losses(arrays_b):
        with torch.no_grad():
            return [float(loss_fn([a[i] for a in arrays_b], p.tracers)[0]) for i in range(STARTS)]

    l0 = instance_losses(stacked)
    with torch.no_grad():
        lb0 = float(loss_b(stacked, p.tracers)[0])
    counters.zero()
    opt, keep["q3 poisson"], chunk_ms = train(torch, Adam, loss_grad_of(loss_b), stacked, STARTS_PLAIN_EPOCHS, lr=1e-3)
    expect_counts(counters.read(), none, "multi_start on poisson (plain torch)")
    l1 = instance_losses(opt.x)
    single_ms = [steady_ms(train(torch, Adam, loss_grad_of(loss_fn), [a[i] for a in stacked], STARTS_PLAIN_EPOCHS,
                                 lr=1e-3)[2])[0] for i in range(STARTS)]
    rel0 = abs(lb0 - statistics.fmean(l0)) / abs(statistics.fmean(l0))
    print(f"multi_start (poisson 64^2 fp64, {STARTS} starts, scale 0.5, loss_fn_b {loss_b.form}, Adam lr 0.001, "
          f"{STARTS_PLAIN_EPOCHS} epochs): batched loss at epoch 0 {lb0!r} against the mean of the instances' "
          f"{statistics.fmean(l0)!r} (rel {rel0:.2e}); instance losses {l0} -> {l1}; batched "
          f"{steady_ms(chunk_ms)[0]:.4f} ms/epoch against four single runs {sum(single_ms):.4f} "
          f"({', '.join(f'{m:.4f}' for m in single_ms)}) {tag}")
    if loss_b.form != "vmap" or rel0 > 1e-12 or not all(b < a for a, b in zip(l0, l1)):
        fail(f"multi_start on poisson: form {loss_b.form}, epoch-0 rel {rel0:.2e} (limit 1e-12), losses {l0} -> {l1}")
    del p, s, loss_b, stacked, opt

    p, s, _ = heat_lane_build(torch, np, heat_lane, dev)
    loss_b, stacked = parallel.multi_start(p, s, STARTS, seed=2, scale=0.05)
    loss_fn, _ = p.make_loss_fn(s)

    def scaled(arrays, tracers):
        loss, aux = loss_fn(arrays, tracers)
        return loss / STARTS, aux

    def kernel_run(fn, arrays, batch):
        """Adam lr 0.001 in chunks of CHUNK epochs on the `batch` of instances
        or one: (optimizer, host ms/epoch of the chunks, launches while
        training, each instance's loss at epoch 0 and after each chunk, the
        losses of every epoch)."""
        o = Adam(loss_grad_of(fn), arrays, lr=1e-3)
        rows, ms, counts, losses = [], [], dict(none), []

        def row():
            with torch.no_grad():
                xs = [[a[i] for a in o.x] for i in range(STARTS)] if batch else [o.x]
                return [float(loss_fn(xi, p.tracers)[0]) for xi in xs]

        rows.append(row())
        for _ in range(STARTS_KERNEL_EPOCHS // CHUNK):
            counters.zero()
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            out = o.run_chunk(CHUNK, p.tracers)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t_start) * 1e3 / CHUNK)
            counts = {k: counts[k] + v for k, v in counters.read().items()}
            losses += out.cpu().tolist()
            rows.append(row())
        return o, ms, counts, rows, losses

    _, ms_b, counts, rows_b, keep["q3 heat"] = kernel_run(loss_b, stacked, True)
    keep["q3 heat rows"] = rows_b
    expect_counts(counts, dict(none, forward_rows=STARTS * STARTS_KERNEL_EPOCHS,
                               backward_rows=STARTS * STARTS_KERNEL_EPOCHS),
                  "multi_start on heat's kernel route (a loop over the instances)")
    launches["q3 heat"] = nonzero(counts)
    worst, single_ms = 0.0, []
    for i in range(STARTS):
        _, ms_i, _, rows_i, _ = kernel_run(scaled, [a[i] for a in stacked], False)
        single_ms.append(steady_ms(ms_i)[0])
        for e, (a, b) in enumerate(zip(rows_b, rows_i)):
            worst = max(worst, abs(a[i] - b[0]) / abs(b[0]))
    print(f"multi_start (heat 64^2 --kernel pallas fp32, {STARTS} starts, scale 0.05, loss_fn_b {loss_b.form}, Adam "
          f"lr 0.001, {STARTS_KERNEL_EPOCHS} epochs): every instance's rows (epoch 0 and every {CHUNK}) against its "
          f"single-start run (the loss scaled by 1/{STARTS}) largest rel {worst:.2e}; launches {nonzero(counts)}; batched "
          f"{steady_ms(ms_b)[0]:.4f} ms/epoch against four single runs {sum(single_ms):.4f} {tag}")
    if loss_b.form != "loop" or worst > TERMS_RTOL:
        fail(f"multi_start on heat: form {loss_b.form}, rows rel {worst:.2e} from the single-start runs (limit "
             f"{TERMS_RTOL})")
    del p, s, loss_b, stacked

    # q4. The GSPMD route: three CLIs with --mesh and without --halo give the
    # unsharded CLI's rows to the bit and launch the same kernels.
    values = lambda rs: [{k: v for k, v in r.items() if k not in NOT_VALUES or k in ("epoch", "frame")} for r in rs]
    every = ["--history_every", str(GSPMD_EVERY), "--report_every", str(GSPMD_EVERY), "--plot_every", "0"]
    clis = {
        "poisson": (["--N", "64", "--ref", "osc", "--rhs", "exact", "--double", "1", "--epochs", str(GSPMD_EPOCHS)]
                    + every, MESH_SPEC_XY, none, None),
        "heat": (["--Nt", str(heat_lane["nt"]), "--Nx", str(heat_lane["nx"]), "--infer_k", "1", "--imposed",
                  heat_lane["imposed"], "--nimp", str(heat_lane["nimp"]), "--seed", str(heat_lane["seed"]),
                  "--kernel", "pallas", "--epochs", str(GSPMD_EPOCHS)] + every, MESH_SPEC,
                 dict(none, backward_rows=GSPMD_EPOCHS + 1, forward_rows=1), None),
        "veltracer": (["--Nt", str(nt), "--Nx", str(nx), "--Ny", str(ny), "--kernel", "pallas_mg", "--epochs",
                       str(vt_epochs), "--history_every", str(CHUNK), "--report_every",
                       str(100 if vt_epochs >= 300 else CHUNK), "--plot_every", "0"], MESH_SPEC,
                      dict(none, backward_mg=vt_epochs + 1, backward_mg_with_sums=vt_epochs, forward_mg=1),
                      (vt_rows, vt_ms)),
    }
    for name, (argv, spec, want, ref) in clis.items():
        if ref is None:
            rows0, log0, counts0, *_ = run_cli(torch, counters, name, argv + list(extra_argv))
            expect_counts(counts0, want, f"{name} CLI (unsharded)")
            ref = (rows0, log_ms(log0))
        rows, log, counts, (problem, state), _ = run_cli(torch, counters, name, argv + ["--mesh", spec]
                                                         + list(extra_argv))
        expect_counts(counts, want, f"{name} CLI --mesh {spec}")
        mesh_line(log, spec)
        arrays = problem.domain.arrays_from_state(state)
        placed = parallel.shard_state_arrays(problem.domain, arrays)
        same = values(rows) == values(ref[0])
        print(f"{name} CLI --mesh {spec} (the GSPMD route, {argv[argv.index('--epochs') + 1]} epochs): train.csv rows "
              f"equal to the unsharded CLI's to the bit: {same}; {log_ms(log):.4f} ms/epoch against the unsharded "
              f"{ref[1]:.4f}; launches {nonzero(counts)}; state on {sorted({str(a.device) for a in arrays})} {tag}")
        if not same:
            fail(f"{name} CLI --mesh {spec}: train.csv rows differ from the unsharded CLI's")
        if any(a.device.type != dev.type for a in arrays) or any(a is not b for a, b in zip(placed, arrays)):
            fail(f"{name} CLI --mesh {spec}: the state left the card or its placement copied it")
        launches[f"q4 {name}"] = nonzero(counts)
        keep["q4 ms"][name] = log_ms(log)
    return launches, keep


def finite_numbers(obj):
    """Whether every number in a JSON-like object is finite."""
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(finite_numbers(v) for v in obj)
    if isinstance(obj, (int, float)):
        return obj == obj and abs(obj) != float("inf")
    return True


def probes_phase(torch, counters, builds, row_model, launches, report, tag):
    """v. The roofline's copy3 and the ablation's fma probes and the two
    ablation builds of the mg kernel against their plain versions, the
    port's roofline and kernel-ablation tools on the card, and the card's
    measured ceilings.  Returns (the timed entries, {name: its library
    call}, (measured HBM bytes/s, measured fp32 FLOP/s))."""
    from odil_torch.ops import mg_ablation, probes
    from odil_torch.tools import kernel_ablation, roofline

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(18)
    K = probes.FMA_K
    none = dict.fromkeys(counters.read(), 0)
    n_chain = (1 + V_REPS) * V_LENGTH
    argv = {s: ["--nt", str(T - 1), "--nx", str(X), "--length", str(V_LENGTH), "--reps", str(V_REPS)]
            for s, (T, X, _) in V_SIZES.items()}
    probe_src, mg_src = "odil_torch/csrc/probes.cu", "odil_torch/csrc/rowwise_mg.cu"

    ffma = sass_opcount(builds["probes"][0], f"fma_kernelILi{K}E", "FFMA")
    if ffma is None:
        print(f"fma probe: no cuobjdump in the toolkit, its FFMA not counted {tag}")
    else:
        print(f"fma probe: {ffma} FFMA in fma_kernel<{K}> (four chains a thread and the scalar tail: at least "
              f"{4 * K}) {tag}")
        if ffma < 4 * K:
            fail(f"the fma probe's chain was shortened: {ffma} FFMA in fma_kernel<{K}>, fewer than {4 * K}")

    # The kernels against their plain versions.
    inputs, timed, library = {}, {}, {}
    variants = (("trivial_row", mg_ablation.backward_trivial_row_cuda, mg_ablation._backward_trivial_row_plain,
                 OPS_TRIVIAL_ROW_BACKWARD),
                ("no_matmul", mg_ablation.backward_no_matmul_cuda, mg_ablation._backward_no_matmul_plain,
                 OPS_NO_MATMUL_BACKWARD))
    for size, shape in V_SIZES.items():
        abc = tuple(torch.rand(shape, generator=gen, device=dev) for _ in range(3))
        inputs[size] = abc
        k, k2, p = probes.copy3_cuda(*abc), probes.copy3_cuda(*abc), probes._copy3_plain(*abc)
        kf, pf = probes.fma_cuda(abc[0], K), probes._fma_plain(abc[0], K)
        torch.cuda.synchronize()
        bits = all(torch.equal(x, y) for x, y in zip(k + k2, p + p))
        e_f, ok_f = close(kf.double(), pf.double(), V_FMA_RTOL, 0.0)
        print(f"probes at {shape}: copy3 the bits of three clones call after call: {bits}; fma max|d| {e_f:.3e} "
              f"(max rel {rel_err(kf, pf):.2e}, rtol {V_FMA_RTOL}) {tag}")
        if not (bits and ok_f):
            fail(f"a probe disagrees with its plain version at {shape}: copy3 bits {bits}, fma {ok_f}")
        report[f"copy3_{size}"], report[f"fma_{size}"] = 0.0, e_f
        n = abc[0].numel()
        timed[f"copy3_{size}"] = (lambda abc=abc: probes.copy3_cuda(*abc), lambda abc=abc: probes._copy3_plain(*abc),
                                  6 * 4 * n, 0, "benchmarks/roofline.py:129", probe_src)
        library[f"copy3_{size}"] = lambda abc=abc: [x.clone() for x in abc]
        timed[f"fma_{size}"] = (lambda x=abc[0]: probes.fma_cuda(x, K), lambda x=abc[0]: probes._fma_plain(x, K),
                                2 * 4 * n, 2 * K * n, "benchmarks/kernel_ablation.py:181", probe_src)
        del k, k2, p, kf, pf

        model, nterms, consts = row_model(size)
        T, X, Y = shape
        t0s = tuple(0.3 * torch.randn((T, X, Y), generator=gen, device=dev) for _ in range(3))
        coarse = tuple(0.3 * torch.randn((T // 2 + 1, X // 2, Y // 2), generator=gen, device=dev) for _ in range(3))
        cells = t0s[0].numel()
        g = torch.full((nterms,), 1.0 / cells, device=dev)
        f0s = (0.7, 1.1, 0.9)
        wide = lambda ts: tuple(t.double() for t in ts)
        for variant, kernel, plain, ops in variants:
            args_ = (model, nterms, 1, f0s, t0s, coarse, consts, g, True)
            kd, kP, ks = kernel(*args_)
            pd, pP, ps = plain(*args_)
            qd, qP, _ = plain(model, nterms, 1, f0s, wide(t0s), wide(coarse), wide(consts), g.double(), True)
            torch.cuda.synchronize()
            e_s, ok_s = close(ks.double() / cells, ps.double() / cells, TERMS_RTOL, 0.0)
            e_g, ok_g, w_g = close_floor(kd + kP, pd + pP, qd + qP)
            print(f"mg ablation build {variant} at {shape}: max|d sums| {e_s:.3e} (max rel {rel_err(ks, ps):.2e}), "
                  f"max|d(dt0,dP)| {e_g:.3e} against its own plain version; {worst_text(w_g)} {tag}")
            if not (ok_s and ok_g):
                fail(f"the mg ablation build {variant} disagrees with its plain version at {shape} (sums {ok_s}, "
                     f"grads {ok_g})")
            del kd, kP, ks, pd, pP, ps, qd, qP
            if size == "256":  # the shape of the ablation tool's chains
                name = f"backward_mg_{variant}"
                report[name] = e_g
                nbytes = 4 * sum(t.numel() for t in t0s + coarse + tuple(consts) + t0s + coarse) + 8 * nterms
                timed[name] = (lambda k=kernel, a=args_: k(*a), lambda p=plain, a=args_: p(*a), nbytes, ops * cells,
                               "odil_tpu/ops/rowwise_mg.py:766", mg_src)

    # The tools, each with the counters zeroed just before it and read after.
    def run_tool(what, fn, want):
        counters.zero()
        out = fn()
        torch.cuda.synchronize()
        counts = counters.read()
        expect_counts(counts, dict(none, **want), what)
        if not finite_numbers(out):
            fail(f"{what}: a number of its output is not finite: {out}")
        return out, counts

    rl, counts = run_tool("the roofline tool", lambda: roofline.main(argv["256"]),
                          {"backward_mg": 3 * n_chain, "backward_mg_with_sums": 3 * n_chain, "copy3": n_chain})
    launches["copy3_256"] = counts["copy3"]
    launches["backward_mg_sums"] += counts["backward_mg"]
    losses = rl["chunk_last_losses"]
    print(f"roofline tool: the full epoch with bf16 slots {rl['epoch_ms']} ms (fp32 slots "
          f"{rl['epoch_fp32_slots_ms']} ms), loss+grad {rl['lossgrad_ms']} ms, copy3 {rl['copy_ms']} ms at "
          f"{rl['copy_ceiling_GBps']} GB/s; the last loss of each chunk, bf16 slots {losses['bf16']} against fp32 "
          f"slots {losses['fp32']} (not gated) {tag}")
    ka, counts = run_tool("the kernel-ablation tool", lambda: kernel_ablation.main(argv["256"] + ["--variants", V_VARIANTS]),
                          {"backward_mg": 2 * n_chain, "backward_mg_with_sums": 2 * n_chain, "backward_trivial_row": n_chain,
                           "backward_no_matmul": n_chain, "fma": n_chain})
    launches["backward_mg_sums"] += counts["backward_mg"]
    launches["backward_mg_trivial_row"] = counts["backward_trivial_row"]
    launches["backward_mg_no_matmul"] = counts["backward_no_matmul"]
    launches["fma_256"] = counts["fma"]
    ka512, counts = run_tool("the kernel-ablation tool's vpu probe at 512^2",
                             lambda: kernel_ablation.main(argv["512"] + ["--variants", "vpu"]), {"fma": n_chain})
    launches["fma_512"] = counts["fma"]
    (dt_c512, reps_c512, _), counts = run_tool(
        "the roofline tool's copy3 chain at 512^2",
        lambda: roofline.timed_chain(roofline.copy_chain(V_LENGTH), inputs["512"], V_LENGTH, V_REPS, dev),
        {"copy3": n_chain})
    launches["copy3_512"] = counts["copy3"]
    print(f"kernel-ablation tool: {ka['ms_per_iter']} ms/iter; row math {ka.get('row_math_bound_ms')} ms, in-kernel "
          f"prolongation {ka.get('in_kernel_matmul_bound_ms')} ms, prologue and epilogue "
          f"{ka.get('xla_prologue_epilogue_ms')} ms; fma chain {ka['vpu_ceiling_tflops']} TFLOP/s at 256^2, "
          f"{ka512['vpu_ceiling_tflops']} at 512^2; the copy3 chain at 512^2 {1e3 * dt_c512:.4f} ms/call "
          f"(reps {reps_c512}) {tag}")

    # The measured ceilings: the copy rate at 512^2 (the HBM reading), the
    # larger FMA rate (both lower bounds of the FMA ceiling).
    copy_ms = {s: kernel_ms(torch, lambda s=s: probes.copy3_cuda(*inputs[s]), 50) for s in V_SIZES}
    fma_ms = {s: kernel_ms(torch, lambda s=s: probes.fma_cuda(inputs[s][0], K), 50) for s in V_SIZES}
    copy_rate = {s: 6 * 4 * inputs[s][0].numel() / (copy_ms[s] * 1e-3) for s in V_SIZES}
    fma_rate = {s: 2 * K * inputs[s][0].numel() / (fma_ms[s] * 1e-3) for s in V_SIZES}
    ceilings = (copy_rate["512"], max(fma_rate.values()))
    print(f"measured ceilings: copy3 {copy_rate['512'] / 1e9:.1f} GB/s at {V_SIZES['512']} (HBM; "
          f"{copy_rate['256'] / 1e9:.1f} GB/s at {V_SIZES['256']}, partly L2) against the data sheet's "
          f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s ({100 * ceilings[0] / HBM_BYTES_PER_S:.1f}%); fma "
          f"{fma_rate['256'] / 1e12:.2f} TFLOP/s at {V_SIZES['256']}, {fma_rate['512'] / 1e12:.2f} at "
          f"{V_SIZES['512']} against the data sheet's {FP32_FLOPS / 1e12:.0f} TFLOP/s "
          f"({100 * ceilings[1] / FP32_FLOPS:.1f}%; lower bounds of the FMA ceiling) {tag}")
    return timed, library, ceilings


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=400, help="Flagship training epochs (multiple of 10)")
    parser.add_argument("--seed", type=int, default=0, help="Seed of the random kernel inputs")
    parser.add_argument("--dist-worker", nargs=5, metavar=("JOB", "RANK", "WORLD", "PORT", "OUT"),
                        help="Run one process of a phase-r job (started by the script itself)")
    args = parser.parse_args()
    t_main = time.perf_counter()
    if args.dist_worker:
        job, rank, world, port, out = args.dist_worker
        if job.startswith("s"):
            routes_worker(job, int(rank), int(world), port, out)
        elif job.startswith("t"):
            spanning_worker(job, int(rank), int(world), port, out)
        else:
            dist_worker(job, int(rank), int(world), port, out)
        return

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
    # The heat_net.cu libraries of phase u's nets start with the others and
    # are waited for before phase u.
    heat_nets = sorted({widths for widths, _, _ in U_CONFIGS.values()})
    from odil_torch.ops import mg_ablation

    ablations = [("rowwise_mg", v, (("ODIL_MG_ABLATION", code),)) for v, code in mg_ablation.ABLATIONS.items()]
    # Phase l's user row functions, traced before any build (their models
    # built on the card): their generated sources build with the others.
    l_cases = traced_cases(th, tw, np, rw, torch.device(DEVICE))
    traced = [("generated", "rows1d_traced", spec.trace.source, f"{w}_{size}")
              for (w, size), (_, _, _, spec) in l_cases.items()]
    # Phase w's traced row models (2-D planes, shards), the same way.
    with open(HEAT_DATA) as fh:
        w_traced = w_cases(torch, np, th, tw, vt, rw, json.load(fh), torch.device(DEVICE))
    traced += [job for job in w_builds(w_traced) if job[2] not in {j[2] for j in traced}]
    # Phase x's traced mg walks (phase w's row functions on the mg route).
    x_traced = x_cases(torch, rw, rmg, w_traced, torch.device(DEVICE))
    traced += x_builds(x_traced)
    pending = start_builds(_build, ["rowwise_mg", "rowwise", "probes"] + ablations
                           + [rw.heat_net_source(w) for w in heat_nets] + traced)
    builds = report_builds({k: pending.pop(k) for k in ("rowwise_mg", "rowwise")})
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

    kd0, kP, _, ksums = rmg.backward_mg_cuda(model, nterms, 1, f0s, t0s, coarse, consts, g, True)
    pd0, pP, _, psums = rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, coarse, consts, g, True)
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
    terms_k = rmg.rowwise_loss_terms_mg(model, leaves_k[:3], leaves_k[3:], f0s, consts=consts, nterms=nterms, hist=1)
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
        d0, dP1, _, sums = rmg._backward_mg_plain(model, nterms, 1, f0s, t0s, P2s, consts, g, with_sums,
                                                  lvl2=(t1s, f1s))
        return (d0,) + rmg._split_dp1(dP1, f1s, W1x, W1y) + (sums,)

    for with_sums, name in ((True, "backward_mg2_sums"), (False, "backward_mg2")):
        call = lambda: rmg.backward_mg2_cuda(model, nterms, 1, f0s, f1s, t0s, t1s, P2s, consts, g, with_sums)
        k, k2, p = call(), call(), lvl2_plain(with_sums)
        torch.cuda.synchronize()
        bits = same_bits(torch, k, k2)
        e_g, ok_g = close_all(k[0] + k[1] + k[2], p[0] + p[1] + p[2])
        e_s, ok_s = close(k[4].double(), p[3].double(), TERMS_RTOL, 0.0) if with_sums else (0.0, True)
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
        e_ms, ok_ms = close(km[4].double(), pm[4].double(), TERMS_RTOL, 0.0)
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
    e_s, ok_s = close(k[4].double(), p[4].double(), TERMS_RTOL, 0.0)
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
    e_s, ok_s = close(k[3].double(), p[3].double(), TERMS_RTOL, 0.0)
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
    pallas_losses = losses
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

    # l. User row functions on 1-D planes on the traced kernels (their
    # libraries built with the others, waited for here with phase u's).
    builds.update(report_builds(pending))
    t_l = time.perf_counter()
    l_timed, hand_calls, l_slabbed = traced_phase(torch, np, counters, l_cases, builds, report, launches, loops, tag)
    t_l = time.perf_counter() - t_l

    # u. Every heat configuration on the row kernels: keep_init=0,
    # keep_frozen=0 and wider and deeper conductivity nets.
    t_u = time.perf_counter()
    wide_forms(builds, tag)
    u_timed, u_slabbed, u_edge, u_cases = configs_phase(torch, np, counters, heat_ref, report, launches, loops, tag)
    t_u = time.perf_counter() - t_u

    # w. User row functions on 2-D planes and on a shard's block on the
    # traced kernels (their libraries built with the others).
    t_w = time.perf_counter()
    w_timed, w_hand, w_slabbed = user2d_phase(torch, np, counters, w_traced, builds, report, launches, loops,
                                              pallas_losses, zero_loss, heat_ref, tag)
    t_w = time.perf_counter() - t_w

    # x. A user's row function on the mg route: the traced mg walk (its
    # libraries built with the others).
    t_x = time.perf_counter()
    x_timed, x_unlisted, x_off, x_hand = mg_user_phase(torch, np, counters, x_traced, builds, report, launches, loops,
                                                       losses_unsharded, zero_loss, tag)
    t_x = time.perf_counter() - t_x

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
    poisson_gn = newton_phase(torch, counters, tag)

    # p. Heat and wave under --halo, plot epochs, asynchronous checkpoints and
    # compare.py.
    t_p = time.perf_counter()
    p_launches, halo1d_cases = halo1d_phase(torch, np, counters, heat_ref, vt_rows, vt_ms, args.epochs, report,
                                            {"heat": heat_plain_big, "wave": wave_plain_big}, tag)
    t_p = time.perf_counter() - t_p
    launches.update(p_launches)

    # q. Every mesh route on the card: Gauss-Newton under --halo, the global
    # multigrid ladder, multi_start and the GSPMD route.
    t_q = time.perf_counter()
    q_launches, q_refs = mesh_phase(torch, np, counters, heat_ref["config"], vt_rows, vt_ms, args.epochs, poisson_gn,
                                    tag)
    t_q = time.perf_counter() - t_q
    print(f"phase q: launches on its paths {q_launches}; {t_q:.1f} s {tag}")

    # r. The halo route over several processes (torch.distributed).
    t_r = time.perf_counter()
    r_launches = dist_phase(torch, np, counters, {f: v[0] for f, v in halo_losses.items()},
                            {f: loops[f"halo {f} 256"][1][0] for f in halo_losses}, ref256, heat_ref, args.epochs, tag)
    t_r = time.perf_counter() - t_r
    for name, n in r_launches.items():
        launches[name] += n

    # s. The GSPMD route, Gauss-Newton and multi_start over several processes.
    t_s = time.perf_counter()
    s_launches = routes_phase(torch, np, counters, heat_ref, q_refs, poisson_gn,
                              {f: loops[f"halo {f} 256"][1][0] for f in halo_losses}, tag)
    t_s = time.perf_counter() - t_s
    for name, n in s_launches.items():
        launches[name] += n
        print(f"phase s: {name} +{n} launches (s) {tag}")

    # t. L-BFGS over processes, --halo with an idle mesh axis, multi_start on
    # a domain mesh over processes, and the ctx.mod surface on the card.
    t_t = time.perf_counter()
    t_launches = spanning_phase(torch, np, counters, q_refs, tag)
    t_t = time.perf_counter() - t_t
    for name, n in t_launches.items():
        launches[name] += n
        print(f"phase t: {name} +{n} launches (t) {tag}")

    # v. The probes, the ablation builds and the tools that run them.
    t_v = time.perf_counter()
    v_timed, library, (ceil_bytes, ceil_flops) = probes_phase(torch, counters, builds, row_model, launches, report, tag)
    t_v = time.perf_counter() - t_v

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

    # Phase l's, phase u's and phase v's kernels.
    timed.update(l_timed)
    timed.update(u_timed)
    timed.update(w_timed)
    timed.update(x_timed)
    timed.update(v_timed)
    unlisted.update(x_unlisted)
    off_path.update(x_off)
    slabbed.update(l_slabbed)
    slabbed.update(u_slabbed)
    slabbed.update(w_slabbed)
    hand_calls.update(w_hand)
    hand_calls.update(x_hand)
    edge.update(u_edge)
    row_cases.update(u_cases)

    print_mg_splits()
    # A backward+sums of the row kernels, slabbed or streaming (the masked
    # one slabbed), is one launch (torch.profiler; after the training loops,
    # which a profiler session leaves slower on the host).
    for key, (m, nt_, h, fs, ps, ds, cs) in row_cases.items():
        gs = torch.full((nt_,), 1.0 / fs[0].numel(), device=dev)
        per_call = {}
        routes = (("slabbed", rw._halo_kernels(m)[1]),) if m.halo is not None else (
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
          + ", ".join(f"heat {c} {heat_ops(w, kf)} (net {heat_net_ops(w)})" for c, (w, _, kf) in U_CONFIGS.items())
          + ", "
          f"OPS_WAVE_FORWARD {OPS_WAVE_FORWARD}, OPS_WAVE_BACKWARD {OPS_WAVE_BACKWARD}, OPS_ROWS_FORWARD "
          f"{OPS_ROWS_FORWARD}, OPS_ROWS_BACKWARD {OPS_ROWS_BACKWARD} {tag}")
    kernels = []
    for name, (kfn, pfn, nbyte, ops, replaced, source) in list(timed.items()) + list(unlisted.items()):
        ms = kernel_ms(torch, kfn, 50)
        plain_ms = time_ms(torch, pfn, 3)
        t_bytes = nbyte / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        bound_measured_ms = max(nbyte / ceil_bytes, ops / ceil_flops) * 1e3
        library_ms = kernel_ms(torch, library[name], 50) if name in library else None
        beside = f", slabbed launch {kernel_ms(torch, slabbed[name], 50):.4f} ms" if name in slabbed else ""
        if name in edge:
            t_edge = max((nbyte + edge[name]) / HBM_BYTES_PER_S * 1e3, t_ops)
            beside += f", bound with the rows its slabs read again (+{edge[name]} bytes) {t_edge:.4g} ms"
        if name.endswith("_64"):
            beside += f", launch floor {floor_ms:.4f} ms"
        if name in unlisted:
            print(f"kernel {name} (no path runs it): {ms:.4f} ms{beside}, bound {bound_ms:.4g} ms ({bound_by}; "
                  f"{bound_measured_ms:.4g} ms at the measured ceilings), plain {plain_ms:.4f} ms, max|d| "
                  f"{off_path[name]:.3e} {tag}")
            continue
        if library_ms is not None:
            beside += f", library {library_ms:.4f} ms"
        hand_ms = kernel_ms(torch, hand_calls[name], 50) if name in hand_calls else None
        if hand_ms is not None:
            beside += f", the hand kernel on the same inputs {hand_ms:.4f} ms"
        print(f"kernel {name}: {ms:.4f} ms{beside}, bound {bound_ms:.4g} ms ({bound_by}; {bound_measured_ms:.4g} ms at "
              f"the measured ceilings), plain {plain_ms:.4f} ms, "
              f"{launches[name]} launches on its path {tag}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaced,
            "launches": launches[name], "max_abs_err": report[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_measured_ms": bound_measured_ms,
            "library_ms": library_ms, "hand_ms": hand_ms,
        })

    print(f"seconds: phase v {t_v:.1f}, phase l {t_l:.1f}, phase u {t_u:.1f}, phase w {t_w:.1f}, phase x {t_x:.1f}, phase p {t_p:.1f}, phase q {t_q:.1f}, phase r {t_r:.1f}, phase s {t_s:.1f}, phase t {t_t:.1f}, the "
          f"script from its "
          f"start (the kernels' build included) "
          f"{time.perf_counter() - t_main:.1f} {tag}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
