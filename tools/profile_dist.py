#!/usr/bin/env python3
"""Where an epoch of the halo route over several processes goes: four
processes share the card over gloo, one shard of t:2,x:2 each, and train
the flagship (64x256x256, ``chip_smoke.dist_build``) through the generic
and the MG-fused halo routes; each process times the collectives' rounds
of ``odil_torch/comm.py`` (host time, the staging copies and the waits for
the card and the peers included), counts the bytes it sends, and times the
psum's all_gather apart.  Run from the root of a tree on the card's
machine (it builds the kernels first, as ``chip_smoke.py`` does):

    python3 tools/profile_dist.py [EPOCHS]

Each process prints one line a route: its ms/epoch over EPOCHS (default 50)
epochs after 10 of warm-up, and per epoch the rounds, their ms, the MB it
sent and the psum's ms.  The script starts the processes itself and waits
for them (a timeout, then they are killed).
"""

import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

PROCESSES, TIMEOUT = 4, 600


def worker(rank, world, port, epochs):
    import numpy as np
    import torch
    import torch.distributed as dist

    from odil_torch import comm, parallel
    from odil_torch.optim import Adam

    parallel.init_distributed(f"localhost:{port}", world, rank, backend="gloo", timeout=TIMEOUT)
    stats = dict(rounds=0, s=0.0, bytes=0, psum_s=0.0)
    exchange, psum = comm._exchange, comm.psum_table

    def timed_exchange(sends, recvs):
        t = time.perf_counter()
        out = exchange(sends, recvs)
        stats["rounds"] += 1
        stats["s"] += time.perf_counter() - t
        stats["bytes"] += sum(x.numel() * x.element_size() for _, _, x in sends)
        return out

    def timed_psum(*args):
        t = time.perf_counter()
        out = psum(*args)
        stats["psum_s"] += time.perf_counter() - t
        return out

    comm._exchange, comm.psum_table = timed_exchange, timed_psum
    dev = parallel.local_device()
    with open(chip_smoke.HEAT_DATA) as fh:
        heat_ref = json.load(fh)
    for fuse in ("generic", "mg"):
        mesh = parallel.mesh_from_spec(chip_smoke.HALO_SPEC)
        problem, state, _ = chip_smoke.dist_build(torch, np, "flagship", mesh, dev, heat_ref)
        grad_fn = problem.make_loss_grad_fn(state, halo=True, halo_fuse=fuse)
        x0 = parallel.shard_state_arrays(problem.domain, problem.domain.arrays_from_state(state))
        opt = Adam(grad_fn, x0, lr=0.01)
        opt.run_chunk(10)
        torch.cuda.synchronize()
        stats.update(rounds=0, s=0.0, bytes=0, psum_s=0.0)
        t = time.perf_counter()
        opt.run_chunk(epochs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / epochs * 1e3
        print(f"process {rank} {fuse}: {ms:.4f} ms/epoch; an epoch: {stats['rounds'] / epochs:.1f} exchange rounds "
              f"{stats['s'] / epochs * 1e3:.3f} ms, {stats['bytes'] / epochs / 1e6:.3f} MB sent, psum "
              f"{stats['psum_s'] / epochs * 1e3:.3f} ms", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main():
    from odil_torch.ops import _build

    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    chip_smoke.build_all(_build)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(PROCESSES), str(port), str(epochs)])
             for r in range(PROCESSES)]
    try:
        codes = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"card: {chip_smoke.card_line()}")
    if any(codes):
        sys.exit(f"a process exited {codes}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]))
    else:
        main()
