"""Reconstruct a 2D velocity field (vx, vy) from tracer images at t=0 and
t=1 -- the flagship ODIL case, trained through ``util.optimize``.

The port's counterpart of ``examples/velocity_from_tracer/veltracer.py``:
the same flags and defaults, and the physics of
``odil_torch.models.veltracer``.  ``--kernel pallas_mg`` trains through the
fused multigrid kernel (one CUDA ``_backward_mg`` launch an epoch on the
card), ``--kernel pallas`` through the generic row-wise kernels and
``--kernel xla`` through the plain operator.  Plots are not written yet
(``plot.py`` is not ported); the ``frame`` column still advances.

    python -m odil_torch.examples.veltracer --Nt 64 --Nx 256 --Ny 256 --kernel pallas_mg \\
        --epochs 400 --history_every 10 --plot_every 0
    python -m odil_torch.examples.veltracer --Nx 16 --kernel xla --epochs 30 --device cpu
"""

import argparse

import numpy as np

import odil_torch as odil
from odil_torch import printlog
from odil_torch.models import veltracer as model


def parse_args(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--kernel", type=str, default="xla", choices=["xla", "pallas", "pallas_mg"],
                        help="Residual evaluation path: the plain operator, the row-wise kernels or the fused "
                        "multigrid kernel")
    parser.add_argument("--Nt", type=int, default=None, help="Grid size in t")
    parser.add_argument("--Nx", type=int, default=64, help="Grid size in x")
    parser.add_argument("--Ny", type=int, default=None, help="Grid size in y")
    parser.add_argument("--kxreg", type=float, default=0.01, help="Laplacian regularization weight")
    parser.add_argument("--ktreg", type=float, default=1, help="Time regularization weight")
    parser.add_argument("--kimp", type=float, default=10, help="Imposed values weight")
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        outdir="out_veltracer",
        frames=5,
        plot_every=100,
        report_every=100,
        history_every=10,
        optimizer="adam",
        lr=0.01,
        multigrid=1,
        mg_interp="conv",
        linsolver="multigrid",
        linsolver_maxiter=10,
    )
    return parser.parse_args(argv)


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    mesh = partition = None
    if getattr(args, "mesh", None):
        mesh = odil.parallel.mesh_from_spec(args.mesh, devices=_mesh_devices(args))
        partition = odil.parallel.auto_partition(("t", "x", "y"), mesh)
        printlog(f"mesh: {dict(mesh.shape)}, partition: {partition}")
    problem, state, extra = model.build(
        nt=args.Nt,
        nx=args.Nx,
        ny=args.Ny,
        dtype=dtype,
        multigrid=args.multigrid,
        mg_interp=args.mg_interp,
        mg_nlvl=args.nlvl,
        kernel=args.kernel,
        device=args.device,
        mesh=mesh,
        partition=partition,
        args=args,
    )
    if problem.domain.multigrid:
        printlog("multigrid levels:", problem.domain.mg_cshapes)
    return problem, state


def _mesh_devices(args):
    """The shards' devices: every shard on the one device of ``--device``
    (the port's mesh is in-process; several cards are not ported)."""
    import math

    import torch

    sizes = [int(p.partition(":")[2] or 1) for p in args.mesh.split(",")]
    return [torch.device(args.device)] * max(1, math.prod(s for s in sizes if s > 0))


def main(argv=None):
    args = parse_args(argv)
    args.Nt = args.Nt or args.Nx
    args.Ny = args.Ny or args.Nx
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args)
    odil.optimize(args, args.optimizer, problem, state, callback)
    return problem, state


if __name__ == "__main__":
    main()
