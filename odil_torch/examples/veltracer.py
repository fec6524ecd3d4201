"""Reconstruct a 2D velocity field (vx, vy) from tracer images at t=0 and
t=1 -- the flagship ODIL case, trained through ``util.optimize``.

The port's counterpart of ``examples/velocity_from_tracer/veltracer.py``:
the same flags and defaults, and the physics of
``odil_torch.models.veltracer``.  ``--kernel pallas_mg`` trains through the
fused multigrid kernel (one CUDA ``_backward_mg`` launch an epoch on the
card), ``--kernel pallas`` through the generic row-wise kernels and
``--kernel xla`` through the plain operator.  The plot epochs draw the
JAX example's two figures (``u_<frame>.png`` with the velocity arrows,
``vx_<frame>.png``) where matplotlib imports.

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


def plot_func(problem, state, epoch, frame, cbinfo=None):
    domain = problem.domain
    extra = problem.extra
    mod = domain.mod
    path0 = f"u_{frame:05d}.png"
    path1 = f"vx_{frame:05d}.png"
    printlog(path0)

    slices_it = np.linspace(0, domain.cshape[0], 5, dtype=int)
    slices_t = mod.numpy(domain.points_1d(0, loc="n"))[slices_it]

    state_u = mod.numpy(domain.field(state, "u"))
    state_vx = mod.numpy(domain.field(state, "vx"))
    state_vy = mod.numpy(domain.field(state, "vy"))
    plot = odil.util.plot_module()
    if plot is None:
        return

    def quiver(i, j, ax, fig):
        import matplotlib.pyplot as plt

        plt.setp(ax.spines.values(), linewidth=0.25)
        ax.yaxis.label.set_size(7)
        xx, yy = (mod.numpy(p) for p in domain.points("x", "y", loc=".cc"))
        skip = domain.cshape[1] // 8
        offset = max(0, skip // 2 - 1)
        x = xx[offset::skip, offset::skip].flatten()
        y = yy[offset::skip, offset::skip].flatten()
        vxs = state_vx[slices_it[j], offset::skip, offset::skip].flatten()
        vys = state_vy[slices_it[j], offset::skip, offset::skip].flatten()
        ax.quiver(x, y, vxs, vys, scale=5, color="k")

    plot.plot_2d(domain, extra.exact_uu, state_u, slices_it, slices_t, path0, cmap="YlOrBr", umin=0, umax=1,
                 callback=quiver, interpolation="bilinear", title=f"epoch={epoch}")
    plot.plot_2d(domain, state_vx, state_vy, slices_it, slices_t, path1, umin=-0.5, umax=0.5, cmap="PuOr_r",
                 interpolation="bilinear", ylabel_exact="vx", ylabel_pred="vy")


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    mesh, partition = odil.util.mesh_from_args(args, ("t", "x", "y"))
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


def main(argv=None):
    args = parse_args(argv)
    args.Nt = args.Nt or args.Nx
    args.Ny = args.Ny or args.Nx
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args, plot_func=plot_func)
    odil.optimize(args, args.optimizer, problem, state, callback)
    return problem, state


if __name__ == "__main__":
    main()
