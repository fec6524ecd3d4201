"""Fields with values at cell centers, faces and nodes, fitted to a linear
target under multigrid, trained through ``util.optimize_grad``.

The port's counterpart of ``examples/basic/fields.py``: four fields at the
locations ``cc``, ``nn``, ``nc`` and ``cn`` and a neural net in the state
(its weights drawn from a ``torch.Generator`` seeded with ``--seed``; the
operator does not use it).  With ``--plot 1`` the plot epochs draw the
staggered layout (``grid_<frame>``) where matplotlib imports.

    python -m odil_torch.examples.fields --plot 0 --epochs 100 --history_every 10
    python -m odil_torch.examples.fields --plot 0 --epochs 60 --device cpu
"""

import argparse

import numpy as np
import torch

import odil_torch as odil
from odil_torch import printlog

LOCS = (("uc", "cc"), ("un", "nn"), ("ufx", "nc"), ("ufy", "cn"))


def target(x, y):
    return x * 0.25 + y * 0.5


def operator(ctx):
    res = []
    for key, loc in LOCS:
        x, y = ctx.points(loc=loc)
        res += [(key, ctx.field(key) - target(x, y))]
    return res


def parse_args(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--Nx", type=int, default=8, help="Grid size in x")
    parser.add_argument("--Ny", type=int, default=4, help="Grid size in y")
    parser.add_argument("--plot", type=int, default=1, help="Plot fields")
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        outdir="out_fields",
        echo=1,
        frames=1,
        plot_every=100,
        report_every=50,
        history_every=10,
        optimizer="adam",
        lr=1e-2,
        multigrid=1,
    )
    return parser.parse_args(argv)


def plot(problem, state, epoch, frame, cbinfo=None):
    domain = problem.domain
    mod = domain.mod
    plotutil = odil.util.plot_module("plotutil")
    if plotutil is None:
        return
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 2))
    kw = dict(vmin=0, vmax=1, cmap="Greys", clip_on=False, lw=0.5)
    for i, (key, loc) in enumerate(LOCS):
        x, y = map(mod.numpy, domain.points(loc=loc))
        u = mod.numpy(domain.field(state, key))
        ax.scatter(x, y, s=10, c=u, edgecolor=f"C{i}", label=key, **kw)
    ax.legend(loc="lower left", bbox_to_anchor=(0.1, 1), ncol=4, handletextpad=0)
    xn, yn = map(mod.numpy, domain.points(loc="nn"))
    uc = mod.numpy(domain.field(state, "uc"))
    ax.pcolormesh(xn, yn, uc, edgecolor="k", shading="flat", zorder=0, **dict(kw, lw=0.5))
    ax.set_aspect("equal")
    ax.set_axis_off()
    plotutil.savefig(fig, f"grid_{frame:05d}", printf=printlog)
    plt.close(fig)


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    domain = odil.Domain(
        cshape=(args.Nx, args.Ny),
        dimnames=["x", "y"],
        lower=(0, 0),
        upper=(2, 1),
        dtype=dtype,
        multigrid=args.multigrid,
        mg_interp=args.mg_interp,
        mg_nlvl=args.nlvl,
        device=args.device,
    )
    fields = {key: odil.Field(np.zeros(domain.size(loc=loc)), loc=loc) for key, loc in LOCS}
    fields["net"] = domain.make_neural_net([2, 4, 2], torch.Generator().manual_seed(args.seed))
    state = domain.init_state(odil.State(fields=fields))
    return odil.Problem(operator, domain), state


def main(argv=None):
    args = parse_args(argv)
    odil.setup_outdir(args)
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args, plot_func=plot if args.plot else None)
    odil.util.optimize_grad(args, args.optimizer, problem, state, callback)
    return problem, state


if __name__ == "__main__":
    main()
