"""Inverse heat conduction: infer the conductivity k(u) as a neural network
from sparse noisy temperature measurements; also the forward problem and
the PINN solver for comparison.  Trained through ``util.optimize``.

The port's counterpart of ``examples/heat/heat.py``: the same flags and
defaults, the physics of ``odil_torch.models.heat``, the ``error_u`` and
``error_k`` columns of the history, the ``imposed.csv`` and ``done``
files, ``--checkpoint``/``--checkpoint_train`` resume and ``--ref_path``
(a reference temperature from a pickle checkpoint, spline-interpolated to
this grid).  ``--solver odil`` takes ``--kernel xla`` (the plain operator)
or ``--kernel pallas`` (the heat row kernel on the card); ``--solver pinn``
trains a temperature net at collocation points drawn from numpy's global
RNG, which ``setup_outdir`` seeds as the JAX example's does, so the two
draw the same points.  The nets' initial weights come from
``torch.Generator``s seeded with ``--seed`` (the conductivity net) and
``--seed`` + 1 (the temperature net), not the JAX package's draws; a JAX
state is carried across with ``--checkpoint``.  The plot epochs write the
JAX example's ``data_<frame>.pickle`` (``--dump_data``) and, where
matplotlib imports, its ``u_`` and ``k_`` figures.  ``--mesh t:4 --halo 1``
evaluates the ODIL loss per shard on an in-process mesh of the
``--device`` (the t axis only: the row model reads its walls from the
plane's index); ``--mesh`` without ``--halo`` (any partition, x included)
takes the GSPMD route, the unsharded evaluation on the card.

    python -m odil_torch.examples.heat --Nt 64 --Nx 64 --infer_k 1 --imposed stripe --epochs 1500 \\
        --history_every 100 --kernel pallas
    python -m odil_torch.examples.heat --Nt 16 --Nx 16 --infer_k 1 --imposed random --nimp 20 --epochs 40 \\
        --device cpu
"""

import argparse
import os
import pickle

import numpy as np
import torch

import odil_torch as odil
from odil_torch import printlog
from odil_torch.checkpoint import checkpoint_load
from odil_torch.models import heat as model
from odil_torch.stencil import struct_to_numpy


def parse_args(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add = parser.add_argument
    add("--kernel", type=str, default="xla", choices=["xla", "pallas"],
        help="Residual evaluation path: the plain operator or the heat row kernel")
    add("--Nt", type=int, default=64, help="Grid size in t")
    add("--Nx", type=int, default=64, help="Grid size in x")
    add("--Nci", type=int, default=4096, help="Collocation points inside domain (PINN)")
    add("--Ncb", type=int, default=128, help="Collocation points per boundary (PINN)")
    add("--arch_u", type=int, nargs="*", default=[10, 10], help="u-network architecture (PINN)")
    add("--arch_k", type=int, nargs="*", default=[5, 5], help="k-network architecture")
    add("--solver", type=str, choices=("pinn", "odil"), default="odil")
    add("--infer_k", type=int, default=0, help="Infer conductivity")
    add("--kxreg", type=float, default=0, help="Space regularization weight")
    add("--kxregdecay", type=float, default=0, help="Decay period of kxreg")
    add("--ktreg", type=float, default=0, help="Time regularization weight")
    add("--ktregdecay", type=float, default=0, help="Decay period of ktreg")
    add("--kwreg", type=float, default=0, help="Network-weight regularization")
    add("--kwregdecay", type=float, default=0, help="Decay period of kwreg")
    add("--kimp", type=float, default=2, help="Weight of imposed points")
    add("--keep_frozen", type=int, default=1, help="Respect frozen attribute for fields")
    add("--keep_init", type=int, default=1, help="Impose initial conditions")
    add("--ref_path", type=str, help="Path to reference solution *.pickle")
    add("--imposed", type=str, choices=["random", "stripe", "none"], default="none")
    add("--nimp", type=int, default=200, help="Number of imposed points")
    add("--noise", type=float, default=0, help="Noise magnitude on measurements")
    add("--kmax", type=float, default=0.1, help="Maximum conductivity")
    odil.util.add_arguments(parser)
    odil.linsolver.add_arguments(parser)
    parser.set_defaults(
        outdir="out_heat",
        linsolver="direct",
        optimizer="adam",
        lr=0.001,
        double=0,
        multigrid=1,
        plotext="png",
        plot_title=1,
        plot_every=2000,
        report_every=500,
        history_full=10,
        history_every=100,
        frames=10,
    )
    return parser.parse_args(argv)


def state_temperature(domain, state, args):
    if args.solver == "odil":
        return domain.mod.numpy(domain.field(state, "u"))
    return domain.mod.numpy(model.eval_u_net(domain, state))


def plot_func(problem, state, epoch, frame, cbinfo=None):
    domain = problem.domain
    extra = problem.extra
    mod = domain.mod
    args = extra.args
    path0 = f"u_{frame:05d}.{args.plotext}"
    path1 = f"k_{frame:05d}.{args.plotext}"
    printlog(path0, path1)

    state_u = state_temperature(domain, state, args)
    ref_uk = extra.ref_uk
    ref_k = model.true_conductivity(ref_uk)
    k = None
    if args.infer_k:
        k = mod.numpy(model.squash_k(domain.neural_net(state, "k_net")(domain.cast(ref_uk))[0], mod, args.kmax))

    plot = odil.util.plot_module()
    if plot is not None:
        import matplotlib.pyplot as plt

        def scatter_imposed(i, fig, ax, data, extent):
            if i == 0 and len(extra.imp_points):
                imp_t, imp_x = extra.imp_points.T
                ax.scatter(imp_x, imp_t, s=0.5, alpha=1, edgecolor="none", facecolor="k", zorder=100)

        plot.plot_1d(domain, mod.numpy(extra.imp_u), state_u, path=path0,
                     title=f"u epoch={epoch}" if args.plot_title else None, cmap="YlOrBr", nslices=5,
                     interpolation="bilinear", callback=scatter_imposed, transpose=True, umin=0, umax=1)

        fig, ax = plt.subplots(figsize=(1.7, 1.5))
        if k is not None:
            ax.plot(ref_uk, k, zorder=10)
        ax.plot(ref_uk, ref_k, c="C2", lw=1.5, zorder=1)
        ax.set_xlabel("u")
        ax.set_ylabel("k")
        ax.set_ylim(0, 0.03)
        if args.plot_title:
            ax.set_title(f"k epoch={epoch}")
        fig.savefig(path1, bbox_inches="tight")
        plt.close(fig)

    if args.dump_data:
        payload = struct_to_numpy(
            mod,
            dict(state_u=state_u, ref_u=extra.ref_u, imp_u=extra.imp_u, ref_uk=ref_uk, k=k, ref_k=ref_k,
                 imp_indices=extra.imp_indices, imp_points=extra.imp_points),
        )
        with open(f"data_{frame:05d}.pickle", "wb") as f:
            pickle.dump(payload, f)


def compute_error(domain, extra, state, key):
    args = extra.args
    if key == "u":
        du = state_temperature(domain, state, args) - domain.mod.numpy(extra.ref_u)
        return float(np.sqrt(np.mean(du**2)))
    if key == "k" and args.infer_k:
        k = model.squash_k(domain.neural_net(state, "k_net")(domain.cast(extra.ref_uk))[0], domain.mod, args.kmax)
        dk = domain.mod.numpy(k) - extra.ref_k
        return float(np.sqrt(np.mean(dk**2)) / extra.ref_k.max())
    return None


def history_func(problem, state, epoch, history, cbinfo):
    for key in ["u", "k"]:
        err = compute_error(problem.domain, problem.extra, state, key)
        if err is not None:
            history.append("error_" + key, err)


def report_func(problem, state, epoch, cbinfo):
    errs = {}
    for key in ["u", "k"]:
        err = compute_error(problem.domain, problem.extra, state, key)
        if err is not None:
            errs[key] = err
    printlog("error: " + ", ".join(f"{k}:{v:.5g}" for k, v in errs.items()))


def load_fields_interp(path, keys, domain):
    """The fields `keys` of a pickle checkpoint (numpy), spline-interpolated
    from their own grid of cells over the domain's bounds to the domain's
    cell centers where the sizes differ: {key: numpy array}."""
    from scipy.interpolate import RectBivariateSpline

    with open(path, "rb") as f:
        data = pickle.load(f)["fields"]
    x1, y1 = (p.cpu().numpy() for p in domain.points_1d())
    out = {}
    for key in keys:
        arrays = data[key]
        src = np.asarray(arrays[0] if isinstance(arrays, list) else arrays).astype(domain.dtype)
        if tuple(src.shape) != tuple(domain.cshape):
            src_domain = odil.Domain(cshape=src.shape, dimnames=("x", "y"), lower=domain.lower, upper=domain.upper,
                                     dtype=domain.dtype, device="cpu")
            sx, sy = (p.numpy() for p in src_domain.points_1d())
            src = RectBivariateSpline(sx, sy, src)(x1, y1)
        out[key] = src
    return out


def make_problem(args):
    dtype = np.float64 if args.double else np.float32
    ref_u = None
    if args.ref_path is not None:
        printlog(f"Loading reference solution from '{args.ref_path}'")
        grid = odil.Domain(cshape=(args.Nt, args.Nx), dimnames=("t", "x"), dtype=dtype, device=args.device)
        ref_u = load_fields_interp(args.ref_path, ["u"], grid)["u"]
    mesh, partition = odil.util.mesh_from_args(args, ("t", "x"))
    problem, state, extra = model.build(
        nt=args.Nt, nx=args.Nx, arch_k=args.arch_k, dtype=dtype, multigrid=args.multigrid, kernel=args.kernel,
        device=args.device, ref_u=ref_u, mesh=mesh, partition=partition, args=args,
    )
    domain = problem.domain
    if domain.multigrid:
        printlog("multigrid levels:", domain.mg_cshapes)
    with open("imposed.csv", "w") as f:
        f.write(",".join(domain.dimnames) + "\n")
        for p in extra.imp_points:
            f.write("{:},{:}\n".format(*p))

    if args.solver == "pinn":
        net = domain.make_neural_net([2] + args.arch_u + [1], torch.Generator().manual_seed(args.seed + 1))
        fields = {"u_net": net}
        if args.infer_k:
            fields["k_net"] = state.fields["k_net"]
        state = domain.init_state(odil.State(fields=fields))
        inner, init, bound = model.pinn_collocation(domain, args, extra)
        printlog("Number of collocation points:")
        printlog(f"inner: {inner}")
        printlog(f"init: {init}")
        printlog(f"bound: {bound}")
        problem = odil.Problem(model.operator_pinn, domain, extra)

    if args.checkpoint is not None:
        printlog(f"Loading checkpoint '{args.checkpoint}'")
        optstate = checkpoint_load(domain, state, args.checkpoint)
        if optstate is not None:
            problem.resume_opt_state = optstate
        tpath = os.path.splitext(args.checkpoint)[0] + "_train.pickle"
        if args.checkpoint_train is None:
            assert os.path.isfile(tpath), f"File not found '{tpath}'"
            args.checkpoint_train = tpath

    if args.checkpoint_train:
        printlog(f"Loading history from '{args.checkpoint_train}'")
        hist = odil.History()
        hist.load(args.checkpoint_train)
        args.epoch_start = int(hist.get("epoch", [args.epoch_start])[-1])
        args.frame_start = int(hist.get("frame", [args.frame_start])[-1])
        printlog(f"Starting from epoch={args.epoch_start} frame={args.frame_start}")
    return problem, state


def main(argv=None):
    args = parse_args(argv)
    odil.setup_outdir(args, relpath_args=["checkpoint", "checkpoint_train", "ref_path"])
    problem, state = make_problem(args)
    callback = odil.make_callback(problem, args, plot_func=plot_func, history_func=history_func,
                                  report_func=report_func)
    odil.util.optimize(args, args.optimizer, problem, state, callback)
    with open("done", "w"):
        pass
    return problem, state


if __name__ == "__main__":
    main()
