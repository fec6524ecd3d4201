"""Side-by-side inferred and reference field of a poisson run, from the
``data.pickle`` that ``--dump_data 1`` writes.

The port's counterpart of ``examples/poisson/plot_field.py`` (numpy and
matplotlib only); it reads the pickle that the port's poisson CLI writes.

    python -m odil_torch.examples.poisson_plot_field --data out_poisson/data.pickle --out out_poisson/field
"""

import argparse
import pickle

import matplotlib.pyplot as plt

from odil_torch import plotutil


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="out_poisson/data.pickle")
    parser.add_argument("--out", type=str, default="out_poisson/field")
    parser.add_argument("--vmax", type=float, default=1)
    parser.add_argument("--cmap", type=str, default="PuOr_r")
    args = parser.parse_args(argv)

    plotutil.set_extlist(["png"])
    with open(args.data, "rb") as f:
        data = pickle.load(f)
    fig, axes = plt.subplots(1, 2, figsize=(3, 1.5))
    fig.subplots_adjust(hspace=0.03, wspace=0.03)
    for ax, (u, title) in zip(axes, [(data["u"], "ODIL"), (data["ref_u"], "reference")]):
        ax.spines[:].set_visible(True)
        ax.spines[:].set_linewidth(0.25)
        ax.imshow(u.T, interpolation="bilinear", cmap=args.cmap, vmin=-args.vmax, vmax=args.vmax,
                  extent=[0, 1, 0, 1], origin="lower", aspect="equal")
        ax.set_title(title, y=0.97)
        ax.set_xticks([])
        ax.set_yticks([])
    plotutil.savefig(fig, args.out)
    plt.close(fig)


if __name__ == "__main__":
    main()
