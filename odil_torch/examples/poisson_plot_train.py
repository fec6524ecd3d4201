"""Error-against-epoch figure of a poisson run, from its ``train.csv``.

The port's counterpart of ``examples/poisson/plot_train.py`` (numpy and
matplotlib only); it reads the ``train.csv`` that the port's poisson CLI
writes.

    python -m odil_torch.examples.poisson_plot_train --data out_poisson/train.csv --out out_poisson/train
"""

import argparse

import matplotlib.pyplot as plt
import numpy as np

from odil_torch import plotutil


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="out_poisson/train.csv")
    parser.add_argument("--out", type=str, default="out_poisson/train")
    parser.add_argument("--column", type=str, default="error_u")
    args = parser.parse_args(argv)

    plotutil.set_extlist(["png"])
    table = np.genfromtxt(args.data, delimiter=",", names=True)
    err = table[args.column]
    fig, ax = plt.subplots(figsize=(1.5, 1.3))
    ax.plot(table["epoch"] + 1, err, label="ODIL", c="C1")
    ax.set_xlabel("epoch")
    ax.set_xscale("log")
    ax.set_ylabel("error")
    ax.set_yscale("log")
    vmin = -3 if np.nanmin(err) < 1e-2 else -2
    ax.set_ylim(10.0**vmin, 10)
    plotutil.set_log_ticks(ax.yaxis)
    plotutil.savefig(fig, args.out)
    plt.close(fig)


if __name__ == "__main__":
    main()
