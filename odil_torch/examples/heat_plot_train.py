"""Error-against-epoch figure of a heat run: error_u and, where the run
inferred the conductivity, error_k, from its ``train.csv``.

The port's counterpart of ``examples/heat/plot_train.py`` (numpy and
matplotlib only); it reads the ``train.csv`` that the port's heat CLI
writes.

    python -m odil_torch.examples.heat_plot_train --data out_heat/train.csv --out out_heat/train
"""

import argparse

import matplotlib.pyplot as plt
import numpy as np

from odil_torch import plotutil


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="out_heat/train.csv")
    parser.add_argument("--out", type=str, default="out_heat/train")
    args = parser.parse_args(argv)

    plotutil.set_extlist(["png"])
    table = np.genfromtxt(args.data, delimiter=",", names=True)
    fig, ax = plt.subplots(figsize=(1.7, 1.4))
    ax.plot(table["epoch"] + 1, table["error_u"], label="$u$", c="C0")
    if "error_k" in (table.dtype.names or ()):
        ax.plot(table["epoch"] + 1, table["error_k"], label="$k$", c="C1")
    ax.set_xlabel("epoch")
    ax.set_xscale("log")
    ax.set_ylabel("error")
    ax.set_yscale("log")
    plotutil.set_log_ticks(ax.yaxis)
    ax.legend(frameon=False, fontsize=7)
    plotutil.savefig(fig, args.out)
    plt.close(fig)


if __name__ == "__main__":
    main()
