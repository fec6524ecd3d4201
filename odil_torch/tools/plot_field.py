"""Plots a scalar field from an XDMF2+RAW dump (as written by
``odil_torch.io.write_raw_with_xmf`` or the poisson example's
``--dump_xmf``): the port's counterpart of ``tools/plot_field.py``, with
its flags and its figure.

Usage: python -m odil_torch.tools.plot_field field.xdmf2 [--out field.png] [--cmap viridis] [--slice K]
3D fields are shown as the middle slice along the first axis (or ``--slice``).
"""

import argparse
import os

from odil_torch.io import read_raw_with_xmf


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("xmf", help="Path to .xdmf2 / .xmf metadata file")
    parser.add_argument("--out", default=None, help="Output image (default: <xmf>.png)")
    parser.add_argument("--cmap", default="viridis")
    parser.add_argument("--slice", type=int, default=None, help="Slice index along axis 0 for 3D data")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    u, meta = read_raw_with_xmf(args.xmf)
    u = u.squeeze()
    if u.ndim == 3:
        k = args.slice if args.slice is not None else u.shape[0] // 2
        u = u[k]
    fig, ax = plt.subplots()
    im = ax.imshow(u, origin="lower", cmap=args.cmap)
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title(meta.get("name", ""))
    out = args.out or os.path.splitext(args.xmf)[0] + ".png"
    fig.savefig(out, dpi=200, bbox_inches="tight")
    print(out)
    return out


if __name__ == "__main__":
    main()
