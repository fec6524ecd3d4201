"""Comparison figures: the port's counterpart of ``odil_tpu/plot.py``.

- ``plot_1d(domain, u_ref, u_state, ...)``: side-by-side inferred and
  reference heatmaps of a 2-D space-time field, and a stack of slices of
  both with a legend;
- ``plot_2d(domain, exact_uu, pred_uu, slices_it, slices_t, path, ...)``: a
  2 x N grid of time slices of 3-D (t, x, y) fields.

The same figures as the JAX package's, pixel for pixel: the reference's four
colormaps (``_cmapdata.py``), other names from matplotlib, unknown ones
viridis.  The fields may be torch tensors (on the card or the host) or
numpy arrays: a tensor is moved to the host with one ``.cpu()`` call, and
the domain may be the port's ``Domain`` or ``core_min.Domain``.  Importing
the module imports matplotlib.
"""

import matplotlib
import matplotlib.pyplot as plt
import numpy as np

from ._cmapdata import CMAP_NODES

__all__ = ["plot_1d", "plot_2d", "get_cmap", "g_colormap_names"]

g_colormap_names = list(CMAP_NODES)


def _host(a):
    """A numpy array of ``a`` (a torch tensor goes to the host once)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def get_cmap(name):
    """The colormap of one of the bundled node tables: piecewise linear
    through its nodes."""
    rows = CMAP_NODES[name]
    nodes = [r[0] for r in rows]
    colors = [r[1:] for r in rows]
    return matplotlib.colors.LinearSegmentedColormap.from_list(name, list(zip(nodes, colors)))


def _resolve_cmap(cmap):
    if cmap is None:
        return "viridis"
    if isinstance(cmap, str) and cmap in CMAP_NODES:
        return get_cmap(cmap)
    try:
        plt.get_cmap(cmap)
        return cmap
    except ValueError:
        return "viridis"


def plot_1d(
    domain,
    u_ref,
    u_state,
    path=None,
    title=None,
    umin=None,
    umax=None,
    slice_lim=0.1,
    transpose=False,
    invertx=False,
    nslices=6,
    dpi=300,
    transparent=True,
    figsize=(3, 2.5),
    aspect="auto",
    callback=None,
    interpolation="nearest",
    cmap=None,
    cref="C2",
    cstate="C0",
):
    """Two heatmaps (inferred | reference) and `nslices` slice overlays; saved
    to `path` (and closed), or returned when `path` is None."""
    u_ref = _host(u_ref)
    u_state = _host(u_state)
    if transpose:
        ix, iy = 1, 0
        u_ref, u_state = u_ref.T, u_state.T
    else:
        ix, iy = 0, 1
    cmap = _resolve_cmap(cmap)
    extent = [domain.lower[ix], domain.upper[ix], domain.lower[iy], domain.upper[iy]]
    xx = _host(domain.points_1d(ix))
    umin = u_ref.min() if umin is None else umin
    umax = u_ref.max() if umax is None else umax
    ptp = umax - umin
    slim = (umin - ptp * slice_lim, umax + ptp * slice_lim)

    fig = plt.figure(figsize=figsize)
    fig.subplots_adjust(hspace=0, wspace=0)
    spec = fig.add_gridspec(2 * nslices, 3)
    if title is not None:
        fig.suptitle(title, fontsize=8)

    for i, data in enumerate((u_state, u_ref)):
        ax = fig.add_subplot(spec[1:-1, i])
        ax.spines[:].set_visible(True)
        ax.spines[:].set_linewidth(0.25)
        ax.imshow(data.T, interpolation=interpolation, cmap=cmap, vmin=umin, vmax=umax, extent=extent,
                  origin="lower", aspect=aspect)
        if callback is not None:
            callback(i, fig, ax, data, extent)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_xlim(extent[:2])
        ax.set_ylim(extent[2:])
        if invertx:
            ax.invert_xaxis()

    spec2 = fig.add_gridspec(2 * nslices, 3, left=0.22)
    l0 = l1 = None
    for i in range(nslices):
        yslice = i * (domain.cshape[iy] - 1) // max(1, nslices - 1)
        row = nslices - 1 - i
        ax = fig.add_subplot(spec2[2 * row : 2 * row + 2, 2])
        ax.spines[:].set_visible(True)
        ax.spines[:].set_linewidth(0.25)
        (l0,) = ax.plot(xx, u_ref[:, yslice], c=cref, ls="-", label="reference", linewidth=0.9)
        (l1,) = ax.plot(xx, u_state[:, yslice], c=cstate, ls="-", label="inferred", linewidth=0.6)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_xlim(extent[:2])
        ax.set_ylim(slim)
        if invertx:
            ax.invert_xaxis()
    if l0 is not None:
        ax.legend(handles=[l1, l0], loc=(-2.37, 0.5), columnspacing=2.2, ncol=2, frameon=False, handletextpad=0.5,
                  fontsize=7)

    if path is not None:
        fig.savefig(path, dpi=dpi, pad_inches=0.01, transparent=transparent)
        plt.close(fig)
        return None
    return fig


def plot_2d(
    domain,
    exact_uu,
    pred_uu,
    slices_it,
    slices_t,
    path,
    title=None,
    umin=None,
    umax=None,
    dpi=300,
    figsizey=3.0,
    hspace=0.05,
    cmap=None,
    callback=None,
    xlabel="{:.2f}",
    ylabel_exact="reference",
    ylabel_pred="inferred",
    transparent=False,
    interpolation="nearest",
):
    """A 2 x N grid of (x, y) slices of 3-D (t, x, y) fields at the indices
    `slices_it`, saved to `path`."""
    cmap = _resolve_cmap(cmap)
    exact_uu, pred_uu = _host(exact_uu), _host(pred_uu)
    nslices = len(slices_it)
    fig = plt.figure(figsize=(figsizey * nslices * 0.5, figsizey))
    fig.subplots_adjust(hspace=hspace, wspace=hspace)
    spec = fig.add_gridspec(2, nslices)
    extent = [domain.lower[1], domain.upper[1], domain.lower[2], domain.upper[2]]
    if title:
        fig.suptitle(title)
    for islice in range(nslices):
        it = min(int(slices_it[islice]), exact_uu.shape[0] - 1)
        for i, source in enumerate((exact_uu, pred_uu)):
            data = source[it]
            ax = fig.add_subplot(spec[i, islice])
            ax.spines[:].set_visible(True)
            ax.spines[:].set_linewidth(0.25)
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_xlim(extent[:2])
            ax.set_ylim(extent[2:4])
            ax.imshow(data.T, interpolation=interpolation, cmap=cmap, vmin=umin, vmax=umax, extent=extent,
                      origin="lower", aspect="equal")
            if i == 1 and xlabel:
                ax.set_xlabel(xlabel.format(slices_t[islice]))
            if islice == 0 and i == 0 and ylabel_exact:
                ax.set_ylabel(ylabel_exact)
            if islice == 0 and i == 1 and ylabel_pred:
                ax.set_ylabel(ylabel_pred)
            if callback:
                callback(i, islice, ax, fig)

    fig.savefig(path, dpi=dpi, bbox_inches="tight", pad_inches=0.01, transparent=transparent)
    plt.close(fig)
