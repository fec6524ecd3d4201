"""Matplotlib session setup and figure-export helpers.

The port's counterpart of ``odil_tpu/plotutil.py`` (numpy and matplotlib
only): the Agg backend unless ``ODIL_AGG=0``, the house stylesheet
(``odil.mplstyle``, unless ``ODIL_STYLE=0``), multi-format export with the
timestamps stripped so that reruns write the same bytes (``ODIL_EXTLIST``,
default ``png``), and the legend, clip-box and log-tick helpers.  Importing
it imports matplotlib.
"""

import logging
import os
import pathlib

import matplotlib
import numpy as np


def _env_flag(name, default=True):
    raw = os.environ.get(name)
    return default if raw is None else bool(int(raw))


if _env_flag("ODIL_AGG"):
    matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402  (the backend is chosen first)

logging.getLogger("matplotlib.font_manager").setLevel(logging.ERROR)

_STYLE_SHEET = pathlib.Path(__file__).with_name("odil.mplstyle")
if _env_flag("ODIL_STYLE") and _STYLE_SHEET.is_file():
    matplotlib.style.use(str(_STYLE_SHEET))

# Formats written by savefig() when the caller passes no extlist.
_default_formats = []

# Per-format metadata that strips timestamps (identical figures, identical files).
_TIMESTAMP_FIELDS = {
    "svg": {"Date": None},
    "pdf": {"DateModified": None, "CreationDate": None},
}


def set_extlist(extlist=None):
    """Sets the default save formats; ``None`` re-reads ``ODIL_EXTLIST``."""
    if extlist is None:
        extlist = os.environ.get("ODIL_EXTLIST", "png").split(",")
    _default_formats[:] = list(extlist)


set_extlist()


def savefig(fig, path_without_ext, extlist=None, skip_existing=False, printf=None, **kwargs):
    """Writes ``fig`` as ``<path_without_ext>.<ext>`` for every format.

    ``printf``, if given, is called with each path written; with
    ``skip_existing`` files already present are left as they are."""
    say = printf if printf is not None else (lambda msg: None)
    formats = _default_formats if extlist is None else extlist
    for fmt in formats:
        target = f"{path_without_ext}.{fmt}"
        if skip_existing and os.path.isfile(target):
            say(f"skip existing '{target}'")
            continue
        say(target)
        fig.savefig(target, metadata=dict(_TIMESTAMP_FIELDS.get(fmt, {})), **kwargs)


def savelegend(fig, ax, path, **kwargs):
    """Renders the legend of ``ax`` alone, cropped to its own extent."""
    handles, labels = ax.get_legend_handles_labels()
    holder = plt.figure()
    legend = holder.legend(handles, labels, loc="center", frameon=False)
    holder.canvas.draw()
    extent = legend.get_window_extent()
    savefig(holder, path, bbox_inches=extent.transformed(fig.dpi_scale_trans.inverted()), **kwargs)
    plt.close(holder)


def apply_clip_box(ax, artists, lower=(0, 0), upper=(1, 1.02)):
    """Clips ``artists`` to an axes-fraction rectangle (by default the axes
    and 2% above the top spine, so markers on the upper edge keep their
    full height)."""
    corners = matplotlib.transforms.Bbox([list(lower), list(upper)])
    clip = matplotlib.transforms.TransformedBbox(corners, ax.transAxes)
    for artist in artists:
        artist.set_clip_box(clip)


def set_log_ticks(axis):
    """Dense unlabeled minor ticks on a log-scale axis."""
    minor = matplotlib.ticker.LogLocator(base=10.0, subs=np.linspace(0.1, 0.9, 9), numticks=12)
    axis.set_minor_locator(minor)
    axis.set_minor_formatter(matplotlib.ticker.NullFormatter())
