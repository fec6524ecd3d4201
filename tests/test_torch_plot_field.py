"""``python -m odil_torch.tools.plot_field`` against the JAX package's
``tools/plot_field.py``: on a 2-D and a 3-D field written by
``odil_torch.io.write_raw_with_xmf`` (numpy draws from a seed), both tools
run in their own interpreters under Agg and draw the same pixels
(``matplotlib.image.imread``)."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape,flags", [((12, 16), []), ((6, 10, 8), ["--cmap", "magma"]),
                                         ((6, 10, 8), ["--slice", "1"])], ids=["2d", "3d", "3d_slice"])
def test_plot_field_draws_the_jax_tools_pixels(tmp_path, shape, flags):
    pytest.importorskip("matplotlib")
    import matplotlib.image

    from odil_torch.io import write_raw_with_xmf

    u = np.random.default_rng(len(shape)).normal(size=shape)
    xmf = str(tmp_path / "u.xdmf2")
    write_raw_with_xmf(u, xmf, spacing=(0.5,) * len(shape), name="u")
    env = dict(os.environ, MPLBACKEND="Agg")
    outs = {}
    for who, cmd in (("jax", [sys.executable, os.path.join(ROOT, "tools", "plot_field.py")]),
                     ("torch", [sys.executable, "-m", "odil_torch.tools.plot_field"])):
        out = str(tmp_path / f"{who}.png")
        proc = subprocess.run(cmd + [xmf, "--out", out] + flags, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().splitlines()[-1] == out
        outs[who] = matplotlib.image.imread(out)
    assert outs["torch"].shape == outs["jax"].shape
    assert np.array_equal(outs["torch"], outs["jax"])
