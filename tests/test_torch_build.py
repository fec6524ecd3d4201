"""The build of the port's CUDA sources (odil_torch/ops/_build.py) on the
CPU: the library's name carries a digest of the source and of every header
it includes, so an edited header rebuilds."""

import os
import shutil

from odil_torch.ops import _build


def _copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc"), dst)
    return dst


def test_digest_covers_included_headers(tmp_path):
    csrc = _copy(tmp_path)
    src = str(csrc / "rowwise.cu")
    before = _build.source_digest(src)
    assert before == _build.source_digest(src)
    with open(csrc / "veltracer_row.cuh", "a") as fh:
        fh.write("// edited\n")
    after = _build.source_digest(src)
    assert after != before
    with open(csrc / "unrelated.cuh", "w") as fh:
        fh.write("// not included\n")
    assert _build.source_digest(src) == after
    with open(csrc / "rowwise.cu", "a") as fh:
        fh.write("// edited\n")
    assert _build.source_digest(src) != after


def test_both_sources_include_the_shared_header(tmp_path):
    csrc = _copy(tmp_path)
    digests = {name: _build.source_digest(str(csrc / name)) for name in ("rowwise.cu", "rowwise_mg.cu")}
    with open(csrc / "veltracer_row.cuh", "a") as fh:
        fh.write("// edited\n")
    for name, d in digests.items():
        assert _build.source_digest(str(csrc / name)) != d
