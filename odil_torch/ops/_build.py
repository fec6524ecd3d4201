"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each source under ``odil_torch/csrc/`` compiles on first use, for
``sm_90a``, into ``build/odil_torch/`` at the root of the checkout (listed
in ``.gitignore``); the library name carries a hash of the source and of
the headers it includes (``source_digest``), so an edited source or header
rebuilds.  A source built in variants (``heat_net.cu``, one library per
conductivity net) takes its macros as ``defines`` and names the variant
beside the hash.  Nothing here runs at import time: the CPU tests
import every module and have no nvcc.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

__all__ = ["build_dir", "compile_source", "load", "source_digest"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")


def build_dir():
    return os.path.join(os.path.dirname(_PKG), "build", "odil_torch")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_digest(src):
    """A hash of the source file ``src`` and of every header it includes with
    ``#include "..."`` (resolved beside the including file), recursively."""
    h = hashlib.sha256()
    seen = set()

    def add(path):
        path = os.path.normpath(path)
        if path in seen:
            return
        seen.add(path)
        with open(path, "rb") as fh:
            data = fh.read()
        h.update(os.path.basename(path).encode() + b"\0" + data + b"\0")
        for name in _INCLUDE.findall(data):
            add(os.path.join(os.path.dirname(path), name.decode()))

    add(src)
    return h.hexdigest()[:16]


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def compile_source(name, variant=None, defines=()):
    """Compiles ``csrc/<name>.cu`` to a shared library unless it is already
    built; returns (path, seconds spent, nvcc's ptxas report).  ``variant``
    names a build with the macros ``defines`` ((name, value) pairs) in the
    library's name."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = source_digest(src)
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}_{variant + '_' if variant else ''}{digest}.so")
    log = lib[:-3] + ".log"
    if os.path.exists(lib):
        report = ""
        if os.path.exists(log):
            with open(log) as fh:
                report = fh.read()
        return lib, 0.0, report
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", *[f"-D{k}={v}" for k, v in defines], "-o", tmp, src,
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    with open(log, "w") as fh:
        fh.write(proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds, proc.stderr


@functools.cache
def load(name, variant=None, defines=()):
    """The ctypes handle of ``csrc/<name>.cu`` (its ``variant``), built on
    first use."""
    path, _, _ = compile_source(name, variant, defines)
    return ctypes.CDLL(path)
