"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each source under ``odil_torch/csrc/`` compiles on first use, for
``sm_90a``, into ``build/odil_torch/`` at the root of the checkout (listed
in ``.gitignore``); the library name carries a hash of the source and of
the headers it includes (``source_digest``), so an edited source or header
rebuilds.  A source built in variants (``heat_net.cu``, one library per
conductivity net) takes its macros as ``defines`` and names the variant
beside the hash.  A generated source (``compile_generated``: a traced row
function's row model, ``ops/rowtrace.py``) is written into the build
directory and compiled with ``csrc/`` on the include path, its library
named by the digest of its text and of the headers it includes.  Nothing
here runs at import time: the CPU tests import every module and have no
nvcc.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["build_dir", "compile_generated", "compile_source", "generated_digest", "load", "load_generated",
           "source_digest"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")


def build_dir():
    return os.path.join(os.path.dirname(_PKG), "build", "odil_torch")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_digest(src, text=None):
    """A hash of the source file ``src`` (or of ``text``, a source whose
    headers lie in ``csrc/``) and of every header it includes with
    ``#include "..."`` (resolved beside the including file), recursively."""
    h = hashlib.sha256()
    seen = set()

    def add(path, data=None):
        path = os.path.normpath(path)
        if path in seen:
            return
        seen.add(path)
        if data is None:
            with open(path, "rb") as fh:
                data = fh.read()
        h.update(os.path.basename(path).encode() + b"\0" + data + b"\0")
        for name in _INCLUDE.findall(data):
            add(os.path.join(os.path.dirname(path), name.decode()))

    add(src, None if text is None else text.encode())
    return h.hexdigest()[:16]


def generated_digest(text):
    """``source_digest`` of a generated source: its text and the headers
    of ``csrc/`` it includes."""
    return source_digest(os.path.join(_CSRC, "<generated>.cu"), text)


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
    lib = os.path.join(build_dir(), f"lib{name}_{variant + '_' if variant else ''}{source_digest(src)}.so")
    return _compile(src, lib, defines)


def compile_generated(name, text):
    """Compiles the generated source ``text`` (its ``#include "..."``
    headers in ``csrc/``) to ``lib<name>_<digest>.so`` unless it is already
    built, the source beside it as ``<name>_<digest>.cu``; returns (path,
    seconds spent, nvcc's ptxas report)."""
    digest = generated_digest(text)
    os.makedirs(build_dir(), exist_ok=True)
    src = os.path.join(build_dir(), f"{name}_{digest}.cu")
    if not os.path.exists(src):
        tmp = f"{src}.{_tag()}.tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, src)
    return _compile(src, os.path.join(build_dir(), f"lib{name}_{digest}.so"), include=_CSRC)


def _tag():
    """The process and thread of a build's temporary files: builds of one
    source may run at once, in processes or in one process's threads."""
    return f"{os.getpid()}.{threading.get_ident()}"


def _compile(src, lib, defines=(), include=None):
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    log = lib[:-3] + ".log"
    if os.path.exists(lib):
        report = ""
        if os.path.exists(log):
            with open(log) as fh:
                report = fh.read()
        return lib, 0.0, report
    tmp = f"{lib}.{_tag()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", *[f"-D{k}={v}" for k, v in defines],
        *([f"-I{include}"] if include else []), "-o", tmp, src,
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


@functools.lru_cache(maxsize=None)
def load_generated(name, text):
    """The ctypes handle of a generated source (``compile_generated``),
    built on first use."""
    path, _, _ = compile_generated(name, text)
    return ctypes.CDLL(path)
