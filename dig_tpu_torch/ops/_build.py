"""Build the package's CUDA sources with ``nvcc`` on first use.

Each ``csrc/<name>.cu`` is compiled for ``sm_90a`` into a shared library
with a plain C interface and loaded with ctypes. Libraries go to
``dig_tpu_torch/_build/`` (ignored by git), named by the hash of the
source and of the shared headers (``csrc/*.cuh``), so an edited source is
rebuilt and a built one is reused. A source may include headers generated
from the package's own code (``gen = (variant, {file name: text})``, e.g.
the basis rows of ``ops/basis.py`` ``basis_row_code``): they are written
beside the library, put on the include path and keyed into its hash, one
library per variant. The ``-Xptxas -v`` report is kept
beside each library (``build_report``). ``check``, ``ptr`` and ``stream``
are the ctypes helpers the ops share for calling a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels are built on the machine with the card")
    return str(path)


def _paths(name: str, gen=None):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = name
    if gen is not None:
        variant, files = gen
        tag = f"{name}-{variant}"
        for fname, text in sorted(files.items()):
            h.update(fname.encode())
            h.update(text.encode())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"{tag}-{digest}.so"
    return src, lib, lib.with_suffix(".log")


def build(name: str, gen=None) -> Path:
    """Compile ``csrc/<name>.cu`` (with the generated headers of ``gen``)
    unless a library of this source exists."""
    src, lib, log = _paths(name, gen)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    if gen is not None:
        inc = lib.with_suffix(".gen")
        inc.mkdir(exist_ok=True)
        for fname, text in gen[1].items():
            (inc / fname).write_text(text)
        cmd += ["-I", str(inc)]
    cmd += ["-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)    # atomic: a concurrent build never sees half a file
    return lib


def build_report(name: str, gen=None) -> str:
    """The ``-Xptxas -v`` output of the build of ``csrc/<name>.cu``."""
    build(name, gen)
    _, _, log = _paths(name, gen)
    return log.read_text() if log.exists() else ""


def load(name: str, gen=None) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process
    and variant."""
    key = name if gen is None else (name, gen[0])
    if key not in _LOADED:
        _LOADED[key] = ctypes.CDLL(str(build(name, gen)))
    return _LOADED[key]


# return codes of the libraries besides a cudaError_t (csrc/common.cuh)
ERR_SHAPE, ERR_SMEM = -2, -3


def check(rc: int, what: str, shape_msg: str) -> None:
    """Raise unless a library call returned 0; ``shape_msg`` says which
    widths the kernel was compiled for."""
    if rc == 0:
        return
    reason = {ERR_SHAPE: shape_msg,
              ERR_SMEM: "too large for shared memory"}.get(rc,
                                                          f"CUDA error {rc}")
    raise RuntimeError(f"{what}: {reason}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (null for None)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(dev) -> ctypes.c_void_p:
    """The current CUDA stream of ``dev``."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
