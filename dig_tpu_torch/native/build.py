"""Build the native library from ``partition.cpp`` with ``g++``.

The library goes to ``dig_tpu_torch/_build/`` (ignored by git), named by
the hash of the source, so an edited source is rebuilt and a built one is
reused. ``dig_tpu_torch.native`` builds it at first use; to build it ahead:

    python -m dig_tpu_torch.native.build
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "partition.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdig_native-{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``partition.cpp`` unless a library of this source exists;
    raises ``RuntimeError`` when ``g++`` is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native partitioner "
                           "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o",
           str(tmp)]
    if verbose:
        print(" ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{res.stderr}")
    os.replace(tmp, lib)    # atomic: a concurrent build never sees half a file
    return lib


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
