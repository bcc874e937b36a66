"""Build the port's CUDA kernels into shared libraries bound with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``) into ``build/`` at the root of the checkout, at first use.
The library's file name carries a digest of the source and the flags, so a
changed source never reuses a stale build.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills per kernel) is kept beside each
library as ``<name>.log``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled at first use and "
            "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless it is built already; returns the library's
    path.  Raises with the compiler's output if the build fails."""
    source = Path(source)
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    lib.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, lib)     # atomic: a concurrent builder sees all or none
    return lib
