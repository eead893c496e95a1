"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each source is a file with a plain ``extern "C"`` launcher and no PyTorch
headers, so one nvcc call takes seconds; the ``.cuh`` headers beside the
sources hold device functions that several kernels share.  Libraries go
to ``_build/`` beside this file, named by a hash of the source, the
headers and the flags, so a changed source or header builds anew and an
unchanged one is reused.  A library is written under a temporary name and
moved into place with ``os.replace``: there is no lock file, and a build
that was cut off leaves nothing that a later one waits on.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import errors

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -fmad=false: no multiply-add contraction, so a kernel's float32 arithmetic
# rounds exactly as its eager PyTorch plain version does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 300


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    ]:
        if cand.is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns what nvcc printed (registers, shared memory, spills), or "" if
    the library was already built.  Raises with nvcc's output if the
    compile fails or takes longer than ``NVCC_TIMEOUT_S``.
    """
    lib = library_path(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc {name} exited {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def check_arg(name, t, shape, dtype, device) -> None:
    """Raise InvalidArgumentError unless tensor ``t`` is contiguous, of
    ``dtype`` and ``shape``, on ``device``: what a kernel's wrapper checks
    before it passes the pointer on."""
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise errors.InvalidArgumentError(
            f"{name} must be a contiguous {dtype} tensor on {device}"
        )
    if tuple(t.shape) != shape:
        raise errors.InvalidArgumentError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}"
        )


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
