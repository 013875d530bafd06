"""Build-and-load seam of the port's hand-written CUDA kernels, and the one
place a kernel wrapper decides between its kernel and its plain version.

Counterpart of ``repro.kernels.resolve_lowering``. There is no lowering
option and no environment override: the choice follows the tensors' device.

* CPU tensors run the plain PyTorch version of the kernel's math.
* CUDA tensors launch the hand-written kernel. A missing ``nvcc``, a failed
  build or a refused launch raises; nothing falls back to the plain version.
* Any other device raises.

Build: ``csrc/sign_topk.cu`` is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, cached under
``_build/`` by a hash of the source and flags, and loaded with ``ctypes``.
Pointers and the stream pass as ``c_void_p``. Every C entry point returns
``cudaGetLastError()`` after its launch, and :func:`check` raises when that
is not 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "sign_topk.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the kernel source."""


@dataclasses.dataclass(frozen=True)
class Built:
    """The compiled kernel library."""

    path: Path
    seconds: float      # nvcc wall time; 0.0 when the cached library was used
    log: str            # nvcc's -Xptxas -v register/spill lines; "" if cached


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc was not found on PATH or at /usr/local/cuda/bin/nvcc: the "
        "CUDA kernels cannot be built, and CUDA tensors have no other path")


def build() -> Built:
    """Compile ``csrc/sign_topk.cu`` (reusing a library of the same hash in
    ``_build/``) and return where the library lies."""
    nvcc = find_nvcc()
    cmd = [nvcc, *NVCC_FLAGS]
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(cmd).encode())
    lib = BUILD_DIR / f"libsign_topk-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return Built(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + ["-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {SOURCE.name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return Built(lib, seconds, out)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    return ctypes.CDLL(str(build().path))


def bind(lib: ctypes.CDLL, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` with its argument types declared (every
    pointer and the stream as ``c_void_p``) and an ``int`` error return."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        err = lib.error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"CUDA kernel {what} failed to launch: error {code} "
            f"({err(code).decode()})")


def uses_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every given tensor lies on one CUDA device (launch the
    kernel), False when every one lies on the CPU (run the plain version).
    Mixed devices, or any other device, raise. ``None`` entries are
    skipped."""
    devs = {t.device for t in tensors if t is not None}
    if not devs:
        raise ValueError("no tensor given to decide the kernel path")
    if len(devs) > 1:
        raise ValueError(f"kernel inputs lie on different devices: "
                         f"{sorted(str(d) for d in devs)}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {dev}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address of ``t`` for a ``c_void_p`` argument (``None`` -> NULL)."""
    return None if t is None else t.data_ptr()
