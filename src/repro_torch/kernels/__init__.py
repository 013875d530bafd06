"""Build-and-load seam of the port's hand-written CUDA kernels, and the one
place a kernel wrapper decides between its kernel and its plain version.

Counterpart of ``repro.kernels.resolve_lowering``. There is no lowering
option and no environment override: the choice follows the tensors' device.

* CPU tensors run the plain PyTorch version of the kernel's math.
* CUDA tensors launch the hand-written kernel. A missing ``nvcc``, a failed
  build or a refused launch raises; nothing falls back to the plain version.
* Any other device raises.

Build: every ``csrc/*.cu`` is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface: one
``nvcc`` per source, all started together. Each library is cached under
``_build/`` by a hash of its source and the flags, and loaded with
``ctypes``. Pointers and the stream pass as ``c_void_p``. Every C entry
point returns ``cudaGetLastError()`` after its launch, and :func:`check`
raises when that is not 0.

Beside each launch entry ``<entry>`` a source exports
``<entry>_launch_config`` (the grid and block the launch uses) and
``<entry>_attributes`` (``cudaFuncGetAttributes`` and the occupancy of the
compiled kernel), which :func:`launch_config` and :func:`attributes` read
for the audits (``repro_torch.analysis.kernel_lint``).
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
from typing import Dict, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {p.stem: p for p in sorted(CSRC.glob("*.cu"))}
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the kernel source."""


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled kernel library."""

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


def build() -> Dict[str, Built]:
    """Compile every ``csrc/*.cu`` (reusing a library of the same hash in
    ``_build/``), one ``nvcc`` per source, all at once. Returns each
    source's library by name (``"sign_topk"``, ``"qsgd"``). Raises
    :class:`KernelBuildError`, after every ``nvcc`` has ended, when any
    source failed."""
    nvcc = find_nvcc()
    cmd = [nvcc, *NVCC_FLAGS]
    built: Dict[str, Built] = {}
    running = {}
    for name, src in SOURCES.items():
        digest = hashlib.sha256(src.read_bytes() + " ".join(cmd).encode())
        lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        if lib.exists():
            built[name] = Built(lib, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(cmd + ["-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, lib, tmp, time.perf_counter())
    failed = []
    for name, (proc, lib, tmp, t0) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
        built[name] = Built(lib, seconds, out)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return built


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(str(build()[name].path))


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


def launch_config(source: str, entry: str, n_tiles: int) -> Tuple[int, int]:
    """``(grid, block)`` of launch entry ``entry`` of ``csrc/<source>.cu``
    over ``n_tiles`` tiles, from ``<entry>_launch_config``, the function
    the launch itself calls. Raises on a CUDA error."""
    lib = library(source)
    fn = bind(lib, f"{entry}_launch_config",
              (ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
               ctypes.POINTER(ctypes.c_int)))
    grid, block = ctypes.c_int(0), ctypes.c_int(0)
    check(lib, fn(int(n_tiles), ctypes.byref(grid), ctypes.byref(block)),
          f"{entry}_launch_config")
    return grid.value, block.value


def attributes(source: str, entry: str) -> Dict[str, int]:
    """The compiled kernel behind launch entry ``entry`` of
    ``csrc/<source>.cu``, from ``<entry>_attributes``: ``num_regs``,
    ``shared_bytes`` (static shared memory), ``local_bytes`` (spills),
    ``max_threads`` per block and ``blocks_per_sm`` at the launch's block
    size. Raises on a CUDA error."""
    lib = library(source)
    fn = bind(lib, f"{entry}_attributes",
              (ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
               ctypes.POINTER(ctypes.c_longlong),
               ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)))
    regs, threads, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    shared, local = ctypes.c_longlong(0), ctypes.c_longlong(0)
    check(lib, fn(ctypes.byref(regs), ctypes.byref(shared),
                  ctypes.byref(local), ctypes.byref(threads),
                  ctypes.byref(blocks)), f"{entry}_attributes")
    return {"num_regs": regs.value, "shared_bytes": shared.value,
            "local_bytes": local.value, "max_threads": threads.value,
            "blocks_per_sm": blocks.value}


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
