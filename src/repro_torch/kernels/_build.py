"""Build and load the port's CUDA kernels: ``nvcc`` by hand into one
shared library with a plain C interface, loaded with ``ctypes``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into
``build/repro_torch/libkernels_<hash>.so`` at the repository root. The
hash covers the sources and the flags, so an edited kernel is rebuilt
and an unchanged one is loaded as it is. The build happens at first
use, never at import: this module imports on a host with no ``nvcc``.

No PyTorch header is compiled (a source that includes them takes
minutes), and nothing here needs ``ninja``. A failed build raises with
``nvcc``'s own message; there is no fallback.

Flags: ``-fmad=false`` keeps ``nvcc`` from contracting a multiply and
an add into an FMA, which would break the bit-identity of the quantize
and decode kernels with the reference (``repro.kernels.dequant._no_fma``
guards the same hazard there). Never ``--use_fast_math``: the quantize
kernel's division must be IEEE.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float     # 0.0 when an up-to-date library was loaded as is
    log: str           # nvcc's messages (ptxas register/shared-memory lines)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME "
                       "or /usr/local/cuda); the CUDA kernels cannot be "
                       "built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile every kernel source unless the library for these sources
    is already built. Returns where it is, how long the build took and
    what ``nvcc`` said."""
    lib = BUILD_DIR / f"libkernels_{_digest()}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        log = []
        failed = []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            log.append(f"--- {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stderr}")
        # atomic: a concurrent build of the same sources replaces it
        # with an identical file
        os.replace(tmp_lib, lib)
    return BuildInfo(lib, time.perf_counter() - t0, "\n".join(log))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build().path))
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


_FUNCTIONS: dict = {}


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """One launcher of the library with its C signature declared
    (``c_void_p`` for every pointer and the stream, so that ctypes does
    not cut a pointer to 32 bits). Resolved and declared once per name;
    every later call returns the same object, so a launch pays neither
    the lookup nor the declaration."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCTIONS[name] = fn
    return fn


def check_launch(err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaGetLastError()``:
    a launch the runtime refused never runs, and a later synchronize
    would not report it."""
    if err != 0:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, *, dtype: torch.dtype,
            shape: tuple, device: torch.device) -> None:
    """Validate a tensor before its pointer reaches a kernel: device,
    dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t: torch.Tensor, what: str) -> None:
    """A kernel wrapper runs its plain version only for a CPU tensor; any
    other device that is not CUDA is refused."""
    if not t.is_cuda:
        raise ValueError(f"{what}: tensors must be on the CPU (plain "
                         f"version) or on a CUDA device (kernel), got "
                         f"{t.device}")
