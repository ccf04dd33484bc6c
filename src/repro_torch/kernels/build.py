"""Build, load and call the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries go to ``<repo>/build/kernels/`` and are named by a hash
of the source, every shared header (``csrc/*.cuh``) and the flags: an edited
source or header builds anew, an unchanged one loads what is there.
Building happens at first use, from the repository's sources only;
:func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together.

Nothing here runs at import: a machine without ``nvcc`` imports the port and
runs its plain versions on CPU tensors, and raises only when a CUDA tensor
asks for a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

__all__ = [
    "KERNEL_SOURCES", "build", "check_launch", "check_tensor", "compile_counts", "kernel",
    "library_path", "stream_args",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES: Tuple[str, ...] = (
    "coo_matmul_T", "bias_all_relu", "bsmm_fwd", "bsmm_dx", "bsmm_dw", "coo_dw",
)
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# one first use at a time: threads that launch kernels (the async parameter
# server's workers) would otherwise build one source twice into one file
_FIRST_USE = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from csrc/ with the "
        "CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>.cu`` lives. The name
    hashes the headers too, since any source may include them."""
    h = hashlib.sha256((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{source}-{digest[:16]}.so"


def build(sources: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, all at once.

    Returns the compiler's output (``-Xptxas -v``: registers, spills) for
    each source it compiled. Waits for every ``nvcc`` it started before it
    raises on a failed one."""
    jobs = []
    for source in sources:
        path = library_path(source)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((source, proc, tmp, path))
    logs, failed = {}, []
    for source, proc, tmp, path in jobs:
        logs[source], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(source)
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(f"{s}.cu:\n{logs[s]}" for s in failed)
        )
    return logs


def kernel(source: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, built and loaded
    on first use, with its ``argtypes`` set and an ``int`` return (the
    ``cudaGetLastError()`` of the launch)."""
    fn = _FUNCS.get((source, symbol))
    if fn is None:
        with _FIRST_USE:
            fn = _FUNCS.get((source, symbol))
            if fn is None:
                build((source,))
                fn = getattr(ctypes.CDLL(str(library_path(source))), symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _FUNCS[(source, symbol)] = fn
    return fn


def compile_counts() -> Dict[str, int]:
    """The C entry points loaded in this process, per source (each loaded
    once, at first use, after ``nvcc`` built its library if it had to):
    the builds ``analysis.compilecheck`` counts."""
    counts: Dict[str, int] = {}
    for source, _ in _FUNCS:
        counts[source] = counts.get(source, 0) + 1
    return counts


def stream_args(device: torch.device) -> Tuple[int, int]:
    """(device index, PyTorch's current stream on it) for a C entry point:
    kernels launch on the caller's stream and never synchronise."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        # the error's name needs the CUDA runtime that a CPU build lacks
        name = f": {torch.cuda.CudaError(rc)}" if torch.cuda.is_available() else ""
        raise RuntimeError(f"{what} failed with CUDA error {rc}{name}")


def check_tensor(
    t: torch.Tensor, name: str, *, dtype: torch.dtype, shape: Tuple[int, ...],
    device: torch.device,
) -> None:
    """Raise unless ``t`` has the dtype, shape and device a kernel takes and
    is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
