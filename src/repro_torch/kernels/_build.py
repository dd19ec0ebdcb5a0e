"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of their
sources and flags, so a changed source is rebuilt and an unchanged one is
reused.  Nothing is compiled when this module is imported: the first
wrapper call builds what it needs, and ``build`` builds several kernels at
once, one ``nvcc`` process each, all started together.  ``build`` and
``load`` hold one process-wide lock, and each build writes a temporary
file named by process and thread, so serving lanes on several threads may
make their first calls at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "check_cuda_args",
           "check_launch"]

# one library per source; spiking_conv_lif.cu holds kernels B and C
KERNELS = ("spiking_conv", "spiking_conv_lif", "lif_bwd", "conv_grad_input",
           "lif_fused")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# guards _LIBS, the build directory and the argtypes of the entry points
_LOCK = threading.RLock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin: "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel of ``names`` that has no library yet, all in
    parallel.  Returns each compiled kernel's ``ptxas`` report (registers,
    shared memory, spills); raises with the compiler's output on failure."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in names:
            out = _library_path(name)
            if out.exists():
                continue
            tmp = out.parent / (f"{out.name}.{os.getpid()}."
                                f"{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        reports, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            reports[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (rc={proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return reports


def load(name: str, argtypes: Sequence, entry: str = "") -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if need be, with
    its launch function ``entry`` (default ``<name>_launch``) declared to
    take ``argtypes`` and return a CUDA error code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.snn_error_string.argtypes = [ctypes.c_int]
            lib.snn_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        launch = getattr(lib, entry or f"{name}_launch")
        if launch.argtypes is None:
            launch.argtypes = list(argtypes)
            launch.restype = ctypes.c_int
        return lib


def check_cuda_args(fn: str, dtypes: Sequence[torch.dtype] = (torch.float32,),
                    **tensors: torch.Tensor) -> torch.device:
    """The checks every wrapper makes before it hands pointers to a kernel:
    one CUDA device, one of ``dtypes`` (float32 unless the kernel takes
    more), contiguous, and no autograd graph to feed (a launch builds none:
    the autograd Functions of ``spiking_conv`` and ``spiking_conv_lif``
    call the launchers on detached tensors)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{fn}: all tensors must lie on one CUDA device, "
                         f"got {sorted(str(d) for d in devices)}")
    for k, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{fn}: {k} must be one of "
                            f"{[str(d) for d in dtypes]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {k} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{fn}: {k} requires grad, but a raw kernel launch has no "
                f"backward; differentiate through spiking_conv or "
                f"spiking_conv_lif, whose autograd Functions run the "
                f"backward kernels")
    return devices.pop()


def check_launch(lib: ctypes.CDLL, fn: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.snn_error_string(rc).decode()
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{rc}: {msg}")
