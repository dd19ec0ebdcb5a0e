"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of their
sources and flags, so a changed source is rebuilt and an unchanged one is
reused.  Nothing is compiled when this module is imported: the first
wrapper call that finds its library missing builds every missing one of
``KERNELS``, one ``nvcc`` process each, all started together (a process
that launches one kernel launches most of them, so its set-up waits for
the slowest build rather than their sum).  A wrapper binds its
entry point once (``entry``) and launches it on the current stream
(``launch``), so a call costs the checks, a dictionary lookup and the
ctypes call.  The ctypes argument types of a launch function are read from
its ``extern "C"`` signature in the source (``argtypes``), so they cannot
drift from the C function, and ``launch`` refuses a call that passes
another number of arguments.  ``build`` and ``load`` hold one process-wide
lock, and each build writes a temporary file named by process and thread,
so serving lanes on several threads may make their first calls at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "entry", "launch",
           "argtypes", "c_signatures", "extern_functions", "CTYPES",
           "check_cuda_args", "check_launch"]

# one library per source; spiking_conv_lif.cu holds kernels B and C
KERNELS = ("spiking_conv", "spiking_conv_lif", "lif_bwd", "conv_grad_input",
           "conv_grad_weights", "lif_fused", "skip_table")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the ctypes type of each kind of parameter a launch function takes; the
# last parameter of every launch function is ``void* stream``
CTYPES = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
          "long long": ctypes.c_longlong, "float": ctypes.c_float,
          "stream": ctypes.c_void_p}
_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)

_LIBS: Dict[str, ctypes.CDLL] = {}
# (source, entry point) -> (library, bound launch function, its argument
# count before the stream)
_ENTRIES: Dict[Tuple[str, str], Tuple[ctypes.CDLL, object, int]] = {}
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


def _c_kind(param: str) -> str:
    decl = " ".join(param.split())
    if "*" in decl:
        return "pointer"
    base = decl.rsplit(" ", 1)[0].replace("const ", "").strip()
    return base if base in CTYPES else f"unknown ({base})"


def extern_functions(path: Path) -> Iterator[Tuple[str, List[str], int]]:
    """(name, parameter kinds, line) of every ``extern "C" int`` function
    of the source ``path``; a last ``void* stream`` parameter is of kind
    stream."""
    text = re.sub(r"//[^\n]*", "", path.read_text())
    for m in _EXTERN.finditer(text):
        params = [p for p in m.group(2).split(",") if p.strip()]
        kinds = [_c_kind(p) for p in params]
        if params and re.search(r"void\s*\*\s*stream\s*$",
                                params[-1].strip()):
            kinds[-1] = "stream"
        yield m.group(1), kinds, text.count("\n", 0, m.start()) + 1


def c_signatures(csrc: Path = CSRC) -> Dict[str, Dict[str, List[str]]]:
    """{source stem: {entry: [kinds]}} of every ``extern "C"`` function in
    ``csrc/*.cu``."""
    return {path.stem: {name: kinds
                        for name, kinds, _ in extern_functions(path)}
            for path in sorted(csrc.glob("*.cu"))}


def argtypes(name: str, entry: str = "") -> List:
    """The ctypes argument types of launch function ``entry`` (default
    ``<name>_launch``) of source ``name``, read from its C signature."""
    entry = entry or f"{name}_launch"
    kinds = {n: k for n, k, _ in extern_functions(CSRC / f"{name}.cu")
             }.get(entry)
    if kinds is None:
        raise ValueError(f"{entry} is not an extern \"C\" function of "
                         f"csrc/{name}.cu")
    if not kinds or kinds[-1] != "stream" \
            or any(k not in CTYPES for k in kinds):
        raise ValueError(f"{entry} takes parameters {kinds}: each must be "
                         f"one of {sorted(CTYPES)}, the last void* stream")
    return [CTYPES[k] for k in kinds]


def load(name: str, entry: str = "") -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if need be (with
    every other missing library of ``KERNELS``, in parallel), with its
    launch function ``entry`` (default ``<name>_launch``) declared to take
    the ``argtypes`` of its C signature and return a CUDA error code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build(tuple(dict.fromkeys((name,) + KERNELS)))
            lib = ctypes.CDLL(str(path))
            lib.snn_error_string.argtypes = [ctypes.c_int]
            lib.snn_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        launch = getattr(lib, entry or f"{name}_launch")
        if launch.argtypes is None:
            launch.argtypes = argtypes(name, entry)
            launch.restype = ctypes.c_int
        return lib


def entry(name: str, entry: str = "") -> Tuple[ctypes.CDLL, object, int]:
    """(library, launch function, its argument count before the stream) of
    entry point ``entry`` (default ``<name>_launch``) of source ``name``:
    ``load``ed and bound at the first call, a dictionary lookup after it.
    Name both with string literals: ``analysis.cuda_abi`` checks them."""
    key = (name, entry or f"{name}_launch")
    found = _ENTRIES.get(key)
    if found is None:
        with _LOCK:
            lib = load(name, key[1])
            func = getattr(lib, key[1])
            found = _ENTRIES.setdefault(key, (lib, func,
                                              len(func.argtypes) - 1))
    return found


def launch(dev: torch.device, fn: str,
           bound: Tuple[ctypes.CDLL, object, int], *args) -> None:
    """Call the launch function of ``bound`` (an ``entry``) with ``args``
    and the current stream of ``dev``, on ``dev`` (made the current device
    only when it is not), and raise if the launch failed.  ``args`` must
    be as many as the C function's parameters before the stream (ctypes
    would pass extra ones on unchecked)."""
    lib, func, n = bound
    if len(args) != n:
        raise TypeError(f"{fn}: {len(args)} arguments before the stream, "
                        f"its launch function takes {n}")
    if dev.index == torch.cuda.current_device():
        rc = func(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = func(*args, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, fn, rc)


def check_cuda_args(fn: str, dtypes: Sequence[torch.dtype] = (torch.float32,),
                    **tensors: torch.Tensor) -> torch.device:
    """The checks every wrapper makes before it hands pointers to a kernel:
    one of ``dtypes`` (float32 unless the kernel takes more), contiguous,
    no autograd graph to feed (a launch builds none: the autograd Functions
    of ``spiking_conv``, ``spiking_conv_lif`` and the hoisted first layer
    call the launchers on detached tensors), and one CUDA device."""
    for k, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{fn}: {k} must be one of "
                            f"{[str(d) for d in dtypes]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {k} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{fn}: {k} requires grad, but a raw kernel launch has no "
                f"backward; differentiate through spiking_conv, "
                f"spiking_conv_lif or HoistedConvLIFFn, whose autograd "
                f"Functions run the backward kernels")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{fn}: all tensors must lie on one CUDA device, "
                         f"got {sorted(str(d) for d in devices)}")
    return devices.pop()


def check_launch(lib: ctypes.CDLL, fn: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.snn_error_string(rc).decode()
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{rc}: {msg}")
