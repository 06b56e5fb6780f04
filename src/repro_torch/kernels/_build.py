"""Build and load the port's CUDA kernels: ``nvcc`` → shared library with a
plain C interface → ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/<name>-<hash>.so`` at the repository root, where the
hash covers the source, the shared headers and the flags, so an edited
source never loads a stale library. Nothing is built when a module is
imported: the first launch of a kernel builds its library, and
:func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch
from torch._subclasses.fake_tensor import is_fake

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("kge_score", "topk", "sharded_gather", "rgcn_message",
           "wkv_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch are built from csrc/ at first use")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for the current source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES, *,
          ptxas_info: bool = False) -> Dict[str, str]:
    """Compile the named sources that have no library yet (all of them
    with ``ptxas_info=True``), one ``nvcc`` per source, all started
    together. Returns each compiled source's compiler log (with
    ``-Xptxas -v``, the registers, shared memory and spills per kernel).
    Raises with the compiler's errors if any source fails."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists() and not ptxas_info:
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_info else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs, errors = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{out}")
        else:
            os.replace(tmp, so)
            logs[name] = out
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(errors))
    return logs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    point returns the ``cudaError_t`` of its launch as an ``int``. Pointers
    and the stream must be ``ctypes.c_void_p`` — an undeclared argument is
    passed as a 32-bit int and a device pointer would be cut."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = library_path(name)
            if not so.exists():
                build([name])
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a failed launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {code}")


def on_cpu(kernel: str, *tensors) -> bool:
    """Dispatch rule of every kernel wrapper: ``True`` when all tensors lie
    on the CPU (the wrapper then runs the plain PyTorch version), ``False``
    when all lie on one CUDA device (the wrapper launches the kernel).
    Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return False


def require(kernel: str, name: str, t, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    — what a kernel's C entry point assumes of its pointers."""
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


# ---------------------------------------------------------------------- #
# Abstract tensors (the dry run)
# ---------------------------------------------------------------------- #
def is_abstract(*tensors) -> bool:
    """``True`` when a tensor is a ``FakeTensor`` or a ``DTensor`` whose
    local shard is one: the dry run's traced step. A wrapper then takes its
    abstract branch (``sharding/step_analysis.local_kernel_call``), which
    neither launches the kernel nor runs the plain version. A plain tensor
    is let through on its type alone, so a real call pays one comparison a
    tensor. A ``meta`` tensor is not abstract here: it lies on neither
    device, and the wrappers refuse it."""
    return any(type(t) is not torch.Tensor and t is not None and is_fake(t)
               for t in tensors)
