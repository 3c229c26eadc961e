"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` alone into a
shared library with a plain C interface, which ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>_<hash>.so

No PyTorch headers are compiled, so a build takes seconds. ``--use_fast_math``
is never passed: the window gather relies on IEEE division. Libraries go to
``build/torch_kernels/`` beside the package (``build/`` is git-ignored),
named by a hash of the source and flags, so a changed source is rebuilt.
``python -m nanoreviser_torch.ops.build`` builds every kernel in parallel
and prints what ptxas reports (registers, spills, shared memory).

Every C entry takes PyTorch's current stream, allocates nothing, and
returns ``cudaGetLastError()``; the wrapper raises on a non-zero code. Each
kernel keeps a plain-integer count of its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("window_gather", "reviser_stack", "crf_decode", "lstm_layer")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (needs the CUDA toolkit)")


def _lib_path(source: str) -> Path:
    text = (CSRC / f"{source}.cu").read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source}_{digest}.so"


def _start_build(source: str):
    """Start nvcc for one source; returns (path, process or None if built)."""
    out = _lib_path(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, (proc, tmp)


def _finish_build(source: str, out: Path, pending) -> str:
    if pending is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.exists() else ""
    proc, tmp = pending
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {source}.cu:\n{log}")
    os.replace(tmp, out)
    (out.with_suffix(".log")).write_text(log)
    return log


def build_all(sources=SOURCES) -> dict:
    """Compile every source at once (one nvcc each, started together).
    Returns {source: nvcc/ptxas log} (the saved log for a library already
    built)."""
    started = {s: _start_build(s) for s in sources}
    return {s: _finish_build(s, out, pend) for s, (out, pend) in started.items()}


def load(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            out, pending = _start_build(source)
            _finish_build(source, out, pending)
            lib = ctypes.CDLL(str(out))
            _libs[source] = lib
        return lib


class Kernel:
    """One CUDA kernel: its library, its C entry calls and its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._entries: dict = {}

    def launch(self, entry: str, *args) -> None:
        fn = self._entries.get(entry)
        if fn is None:   # bound once: the types are those of the first call
            fn = getattr(load(self.source), entry)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(a._type_) if isinstance(a, ctypes.Array)
                           else type(a) for a in args]
            self._entries[entry] = fn
        code = fn(*args)
        if code != 0:
            raise KernelLaunchError(
                f"{self.name}: CUDA error {code} at launch ({entry})")
        self.launches += 1


def require_cuda(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors, got one on {t.device}")


def c_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def c_int(v: int) -> ctypes.c_int:
    return ctypes.c_int(int(v))


c_void_p = ctypes.c_void_p


def ptr_array(ptrs) -> ctypes.Array:
    """A host array of device pointers (the C entry copies it into the
    kernel's parameter struct)."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


if __name__ == "__main__":
    for src, log in build_all().items():
        print(f"== {src}\n{log}")
