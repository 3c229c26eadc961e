"""Build the host library ``libnanorev`` from ``src/nanorev.cpp`` with g++.

    g++ -O3 -std=c++17 -fPIC -shared -mf16c -ffp-contract=off
        -o build/torch_native/libnanorev_<hash>.so src/nanorev.cpp -ldl

The library goes to ``build/torch_native/`` beside the package (``build/``
is git-ignored), named by a hash of the source and the flags, so a changed
source is rebuilt and a stale library is never loaded. ``-mf16c`` is what
the f32 -> f16 conversions need; ``-ffp-contract=off`` keeps GCC from fusing
``s2/cnt - mean*mean`` into one multiply-add, which would change the f64
values the features round from. No ``-march=native``: the hash does not
name the host, so a library built on one machine may be loaded on another.
The library needs nothing beyond libc and libstdc++ at build time (``-ldl``
for ``dlopen`` on a glibc older than 2.34); zlib is loaded at run time.
A failed build raises :class:`NativeBuildError`.

``python -m nanoreviser_torch.native.build`` builds it ahead of time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "nanorev.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-mf16c",
            "-ffp-contract=off"]
LDFLAGS = ["-ldl"]


class NativeBuildError(RuntimeError):
    pass


def lib_path() -> Path:
    digest = hashlib.sha1(
        SRC.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libnanorev_{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Concurrent
    builds (several processes at first use) each write a file of their own
    and rename it into place."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found: the host library needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    res = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SRC), *LDFLAGS],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed for {SRC.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
