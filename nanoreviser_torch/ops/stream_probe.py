"""Entries to the weight-stream probe of ``csrc/stream_probe.cu``.

The probe is a measurement, not a port of a TPU kernel: at one block per SM
with the stack kernel's shared-memory footprint, every warp streams its 80
KB of a model's packed ``l3_r`` through a ring of 8 KB in shared memory
``reps`` times over, by per-lane ``cp.async`` (variant 0, as the stack's
``WeightStream`` did), by one bulk copy per fill (variant 1) or by bulk
copies multicast over a cluster (variant 2). ``chip_smoke.py``'s probe
phase times it. CUDA only: there is no plain version of a measurement.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

SOURCE = "stream_probe"
VARIANTS = {0: "cp.async per lane", 1: "bulk copy", 2: "bulk copy, multicast"}


def _lib():
    return build.load(SOURCE)


def source_bytes() -> int:
    """Bytes of the source the probe streams (one model's ``l3_r``)."""
    return int(_lib().nr_probe_source_bytes())


def active_clusters(cluster: int, fill_bytes: int, smem: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the multicast kernel at one
    block per SM with ``smem`` bytes of shared memory."""
    n = int(_lib().nr_probe_active_clusters(build.c_int(cluster),
                                            build.c_int(fill_bytes),
                                            build.c_int(smem)))
    if n < 0:
        raise build.KernelLaunchError(f"probe: no occupancy for clusters of {cluster}")
    return n


def launch(variant: int, cluster: int, fill_bytes: int, n_ctas: int, smem: int,
           src: torch.Tensor, reps: int, out: torch.Tensor) -> None:
    """One probe launch on ``src`` (CUDA, ``source_bytes()`` bytes, 16-byte
    aligned) into ``out`` (int32, n_ctas * 256)."""
    build.require_cuda(src, out)
    if src.numel() * src.element_size() != source_bytes() or not src.is_contiguous():
        raise ValueError(f"probe source must be {source_bytes()} contiguous bytes")
    if out.dtype != torch.int32 or out.numel() != n_ctas * 256:
        raise ValueError(f"probe output must be int32 [{n_ctas * 256}]")
    fn = _lib().nr_probe_stream
    fn.restype = ctypes.c_int
    code = fn(build.c_int(variant), build.c_int(cluster), build.c_int(fill_bytes),
              build.c_int(n_ctas), build.c_int(smem), build.c_ptr(src),
              build.c_int(reps), build.c_ptr(out), build.stream_of(src.device))
    if code != 0:
        raise build.KernelLaunchError(
            f"probe variant {variant} (cluster {cluster}, fill {fill_bytes}): "
            f"CUDA error {code} at launch")


def expected_acks(src: torch.Tensor) -> np.ndarray:
    """[256] words every block stores for an odd ``reps``: thread 32 w + l
    XORs the 8 words it reads of each of warp w's 80 tiles (its 16 bytes of
    each half)."""
    words = src.view(torch.int32).cpu().numpy().reshape(8, 80, 2, 32, 4)
    return np.bitwise_xor.reduce(
        words.transpose(0, 3, 1, 2, 4).reshape(8, 32, -1), axis=2).reshape(-1)
