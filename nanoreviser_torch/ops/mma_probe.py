"""Entries to the product and fill probe of ``csrc/mma_probe.cu``.

A measurement, not a port of a TPU kernel: at layer 3's shape of the stack
core (one direction's 512 gate columns, 32 windows, K = 20 k16 tiles), one
block per SM, it times the split layers' products with operands already in
shared memory -- the split layers' ``mma.sync`` loop (variant 0) and ``wgmma`` m64n16k16 (two products sharing A, variant 1) or
m64n32k16 (variant 2) from two warpgroups -- and stores each variant's
sums, so that a bit check can compare them; and it times weight fills of
one 48 or 64 KB ring per block from one producer warp, per-lane
``cp.async`` (fill variant 0) or one ``cp.async.bulk`` per fill of 8-32 KB
(1).
``chip_smoke.py``'s probe phase runs it. CUDA only: a measurement has no
plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .reviser_kernel import _gate_fragments

SOURCE = "mma_probe"
VARIANTS = {0: "mma.sync m16n8k16 (the split layers' loop)",
            1: "wgmma m64n16k16, two sharing A (own, peer windows)",
            2: "wgmma m64n32k16"}
FILL_VARIANTS = {0: "cp.async per lane, cp.async.mbarrier.arrive",
                 1: "cp.async.bulk"}
K_TILES, RES, WINDOWS, HIDDEN = 20, 4, 32, 128
COLS = 4 * HIDDEN
FILL_SHAPES = ((8192, 49152), (16384, 49152), (16384, 65536), (32768, 65536))


def wgmma_a_tiles(w: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The A operand of ``wgmma.mma_async`` m64nNk16 (K-major, no swizzle)
    for w [K, N], K zero-padded to a multiple of 16: row r of m tile i is
    column ``rows[i, r]`` of w. Returns [n, K/16, 1024]: element (r, k) of
    k16 tile kt at ((k // 8) * 8 + r // 8) * 64 + (r % 8) * 8 + k % 8, so
    each core matrix (8 rows x 16 bytes) is contiguous, the row groups 128
    bytes apart (the descriptor's SBO) and the two k halves 1024 (LBO)."""
    k_pad = -(-w.shape[0] // 16) * 16
    wp = np.zeros((k_pad, w.shape[1]), w.dtype)
    wp[: w.shape[0]] = w
    r, k = np.arange(64)[:, None], np.arange(16)[None, :]
    pos = ((k // 8) * 8 + r // 8) * 64 + (r % 8) * 8 + k % 8     # [64, 16]
    kt = np.arange(k_pad // 16)
    vals = wp[16 * kt[None, :, None, None] + k[None, None],
              rows[:, None, :, None]]                          # [n, KT, 64, 16]
    out = np.zeros(vals.shape[:2] + (1024,), w.dtype)
    out[:, :, pos] = vals
    return out


def gate_rows(hidden: int) -> np.ndarray:
    """[4H / 64, 64]: the gate columns of the m64 tiles of one direction's
    gate product ([K, 4H], gates i, f, c, o): tile 2u + p holds units 32u ..
    32u + 31, row 16 w + 8 h + j being gate 2p + h of unit 32 u + 8 w + j,
    so a wgmma thread's accumulator rows of tiles 2u and 2u + 1 are the
    four gates of the same units."""
    r = np.arange(64)
    unit = 8 * (r // 16) + r % 8
    return np.array([(2 * p + (r % 16) // 8) * hidden + 32 * u + unit
                     for u in range(hidden // 32) for p in (0, 1)])


def _lib():
    return build.load(SOURCE)


def operands(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(w [16 RES, 512], x [32, 320]): bf16-valued f32 weights of RES k16
    tiles (k tile kt of the chain reads tile kt % RES) and activations."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.25, 0.25, (16 * RES, COLS)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (WINDOWS, 16 * K_TILES)).astype(np.float32)
    rnd = lambda a: torch.tensor(a).to(torch.bfloat16).float().numpy()
    return rnd(w), rnd(x)


def packed(w: np.ndarray, x: np.ndarray) -> dict:
    """bf16 CPU tensors of each variant's operands: ``mma_w`` the 1 KB
    fragment tiles [warp 8][group 2][RES][2][32][8], ``mma_x`` row-major x;
    ``wgmma_w`` [RES][m tile 8][1024] m64 tiles, ``wgmma_x`` [k/8][32][8]."""
    frags = _gate_fragments([w], HIDDEN)              # [16 groups, RES, 2, 32, 8]
    tiles = wgmma_a_tiles(w, gate_rows(HIDDEN))       # [8, RES, 1024]
    core = x.reshape(WINDOWS, -1, 8).transpose(1, 0, 2)
    bf = lambda a: torch.tensor(np.ascontiguousarray(a)).to(torch.bfloat16)
    return {"mma_w": bf(frags), "mma_x": bf(x), "wgmma_w": bf(tiles.transpose(1, 0, 2)),
            "wgmma_x": bf(core)}


def reference(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[512, 32] f64: the chain's sums, gate column by window."""
    wk = np.concatenate([w[16 * (kt % RES) : 16 * (kt % RES) + 16]
                         for kt in range(K_TILES)]).astype(np.float64)
    return (x.astype(np.float64) @ wk).T


def launch_mma(variant: int, n_ctas: int, smem: int, w: torch.Tensor,
               x: torch.Tensor, steps: int, out: torch.Tensor) -> None:
    """One product launch (``packed``'s operands of the variant on the
    card) into ``out`` (f32 [n_ctas, 512, 32])."""
    build.require_cuda(w, x, out)
    if out.dtype != torch.float32 or out.numel() != n_ctas * COLS * WINDOWS:
        raise ValueError(f"probe output must be f32 [{n_ctas}, {COLS}, {WINDOWS}]")
    fn = _lib().nr_probe_mma
    fn.restype = ctypes.c_int
    code = fn(build.c_int(variant), build.c_int(n_ctas), build.c_int(smem),
              build.c_ptr(w), build.c_ptr(x), build.c_int(steps), build.c_ptr(out),
              build.stream_of(w.device))
    if code != 0:
        raise build.KernelLaunchError(f"mma probe variant {variant}: CUDA error "
                                      f"{code} at launch")


def fill_source_bytes() -> int:
    return int(_lib().nr_probe_fill_source_bytes())


def launch_fill(variant: int, fill_bytes: int, ring_bytes: int, n_ctas: int,
                smem: int, src: torch.Tensor, reps: int, out: torch.Tensor) -> None:
    """One fill launch (a pair of ``FILL_SHAPES``) on ``src``
    (``fill_source_bytes()`` bytes on the card) into ``out`` (int32 [n_ctas *
    256])."""
    build.require_cuda(src, out)
    if src.numel() * src.element_size() != fill_source_bytes():
        raise ValueError(f"fill source must be {fill_source_bytes()} bytes")
    if out.dtype != torch.int32 or out.numel() != n_ctas * 256:
        raise ValueError(f"fill output must be int32 [{n_ctas * 256}]")
    fn = _lib().nr_probe_fill
    fn.restype = ctypes.c_int
    code = fn(build.c_int(variant), build.c_int(fill_bytes), build.c_int(ring_bytes),
              build.c_int(n_ctas),
              build.c_int(smem), build.c_ptr(src), build.c_int(reps),
              build.c_ptr(out), build.stream_of(src.device))
    if code != 0:
        raise build.KernelLaunchError(f"fill probe variant {variant} ({fill_bytes} B): "
                                      f"CUDA error {code} at launch")


def fill_acks(src: torch.Tensor, fill_bytes: int) -> np.ndarray:
    """[256] words a block stores for an odd ``reps``: consumer thread i
    XORs the 4 words at i * 16 + 4096 j of every fill (bytes [f F, f F + F)
    of the source)."""
    words = src.view(torch.int32).cpu().numpy().reshape(-1, fill_bytes // 4096, 256, 4)
    return np.bitwise_xor.reduce(words.transpose(2, 0, 1, 3).reshape(256, -1), axis=1)
