"""The fragment-packed weights of the stack_full kernel, CPU.

The kernel (``csrc/reviser_stack.cu``) runs its products with mma.sync and
ldmatrix, which exist only on the card; its numerics are held against the
bf16 plain chain there (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Here, with no card:

* a plain-torch emulation of the kernel's addressing -- the offsets at which
  ``tile_mma`` and ``WeightStream`` (layer 1) read a lane's B-fragment
  registers, the ring's 16 KB fills of layers 2-4 and the two tiles a warp
  takes of each (``Ring::take``), and the mma.m16n8k16 register layout
  they feed -- reads every row-major matrix back from
  ``pack_full_weights`` bit for bit, for both models at T = 11 and 13, with
  zeros in the padding;
* products assembled from those fragments lane by lane, as the tensor cores
  combine them, equal the row-major products;
* the engine's kernel weights leave the CPU path unchanged: with the packed
  products present, ``stack_logits_full`` on CPU tensors is still the bf16
  plain chain and launches no kernel;
* ``csrc/`` holds only the kernels the program launches: its sources are
  ``build.SOURCES``, and each is the source of a ``build.Kernel`` that a
  module of ``ops/`` declares.
"""

import math

import numpy as np
import pytest
import torch

from nanoreviser_torch.models import ReviserConfig, init_reviser_params
from nanoreviser_torch.models.fused import fold_inference_params
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.ops import reviser_kernel as rk
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

TILE = 512          # bf16 of one streamed LSTM weight tile (kTile)
LAYERS = {          # key: (hidden, segments of the gate product per direction)
    "l1_f": (rk.H1, lambda w, d: [w["wi1"][:, 64 * d : 64 * d + 64], w["wh1"][d]]),
    "l2_r": (rk.H2, lambda w, d: [w["wi2"][d], w["wh2"][d]]),
    "l3_r": (rk.H3, lambda w, d: [w["wi3"][d], w["wi3s"][:, 512 * d : 512 * d + 512],
                                  w["wh3"][d]]),
    "l4_r": (rk.H4, lambda w, d: [w["wi4"][d], w["wh4"][d]]),
}
FILL = 8192         # bf16 of one ring fill (kFill): 8 warps x 2 tiles
DENSE = {"cw1_f": "cw1", "cw2_f": "cw2", "cc_f": "cc", "ce_f": "ce",
         "d1_f": "d1w", "d2_f": "d2w", "mo_f": "mow"}


def _stacked(t, seed=0):
    per_model = []
    for k, nc in enumerate((6, 5)):
        gen = torch.Generator().manual_seed(seed + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=t, n_classes=nc)), gen)
        per_model.append(rk.pack_stack_weights(fold_inference_params(p), t))
    return rk.stack_models(per_model)


def _lane_k(lane, j):
    """k within a k16 tile of register half j (0..3) of a lane's B
    fragment: b0 holds k = 2i, 2i+1, b1 k = 2i+8, 2i+9 (i = lane % 4)."""
    return 2 * (lane % 4) + (j % 2) + 8 * (j // 2)


def _read_dense(flat, n_nt, n_kt):
    """Row-major [16 n_kt, 8 n_nt] as tile_mma reads it: lane's uint2 at
    W + nt*NK*32 + kt*32 + lane, its 4 bf16 the registers b0, b1."""
    nt, kt, lane, j = torch.meshgrid(torch.arange(n_nt), torch.arange(n_kt),
                                     torch.arange(32), torch.arange(4),
                                     indexing="ij")
    off = ((nt * n_kt + kt) * 32 + lane) * 4 + j
    out = torch.full((16 * n_kt, 8 * n_nt), float("nan"))
    out[16 * kt + _lane_k(lane, j), 8 * nt + lane // 4] = flat[off]
    return out


def _tile_at(u, tau, d, hidden, tiles, ring):
    """The offset of group u's tile tau (of the concatenated segments) of
    direction d: layer 1 at wpack + ((d*G + u)*TILES + tau)*kTile, as
    lstm_layer's stream reads it; in the ring's order (layers 2-4) the tile
    t of warp w in fill f at wpack + ((d*NF + f)*8 + w)*2*kTile + t*kTile,
    as Ring::take hands it to the warp: warp w = u // Q runs its Q = H/64
    groups in turn, so the tile is number (u % Q)*TILES + tau of its
    sequence, two a fill."""
    if not ring:
        return ((d * (hidden // 8) + u) * tiles + tau) * TILE
    q = hidden // 64
    nf = q * tiles // 2
    w, seq = u // q, (u % q) * tiles + tau
    return (d * nf + seq // 2) * FILL + (w * 2 + seq % 2) * TILE


def _read_gates(flat, hidden, seg_k, d, ring):
    """Each segment [16 kt_s, 4H] of direction d as the kernel reads it:
    tile (seg offset + kt) of group u at ``_tile_at``, the lane's two 8-bf16
    pieces at lane*8 and kTile/2 + lane*8, gate g's registers b[2g],
    b[2g+1] at piece g / 2, elements 4(g % 2) .. +3."""
    groups = hidden // 8
    tiles = sum(seg_k)
    outs, t0 = [], 0
    for n_kt in seg_k:
        u, kt, lane, g, j = torch.meshgrid(
            torch.arange(groups), torch.arange(n_kt), torch.arange(32),
            torch.arange(4), torch.arange(4), indexing="ij")
        off = (_tile_at(u, t0 + kt, d, hidden, tiles, ring) + (g // 2) * TILE // 2
               + lane * 8 + 4 * (g % 2) + j)
        out = torch.full((16 * n_kt, 4 * hidden), float("nan"))
        out[16 * kt + _lane_k(lane, j), g * hidden + 8 * u + lane // 4] = flat[off]
        outs.append(out)
        t0 += n_kt
    return outs


def _same_bits(read, want):
    """read [K_pad, N_pad] holds want [K, N] exactly and zeros elsewhere."""
    k, n = want.shape
    assert not torch.isnan(read).any()
    assert torch.equal(read[:k, :n].to(torch.bfloat16).view(torch.int16),
                       want.view(torch.int16))
    assert not read[k:].any() and not read[:, n:].any()


@pytest.mark.parametrize("t", [11, 13])
def test_packed_fragments_read_back_row_major(t):
    ws = rk.kernel_weights(_stacked(t), "cpu")
    for k, shape in rk.FULL_SHAPES.items():
        assert ws[k].dtype == torch.bfloat16 and tuple(ws[k].shape) == (2,) + shape
    for m in range(2):
        w = {k: v[m] for k, v in ws.items()}
        for key, src in DENSE.items():
            flat = w[key].float().reshape(-1)
            n_nt, n_kt = rk.FULL_SHAPES[key][:2]
            _same_bits(_read_dense(flat, n_nt, n_kt), w[src])
        for key, (hidden, segments) in LAYERS.items():
            flat = w[key].float().reshape(-1)
            for d in (0, 1):
                segs = segments(w, d)
                seg_k = [-(-s.shape[0] // 16) for s in segs]
                ring = key != "l1_f"
                n_tiles = (2 * math.prod(rk.FULL_SHAPES[key][1:3]) // (hidden // 8)
                           if ring else rk.FULL_SHAPES[key][2])
                assert sum(seg_k) == n_tiles
                for read, want in zip(_read_gates(flat, hidden, seg_k, d, ring), segs):
                    _same_bits(read, want)


def _a_fragment(x, lane):
    """mma.m16n8k16's A registers of lane (row-major 16x16 x) as ldmatrix.x4
    loads them: a0 (row g, k 2i..), a1 (row g+8), a2 (row g, k 2i+8..), a3."""
    g, i = lane // 4, lane % 4
    return [x[g + 8 * (r % 2), 2 * i + 8 * (r // 2) + torch.arange(2)] for r in range(4)]


def _mma(x, frags):
    """[16, 8] = x [16, 16] @ the n8 tile whose B registers per lane are
    frags [32, 4], assembled register by register as the tensor core does:
    lane 4g + i holds D (row g | g+8, column 2i | 2i+1)."""
    a = torch.zeros(16, 16)
    b = torch.zeros(16, 8)
    for lane in range(32):
        g, i = lane // 4, lane % 4
        for r, v in enumerate(_a_fragment(x, lane)):
            a[g + 8 * (r % 2), 2 * i + 8 * (r // 2) + torch.arange(2)] = v
        b[_lane_k(torch.tensor(lane), torch.arange(4)), g] = frags[lane]
    d = torch.zeros(16, 8)
    for lane in range(32):
        g, i = lane // 4, lane % 4
        for e in range(4):
            row, col = g + 8 * (e // 2), 2 * i + e % 2
            d[row, col] = (a[row] * b[:, col]).sum()
    return d


def test_fragment_products_equal_row_major_products():
    ws = rk.kernel_weights(_stacked(11, seed=7), "cpu")
    rng = np.random.default_rng(0)
    # a conv product (z2 @ cc), one n8 tile over all its k16 tiles
    w = ws["cc"][1].float()
    x = torch.tensor(rng.normal(0, 1, (16, 400))).float().to(torch.bfloat16).float()
    frags = ws["cc_f"][1].float()                     # [8, 25, 32, 4]
    nt = 3
    got = sum(_mma(x[:, 16 * kt : 16 * kt + 16], frags[nt, kt]) for kt in range(25))
    torch.testing.assert_close(got, x @ w[:, 8 * nt : 8 * nt + 8], rtol=1e-5, atol=1e-4)
    # layer 3's gate product, backward direction, unit group 5 (warp 2's
    # second group: fills 10-19 of a step): the segments [l2 | s64 | h]
    # against wi3, wi3s's slice and wh3; gate g's tile is columns g*128 + 40
    # .. 47
    d, u, hidden = 1, 5, rk.H3
    packed = ws["l3_r"][0].float()[d, 10:, u // 2].reshape(20, 2, 32, 8)
    segs = LAYERS["l3_r"][1]({k: v[0].float() for k, v in ws.items()}, d)
    x = torch.tensor(rng.normal(0, 1, (16, 320))).float().to(torch.bfloat16).float()
    want = x @ torch.cat(segs)
    for g in range(4):
        got = sum(_mma(x[:, 16 * kt : 16 * kt + 16],
                       packed[kt, g // 2, :, 4 * (g % 2) : 4 * (g % 2) + 4])
                  for kt in range(20))
        cols = g * hidden + 8 * u + torch.arange(8)
        torch.testing.assert_close(got, want[:, cols], rtol=1e-5, atol=1e-4)


def test_kernel_weights_leave_the_cpu_path_plain():
    t = 11
    stacked = _stacked(t, seed=3)
    ws = rk.kernel_weights(stacked, "cpu")
    plain_ws = rk.weights_to_device(stacked, "cpu")
    assert set(ws) == set(plain_ws) | set(rk.FULL_SHAPES)
    for k, v in plain_ws.items():
        assert torch.equal(ws[k], v), k
    rng = np.random.default_rng(4)
    n_win, w_valid = 24, 19
    sig = torch.tensor(rng.normal(0, 1, (n_win + t, 64)), dtype=torch.float32)
    sig[:, 50:] = 0
    sig = sig.to(torch.bfloat16)
    feats = torch.tensor(rng.normal(0.5, 0.3, (n_win + t, 6)), dtype=torch.float32)
    before = rk.STACK_FULL.launches
    got = rk.stack_logits_full(ws, sig, feats, t_len=t, w_valid=w_valid,
                               n_windows=n_win, want_probs=True)
    want = rk.stack_logits_plain(plain_ws, sig, feats, t_len=t, w_valid=w_valid,
                                 n_windows=n_win, want_probs=True, bf16=True)
    assert rk.STACK_FULL.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[0][:, w_valid:].any()
    assert rk.STACK_FULL.replaces == "nanoreviser_tpu/ops/reviser_kernel.py:283"


_KW = {}


def _kernel_weights(t):
    if t not in _KW:
        _KW[t] = rk.kernel_weights(_stacked(t, seed=9), "cpu")
    return _KW[t]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("t", [11, 13])
def test_fetch_bytes_by_cluster_from_packed_shapes(t, cluster):
    """The bytes model of the kernels' schedule, recounted from the packed
    tensors a block reads: per step layer 1's gate products and biases
    whole and 1/cluster of layers 2-4's (the N-split), the heads' products
    once per pair of m16 tiles, the feature and final weights once, the
    conv products and biases once (stack_full); the L2 serves what the SM
    receives (no multicast); per step of layers 2-4 the x|s rows of the
    cluster - 1 peer blocks and the share of h the peers compute. Layers
    2-4 reach a block of the pair as the ring's 16 KB fills: a step of
    direction d is fills (d, 0 ..), each two 1 KB tiles of 8 warps, 3 / 20
    / 10 of them."""
    ws = _kernel_weights(t)
    b = lambda *keys: sum(ws[k][0].numel() * ws[k][0].element_size() for k in keys)
    split = b("l2_r", "l3_r", "l4_r", "b2", "b3", "b4")
    fills = {k: ws[k][0].shape[1] for k in ("l2_r", "l3_r", "l4_r")}
    assert fills == {"l2_r": 3, "l3_r": 20, "l4_r": 10}
    for k, n in fills.items():
        assert ws[k][0].shape[2:4] == (8, 2)           # 8 warps x 2 tiles a fill
        assert b(k) == 2 * n * 2 * FILL                 # 2 directions, 16 KB a fill
    core = (t * (b("l1_f", "b1") + split // cluster)
            + b("d1_f", "d2_f", "mo_f") * -(-t // 2)
            + b("d1b", "d2b", "mob", "fw", "fb", "fow", "fob"))
    conv = b("cw1_f", "cw2_f", "cc_f", "ce_f", "cb1", "cb2", "cbias")
    # bf16 rows a block copies from each peer per step: layer 1's output
    # (layer 2's x), layer 2's and the conv output (layer 3's x|s), layer 3's
    rows = 2 * 16 * (32 + (128 + 64) + 256)
    h_in = 2 * 16 * 2 * (64 + 128 + 64) * (cluster - 1) // cluster
    peer = t * ((cluster - 1) * rows + h_in)
    got_w = rk.stack_windows_fetch_bytes(t, cluster)
    got_f = rk.stack_full_fetch_bytes(t, cluster)
    assert got_w == {"l2": core, "sm": core, "peer": peer}
    assert got_f == {"l2": core + conv, "sm": core + conv, "peer": peer}
    if t == 11 and cluster == 1:          # the unsplit schedule's counts
        assert (got_f["l2"], got_w["l2"]) == (12766576, 12332528)
    # a full batch (11,952 blocks a model) at 305 GB unsplit: about 305 / C
    # of it is the split layers' share
    batch = 2 * 11952 * got_f["l2"] / 1e9
    unsplit = 2 * 11952 * rk.stack_full_fetch_bytes(t)["l2"] / 1e9
    assert unsplit / cluster <= batch < unsplit / cluster + 2 * 11952 * 0.9e6 / 1e9


def test_stack_profile_instruments_the_kernel_source():
    """The card-side phase profile (ops/stack_profile.py) patches a copy of
    csrc/reviser_stack.cu at anchors that must each occur once: a kernel
    change that moves one fails here, on the CPU, not on the card."""
    from nanoreviser_torch.ops import build, stack_profile

    src = (build.CSRC / "reviser_stack.cu").read_text()
    out = stack_profile.instrumented_source(src)
    for k in range(7):
        assert out.count(f"PROF_MARK({k});") == 1, k
    assert out.count("PROF_MARK(10);") == 1
    assert out.count("PROF_ADD(8,") == 1 and out.count("PROF_ADD(9,") == 1
    assert "#ifdef NO_MMA" in out and "#ifdef NO_STREAM" in out
    # nothing of the kernel itself is removed
    assert all(ln in out for ln in src.splitlines())
    with pytest.raises(ValueError, match="anchor"):
        stack_profile.instrumented_source(src.replace("PROF", "").replace(
            "  lstm_layer<kH1, 1, 0, 1, 2 * S>(", "  lstm_layer<kH1, 1, 0, 1,  2 * S>("))


PROGRAM_KERNELS = ("window_gather", "reviser_stack", "crf_decode", "lstm_layer")


@pytest.mark.parametrize("source", PROGRAM_KERNELS)
def test_csrc_holds_only_the_programs_kernels(source):
    """Every ``csrc/*.cu`` is built by ``build_all`` and launched through a
    ``build.Kernel`` of ``ops/``: a source that no kernel of the program
    launches has no place there."""
    import importlib
    import pkgutil

    from nanoreviser_torch import ops
    from nanoreviser_torch.ops import build

    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build.SOURCES)
    assert sorted(build.SOURCES) == sorted(PROGRAM_KERNELS)
    kernels = [k for m in pkgutil.iter_modules(ops.__path__)
               for k in vars(importlib.import_module(f"{ops.__name__}.{m.name}")).values()
               if isinstance(k, build.Kernel)]
    assert source in {k.source for k in kernels}
