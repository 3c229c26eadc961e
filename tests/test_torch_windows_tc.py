"""The tensor-core ``stack_windows`` kernel's schedule, on the CPU.

The kernel (``nr_stack_windows`` in ``csrc/reviser_stack.cu``) runs
``stack_full``'s stack core on pre-gathered windows; its mma.sync, ldmatrix
and cp.async exist only on the card, where ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the bf16 plain version. Here, with no
card:

* ``kernel_weights`` of one model equals the one-model slice of the
  two-model ``kernel_weights`` (what ``stack_logits_single`` passes), for
  every key at T = 11 and 13;
* on CPU tensors ``stack_logits_multi`` / ``stack_logits_single`` give the
  same results from ``kernel_weights`` as from ``weights_to_device`` and
  launch nothing;
* a plain-torch emulation of the kernel's schedule -- the block's shared
  memory as one flat NaN-filled buffer per block of 16 windows, the staging
  into the [t][window][ld] layouts (the features in buffer A past layer 1's
  output), layer 1's gate products from the packed ``l1_f`` tiles as
  ``WeightStream`` hands them out of a per-warp S-slot ring (S = 4 here;
  the depth decides only how far ahead the copies run, not which tile a
  read returns), layers 2-4's from the ring of 16 KB fills that the
  producer warp streams from the packed ``l2_r``, ``l3_r``, ``l4_r`` (the
  fills' order, S = 2 slots refilled as each fill is taken, each warp's
  two tiles of a fill the next two of its groups' tiles in turn),
  the x/s operand rows at ``t * 16 + r``, the kernel's bias-add order, f32
  products of bf16 operands, h rounded to bf16, and the heads from the
  packed ``d1_f``, ``d2_f``, ``mo_f`` -- is within max |dlogit| 0.05 of
  ``stack_windows_plain(bf16=True)`` at M = 1 and 2, T = 11 and 13, n = 5
  and 33 (the bar the kernel is held to on the card; the two differ only
  in summation order and the bf16 rounding of h that follows from it);
* in that emulation the N-split -- blocks in clusters of 2 (the grid
  padded to whole clusters), layer 1 per block, layers 2-4 split by
  direction, the peer's x and s rows copied each step into P, its h kept in
  M by step parity (their strides per layer), h stored into both blocks'
  outputs -- gives logits and probs bit-identical to the unsplit schedule
  (each k16 product is taken exactly, so a row's result depends on its own
  operands only), and so does the split schedule before the ring (each
  warp streaming the fragment tiles of its groups, ``_gate_fragments``'
  order, through its own ring, with fixed strides of P and M): the ring's
  order changes which fill brings a tile, not a product or its k order.
  Against the bf16 plain version the emulation cannot be bit-identical:
  torch sums a product's K terms in another order than the k16 tiles do.
"""

import numpy as np
import pytest
import torch

from nanoreviser_torch.models import ReviserConfig, init_reviser_params
from nanoreviser_torch.models.fused import fold_inference_params
from nanoreviser_torch.models.reviser import randomize_inference_stats
from nanoreviser_torch.ops import reviser_kernel as rk
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

# the kernel's constants (csrc/reviser_stack.cu)
KG, TILE = 16, 512
LD_X, LD_F = 72, 24
LD_L1, LD_L2, LD_L3, LD_L4 = 40, 136, 264, 136
LD_H1, LD_H2 = 136, 40
LD_P, LD_M = 264, 136   # the peer's rows before the ring (fixed strides)
SLOTS = 4
RING_SLOTS = 2
FILL = 8192             # bf16 of one 16 KB fill: 8 warps x 2 tiles
CLUSTER = 2             # nr_stack_cluster_size: the N-split's pair


def _stacked(t, seed, n_models=2):
    per_model = []
    for k, nc in enumerate((6, 5)[:n_models]):
        gen = torch.Generator().manual_seed(seed + k)
        p = randomize_inference_stats(
            init_reviser_params(gen, ReviserConfig(window=t, n_classes=nc)), gen)
        per_model.append(rk.pack_stack_weights(fold_inference_params(p), t))
    return rk.stack_models(per_model)


def _inputs(n, t, n_models, seed):
    rng = np.random.default_rng(seed)
    feats = torch.tensor(rng.normal(0.5, 0.3, (n, t, 6)), dtype=torch.float32)
    sig = torch.tensor(rng.normal(0, 1, (n_models, n, t, 64)), dtype=torch.float32)
    return feats, sig


@pytest.mark.parametrize("t", [11, 13])
def test_one_model_kernel_weights_equal_the_slice_of_two(t):
    two = _stacked(t, seed=3)
    one = rk.kernel_weights({k: v[:1] for k, v in two.items()}, "cpu")
    both = rk.kernel_weights(two, "cpu")
    assert set(one) == set(both) and set(rk.FULL_ORDER) <= set(one)
    for k in both:
        assert one[k].shape[0] == 1 and both[k].shape[0] == 2, k
        assert one[k].dtype == both[k].dtype, k
        assert torch.equal(one[k][0], both[k][0]), k
        # what stack_logits_single hands the kernel: a contiguous view of model 0
        assert both[k][0][None].is_contiguous()


def test_cpu_wrappers_same_from_kernel_weights_and_launch_nothing():
    t = 11
    stacked = _stacked(t, seed=5)
    kw = rk.kernel_weights(stacked, "cpu")
    plain_ws = rk.weights_to_device(stacked, "cpu")
    feats, sig = _inputs(21, t, 2, seed=6)
    kernels = (rk.STACK_FULL, rk.STACK_WINDOWS)
    before = [k.launches for k in kernels]
    got = rk.stack_logits_multi(kw, feats, sig, t_len=t, want_probs=True)
    want = rk.stack_logits_multi(plain_ws, feats, sig, t_len=t, want_probs=True)
    one = rk.stack_logits_single({k: v[0] for k, v in kw.items()}, feats, sig[0],
                                 t_len=t, want_probs=True)
    one_plain = rk.stack_logits_single({k: v[0] for k, v in plain_ws.items()},
                                       feats, sig[0], t_len=t, want_probs=True)
    assert [k.launches for k in kernels] == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(one[0], one_plain[0]) and torch.equal(one[1], one_plain[1])
    assert torch.equal(one[0], got[0][0])


# ------------------------------------------------- emulation of the kernel


def _bf(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _lane_k(lane, j):
    """k within a k16 tile of register half j (0..3) of a lane's B
    fragment: b0 holds k = 2i, 2i+1, b1 k = 2i+8, 2i+9 (i = lane % 4)."""
    return 2 * (lane % 4) + (j % 2) + 8 * (j // 2)


def _gate_index():
    """[4 gates, 16 k, 8 n]: the element of a streamed tile that gate g's
    B-fragment register of lane (4n + i) holds for k: piece g // 2 (the
    lane's 8 bf16 at (g // 2) * TILE / 2 + lane * 8), elements 4 (g % 2)
    .. +3, register half j."""
    idx = torch.empty(4, 16, 8, dtype=torch.long)
    for g in range(4):
        for lane in range(32):
            for j in range(4):
                idx[g, _lane_k(lane, j), lane // 4] = (
                    (g // 2) * TILE // 2 + lane * 8 + 4 * (g % 2) + j)
    return idx


GATE_IDX = _gate_index()


class _Stream:
    """WeightStream<S> of one warp: requests run S - 1 tiles ahead into an
    S-slot ring (copies complete at once here), each next() reads the slot
    of the tile taken and then refills the slot the previous call read."""

    def __init__(self, flat, src, per_step, t_len, slots):
        self.flat, self.src, self.per_step = flat, src, per_step
        self.total, self.slots = per_step * t_len, slots
        self.ring = torch.full((slots, TILE), float("nan"))
        self.requested = self.taken = self.next_src = 0
        for _ in range(slots - 1):
            self._request()

    def _request(self):
        if self.requested < self.total:
            o = self.src + self.next_src * TILE
            self.ring[self.requested % self.slots] = self.flat[o : o + TILE]
            self.next_src = (self.next_src + 1) % self.per_step
        self.requested += 1

    def next(self):
        """[16, 32]: the next tile's four gate n8 tiles side by side."""
        tile = self.ring[self.taken % self.slots].clone()
        self.taken += 1
        self._request()
        return tile[GATE_IDX].permute(1, 0, 2).reshape(16, 32)


def _rows(smem, off, ld, rows, k_tiles):
    """[blocks, len(rows), 16 k_tiles]: rows ``rows`` of the bf16 matrix at
    ``off`` with row stride ``ld``, as ldmatrix reads them."""
    idx = off + rows[:, None] * ld + torch.arange(16 * k_tiles)[None, :]
    return smem[:, idx]


def _gate_tiles(a, k_tiles, stream):
    """sum over k16 tiles of a [blocks, rows, 16 K] @ the stream's next K
    tiles, in the order of the k loop: [blocks, rows, 4 gates, 8]. Each
    k16 product of bf16 values is exact in f64 and rounded once to f32, so
    a row's result depends on nothing but its own operands (not on how many
    rows are multiplied at once)."""
    acc = torch.zeros(a.shape[0], a.shape[1], 32)
    for kt in range(k_tiles):
        w = stream.next().double()
        acc = acc + (a[:, :, 16 * kt : 16 * kt + 16].double() @ w).float()
    return acc.reshape(a.shape[0], a.shape[1], 4, 8)


def _hs(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _lstm_layer(smem, hidden, kx, ks, kh, x, s, out, wpack, bias, t_len, slots):
    """lstm_layer<H, KX, KS, KH, S>: x, s = (offset, ld, step), out =
    (offset, ld); 8 warps, warps 0-3 the forward direction; a warp owns
    GPW groups of 8 units and its own stream."""
    groups = hidden // 8
    gpw = groups // 4 if groups >= 4 else 1
    tiles = kx + ks + kh
    flat = wpack.float().reshape(-1)
    r16 = torch.arange(16)
    warps = []
    for warp in range(8):
        d, u0 = warp >> 2, (warp & 3) * gpw
        if u0 < groups:
            warps.append((d, u0, _Stream(flat, (d * groups + u0) * tiles * TILE,
                                         gpw * tiles, t_len, slots)))
    c = {}
    for st in range(t_len):
        for d, u0, ws in warps:
            t = t_len - 1 - st if d else st
            tp = t if st == 0 else (t + 1 if d else t - 1)
            xa = _rows(smem, x[0], x[1], t * x[2] + r16, kx)
            sa = _rows(smem, s[0], s[1], t * s[2] + r16, ks) if ks else None
            ha = _rows(smem, out[0] + d * hidden, out[1], tp * KG + r16, kh)
            for q in range(gpw):
                cols = (u0 + q) * 8 + torch.arange(8)
                acc = _gate_tiles(xa, kx, ws)
                acc = acc + bias[d * 4 * hidden + hidden * torch.arange(4)[:, None]
                                 + cols[None, :]]
                if ks:
                    acc = acc + _gate_tiles(sa, ks, ws)
                part = _gate_tiles(torch.zeros_like(ha) if st == 0 else ha, kh, ws)
                z = acc + part
                cq = c.get((d, u0 + q), torch.zeros(z.shape[0], 16, 8))
                cq = _hs(z[:, :, 1]) * cq + _hs(z[:, :, 0]) * torch.tanh(z[:, :, 2])
                c[(d, u0 + q)] = cq
                h = _bf(_hs(z[:, :, 3]) * torch.tanh(cq))
                idx = (out[0] + (t * KG + r16)[:, None] * out[1] + d * hidden
                       + cols[None, :])
                smem[:, idx] = h
    for _, _, ws in warps:
        assert ws.taken == ws.total and ws.requested == ws.total + ws.slots - 1


class _Ring:
    """The producer's ring of one block and direction: fills of FILL bf16
    from ``flat`` at ``src``, ``per_step`` a step and T times over, landing
    ``slots`` ahead of the fill taken; each take returns the fill (its slot
    refilled at once, as the warps release it once their tiles are in
    registers) as [8 warps, 2 tiles, TILE]."""

    def __init__(self, flat, src, per_step, t_len, slots):
        self.flat, self.src, self.per_step = flat, src, per_step
        self.total, self.slots = per_step * t_len, slots
        self.ring = torch.full((slots, FILL), float("nan"))
        self.issued = self.taken = 0
        for _ in range(slots):
            self._issue()

    def _issue(self):
        if self.issued < self.total:
            o = self.src + (self.issued % self.per_step) * FILL
            self.ring[self.issued % self.slots] = self.flat[o : o + FILL]
            self.issued += 1

    def take(self):
        fill = self.ring[self.taken % self.slots].clone()
        self.taken += 1
        self._issue()
        return fill.reshape(8, 2, TILE)


def _ring_chain(a, k_tiles, ring):
    """gate_chain<K>: a [blocks, rows, 16 K] @ the ring's next K / 2 fills,
    each warp's group at once: [blocks, rows, 8 warps, 4 gates, 8]; each
    k16 product exact in f64, rounded once to f32 and added in k order, as
    _gate_tiles."""
    acc = torch.zeros(a.shape[0], a.shape[1], 8, 32)
    for f in range(k_tiles // 2):
        fill = ring.take()
        for j in range(2):
            kt = 2 * f + j
            w = fill[:, j][:, GATE_IDX]                       # [8, 4, 16, 8]
            w = w.permute(0, 2, 1, 3).reshape(8, 16, 32).double()
            acc = acc + torch.einsum(
                "brk,wkn->brwn", a[:, :, 16 * kt : 16 * kt + 16].double(), w).float()
    return acc.reshape(a.shape[0], a.shape[1], 8, 4, 8)


def _lstm_layer_split(smem, peer_rows, peer_h, hidden, kx, ks, kh, x, s, out,
                      wpack, bias, t_len, slots, ring):
    """lstm_layer_split<H, KX, KS, KH, S> over clusters of 2 blocks (blocks
    2j, 2j + 1): block d of a pair runs direction d for both, its own 16
    windows as rows 0-15 and its peer's as rows 16-31 of one product per
    weight tile. Each step it copies the peer's x and s rows into
    ``peer_rows`` (P: [blocks, 16 ldP], x at 0, s after 16 KX) and reads
    the peer's h of the previous step from ``peer_h`` (M: [blocks, 2 parities
    x 16 x ldM]); h goes to its own output rows, the peer's output rows and
    M. A warp owns Q = H/64 groups, which it runs one after the other. With
    ``ring`` the kernel's schedule: ``wpack`` the ring's fills (``l*_r``),
    taken by all warps in turn, ldP and ldM per layer; without, the
    schedule before the ring: ``wpack`` the groups' fragment tiles
    (``_gate_fragments``), each warp with its own stream, LD_P and LD_M."""
    groups = hidden // 8
    gpw = groups // 8
    tiles = kx + ks + kh
    ldp, ldm = ((kx + ks) * 16 + 8, hidden + 8) if ring else (LD_P, LD_M)
    flat = wpack.float().reshape(-1)
    r16 = torch.arange(16)
    c = {}
    for d in (0, 1):
        own, peer = slice(d, None, 2), slice(1 - d, None, 2)
        if ring:
            nf = gpw * tiles // 2
            rg = _Ring(flat, d * nf * FILL, nf, t_len, slots)
        else:
            warps = [(w * gpw, _Stream(flat, (d * groups + w * gpw) * tiles * TILE,
                                       gpw * tiles, t_len, slots)) for w in range(8)]
        for st in range(t_len):
            t = t_len - 1 - st if d else st
            tp = t if st == 0 else (t + 1 if d else t - 1)
            cols_x = torch.arange(16 * kx)
            peer_rows[own, (r16[:, None] * ldp + cols_x).reshape(-1)] = smem[
                peer, (x[0] + (t * x[2] + r16[:, None]) * x[1] + cols_x).reshape(-1)]
            if ks:
                cols_s = torch.arange(16 * ks)
                peer_rows[own, (r16[:, None] * ldp + 16 * kx + cols_s).reshape(-1)] = smem[
                    peer, (s[0] + (t * s[2] + r16[:, None]) * s[1] + cols_s).reshape(-1)]
            xa = torch.cat([_rows(smem[own], x[0], x[1], t * x[2] + r16, kx),
                            _rows(peer_rows[own], 0, ldp, r16, kx)], dim=1)
            if ks:
                sa = torch.cat([_rows(smem[own], s[0], s[1], t * s[2] + r16, ks),
                                _rows(peer_rows[own], 16 * kx, ldp, r16, ks)], dim=1)
            ha = torch.cat([_rows(smem[own], out[0] + d * hidden, out[1], tp * KG + r16, kh),
                            _rows(peer_h[own], ((st + 1) % 2) * KG * ldm, ldm, r16, kh)],
                           dim=1)
            ha = torch.zeros_like(ha) if st == 0 else ha
            # the ring: group q of every warp at once, the chains in turn
            for u in sorted(range(groups), key=lambda u: (u % gpw, u // gpw)):
                cols = u * 8 + torch.arange(8)
                b = bias[d * 4 * hidden + hidden * torch.arange(4)[:, None] + cols[None, :]]
                if ring:
                    w_, q = divmod(u, gpw)
                    if w_ == 0:
                        acc_r = _ring_chain(xa, kx, rg)
                        s_r = _ring_chain(sa, ks, rg) if ks else None
                        h_r = _ring_chain(ha, kh, rg)
                    acc = acc_r[:, :, w_] + b
                    if ks:
                        acc = acc + s_r[:, :, w_]
                    z = acc + h_r[:, :, w_]
                else:
                    ws = warps[u // gpw][1]
                    acc = _gate_tiles(xa, kx, ws) + b
                    if ks:
                        acc = acc + _gate_tiles(sa, ks, ws)
                    z = acc + _gate_tiles(ha, kh, ws)
                cq = c.get((d, u), torch.zeros(z.shape[0], 32, 8))
                cq = _hs(z[:, :, 1]) * cq + _hs(z[:, :, 0]) * torch.tanh(z[:, :, 2])
                c[(d, u)] = cq
                h = _bf(_hs(z[:, :, 3]) * torch.tanh(cq))
                idx = (out[0] + (t * KG + r16)[:, None] * out[1] + d * hidden
                       + cols[None, :])
                smem[own, idx.reshape(-1)] = h[:, :16].reshape(h.shape[0], -1)
                smem[peer, idx.reshape(-1)] = h[:, 16:].reshape(h.shape[0], -1)
                m_idx = (st % 2) * KG * ldm + r16[:, None] * ldm + cols[None, :]
                peer_h[own, m_idx.reshape(-1)] = h[:, 16:].reshape(h.shape[0], -1)
        if ring:
            assert rg.taken == rg.total == rg.issued
        else:
            for _, ws in warps:
                assert ws.taken == ws.total and ws.requested == ws.total + ws.slots - 1


def _fragment_tiles(w):
    """The split layers' gate tiles in the order before the ring:
    [2 directions, H/8 groups, tiles, 2, 32, 8] of one model (bf16 row-major
    weights ``w``), as ``pack_full_weights`` packs layer 1."""
    segs = {
        "l2": (rk.H2, lambda d: (w["wi2"][d], w["wh2"][d])),
        "l3": (rk.H3, lambda d: (w["wi3"][d], w["wi3s"][:, 512 * d : 512 * d + 512],
                                 w["wh3"][d])),
        "l4": (rk.H4, lambda d: (w["wi4"][d], w["wh4"][d])),
    }
    return {k: torch.tensor(np.stack([rk._gate_fragments(
        [x.float().numpy() for x in seg(d)], hidden) for d in (0, 1)]))
        for k, (hidden, seg) in segs.items()}


def _read_dense(packed):
    """Row-major [16 NK, 8 NT] of a packed product [NT, NK, 32, 4] as
    tile_mma reads it: lane's uint2 at nt*NK*32 + kt*32 + lane."""
    n_nt, n_kt = packed.shape[:2]
    flat = packed.float().reshape(-1)
    nt, kt, lane, j = torch.meshgrid(torch.arange(n_nt), torch.arange(n_kt),
                                     torch.arange(32), torch.arange(4),
                                     indexing="ij")
    out = torch.empty(16 * n_kt, 8 * n_nt)
    out[16 * kt + _lane_k(lane, j), 8 * nt + lane // 4] = flat[
        ((nt * n_kt + kt) * 32 + lane) * 4 + j]
    return out


def _dense(a, w):
    """a [blocks, rows, 16 NK] @ w [16 NK, N], k16 tile by k16 tile."""
    acc = torch.zeros(a.shape[0], a.shape[1], w.shape[1])
    for kt in range(w.shape[0] // 16):
        acc = acc + a[..., 16 * kt : 16 * kt + 16] @ w[16 * kt : 16 * kt + 16]
    return acc


def _emulate_windows(kw, feats, sig, t_len, schedule="ring"):
    """Logits [M, n, 6] and probs [M, n] of the stack_windows kernel's
    schedule (windows past n stay NaN, as the kernel never writes them):
    "ring" (the kernel's) blocks in pairs, layers 2-4 split by direction
    and fed by the producer's ring; "split" the same split with per-warp
    streams of the fragment tiles (the schedule before the ring);
    "unsplit" every layer per block."""
    cluster = 1 if schedule == "unsplit" else CLUSTER
    n_models, n = sig.shape[0], sig.shape[1]
    n_blk = -(-n // (KG * cluster)) * cluster     # whole clusters, padded
    a_sz, b_sz, s_sz = (t_len * KG * ld for ld in (LD_L3, LD_L2, LD_X))
    off_a, off_b, off_s = 0, a_sz, a_sz + b_sz
    off_f = off_a + t_len * KG * LD_L1          # the features, past layer 1's out
    assert off_f + t_len * KG * LD_F <= off_b
    rows = t_len * KG
    assert 2 * rows * (LD_H1 + LD_H2) + 4 * rows * 8 + 4 * 16 * KG <= 2 * a_sz
    logits = torch.full((n_models, n, 6), float("nan"))
    pad = n_blk * KG - n
    f = torch.nn.functional.pad(_bf(feats), (0, 10, 0, 0, 0, pad))  # k to 16
    for m in range(n_models):
        smem = torch.full((n_blk, a_sz + b_sz + s_sz), float("nan"))
        s = torch.nn.functional.pad(_bf(sig[m]), (0, 0, 0, 0, 0, pad))
        # [blocks, window, t, k] -> rows [t][window] of ld LD_X / LD_F
        r = torch.arange(KG)[:, None, None]
        t = torch.arange(t_len)[None, :, None]
        smem[:, off_s + (t * KG + r) * LD_X + torch.arange(64)] = s.reshape(
            n_blk, KG, t_len, 64)
        smem[:, off_f + (t * KG + r) * LD_F + torch.arange(16)] = f.reshape(
            n_blk, KG, t_len, 16)
        w = {k: v[m] for k, v in kw.items()}
        frags = _fragment_tiles(w) if schedule != "ring" else {}
        x_f, x_s = (off_f, LD_F, KG), (off_s, LD_X, KG)
        layers = (
            (rk.H1, 1, 0, 1, x_f, (off_a, LD_L1), "l1", "b1"),
            (rk.H2, 2, 0, 4, (off_a, LD_L1, KG), (off_b, LD_L2), "l2", "b2"),
            (rk.H3, 8, 4, 8, (off_b, LD_L2, KG), (off_a, LD_L3), "l3", "b3"),
            (rk.H4, 16, 0, 4, (off_a, LD_L3, KG), (off_b, LD_L4), "l4", "b4"),
        )
        peer_rows = torch.full((n_blk, KG * LD_P), float("nan"))
        peer_h = torch.full((n_blk, 2 * KG * LD_M), float("nan"))
        for li, (hidden, kx, ks, kh, x, out, key, bkey) in enumerate(layers):
            tiles = w["l1_f"] if li == 0 else (
                w[key + "_r"] if schedule == "ring" else frags[key])
            if schedule == "unsplit" or li == 0:
                _lstm_layer(smem, hidden, kx, ks, kh, x, x_s, out, tiles,
                            w[bkey].reshape(-1), t_len, SLOTS)
            else:
                ring = schedule == "ring"
                _lstm_layer_split(smem, peer_rows, peer_h, hidden, kx, ks, kh, x,
                                  x_s, out, tiles, w[bkey].reshape(-1), t_len,
                                  RING_SLOTS if ring else SLOTS, ring)
        # the heads over the 16T rows [t][window] of layer 4's output
        r_all = torch.arange(rows)
        l4 = _rows(smem, off_b, LD_L4, r_all, 8)
        h1 = _bf(torch.relu(_dense(l4, _read_dense(w["d1_f"])) + w["d1b"]))
        h2 = _bf(torch.relu(_dense(h1, _read_dense(w["d2_f"])) + w["d2b"]))
        mo = _bf(torch.relu(_dense(h2, _read_dense(w["mo_f"])[:, :6]) + w["mob"]))
        mo = mo.reshape(n_blk, t_len, KG, 6)
        fw = w["fw"].float()                                  # [T, 6, 16]
        facc = torch.zeros(n_blk, KG, 16)
        for tt in range(t_len):
            for cl in range(6):
                facc = facc + mo[:, tt, :, cl, None] * fw[tt, cl]
        fe = _bf(torch.relu(facc + w["fb"]))
        fow = w["fow"].float()
        lg = torch.zeros(n_blk, KG, 6)
        for k in range(16):
            lg = lg + fe[:, :, k, None] * fow[k]
        logits[m] = (lg + w["fob"]).reshape(-1, 6)[:n]
    return logits, rk.max_prob(logits)


@pytest.mark.parametrize("n_models", [1, 2])
@pytest.mark.parametrize("t", [11, 13])
@pytest.mark.parametrize("n", [5, 33])
def test_kernel_schedule_emulation_matches_bf16_plain(n_models, t, n):
    """The kernel's schedule (clusters of 2, layers 2-4 split) against the
    bf16 plain version; n = 5 and 33 leave the last cluster one valid
    block."""
    kw = rk.kernel_weights(_stacked(t, seed=40 + t, n_models=n_models), "cpu")
    feats, sig = _inputs(n, t, n_models, seed=100 * t + n)
    got_l, got_p = _emulate_windows(kw, feats, sig, t)
    want_l, want_p = rk.stack_windows_plain(kw, feats, sig, t_len=t,
                                            want_probs=True, bf16=True)
    for m, nc in enumerate((6, 5)[:n_models]):
        assert not torch.isnan(got_l[m]).any()
        assert float((got_l[m, :, :nc] - want_l[m, :, :nc]).abs().max()) <= 0.05
    assert float((got_p - want_p).abs().max()) <= 0.05
    # the logits vary across windows (the check is not vacuous)
    assert float(got_l[0].std(0).min()) > 1e-3


_UNSPLIT = {}


@pytest.mark.parametrize("schedule", ["ring", "split"])
@pytest.mark.parametrize("n_models,t,n", [(1, 11, 1), (2, 11, 17), (1, 13, 32),
                                          (2, 13, 48)])
def test_split_schedule_bit_identical_to_unsplit(n_models, t, n, schedule):
    """Splitting layers 2-4 over a cluster of 2 blocks changes no product,
    no k order and no rounding of any (window, unit), with the producer's
    ring (the kernel's schedule) or per-warp streams (the one before it):
    the logits and probs equal the unsplit schedule's bit for bit, for one
    block (its cluster padded with an empty one), a block and one window,
    two whole blocks and three (the last cluster one valid block)."""
    kw = rk.kernel_weights(_stacked(t, seed=60 + t, n_models=n_models), "cpu")
    feats, sig = _inputs(n, t, n_models, seed=7 * t + n)
    split_l, split_p = _emulate_windows(kw, feats, sig, t, schedule)
    key = (n_models, t, n)       # the same inputs for both schedules
    if key not in _UNSPLIT:
        _UNSPLIT[key] = _emulate_windows(kw, feats, sig, t, "unsplit")
    whole_l, whole_p = _UNSPLIT[key]
    assert not torch.isnan(split_l).any()
    assert torch.equal(split_l, whole_l) and torch.equal(split_p, whole_p)
