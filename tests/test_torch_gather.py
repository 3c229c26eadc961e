"""Port window gather (plain version) vs the JAX package, bit for bit (CPU).

The same rows go through the port's ``window_gather_plain`` (per-row pos0,
vlen, read_id) and through the JAX package's ``window_gather_xla`` and the
TPU kernel ``window_gather_tpu`` in interpret mode (block meta packed by
``pack_block_meta``). The bf16 outputs must be identical bit for bit,
covering vlen < 50, indices clipped at the buffer ends, and rows past
nvalid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanoreviser_tpu.ops.window_gather import (
    BLK,
    pack_block_meta,
    pack_read_tables,
    window_gather_tpu,
    window_gather_xla,
)
from nanoreviser_torch.infer.wire import pack_read_tables as port_read_tables
from nanoreviser_torch.ops.window_gather import (
    QP,
    WINDOW_GATHER,
    window_gather,
    window_gather_plain,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _rows(n_rows, s_cap, seed, lo=64):
    rng = np.random.default_rng(seed)
    pos0 = (lo + np.cumsum(rng.integers(1, 46, n_rows))).astype(np.int32)
    vlen = rng.integers(1, 51, n_rows).astype(np.int32)
    vlen[rng.random(n_rows) < 0.5] = 50
    read_id = np.minimum(np.arange(n_rows) // (n_rows // 5), 4).astype(np.int32)
    shifts = rng.uniform(380, 520, 5).astype(np.float32)
    scales = rng.uniform(8, 60, 5).astype(np.float32)
    sig = rng.integers(-1500, 1500, s_cap, dtype=np.int16)
    return sig, pos0, vlen, read_id, shifts, scales


def _port(sig, pos0, vlen, read_id, shifts, scales, rows_valid):
    tabs = torch.from_numpy(port_read_tables(shifts, scales).view(np.int16)).view(
        torch.bfloat16).float()
    shift = (tabs[0] + tabs[1]) + tabs[2]
    scale = (tabs[3] + tabs[4]) + tabs[5]
    t = torch.from_numpy
    return window_gather(t(sig), t(pos0), t(vlen), t(read_id), shift, scale,
                         rows_valid)


def _bits(x):
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("nvalid_blocks", [4, 3])
def test_plain_gather_bit_exact_with_xla_and_tpu_interpret(nvalid_blocks):
    n_rows, s_cap = 4 * BLK, 32 * 1024
    sig, pos0, vlen, read_id, shifts, scales = _rows(n_rows, s_cap, seed=nvalid_blocks)
    csr, rr, meta = pack_block_meta(pos0, vlen.astype(np.uint8),
                                    read_id.astype(np.uint8), s_cap)
    tabs = pack_read_tables(shifts, scales)
    args = (jnp.asarray(sig[::-1].copy()), jnp.asarray(csr), jnp.asarray(rr),
            jnp.asarray(np.array([nvalid_blocks], np.int32)), jnp.asarray(meta),
            jnp.asarray(tabs))
    want_xla = np.asarray(window_gather_xla(*args, n_rows=n_rows))
    want_tpu = np.asarray(window_gather_tpu(*args, n_rows=n_rows, interpret=True))
    before = WINDOW_GATHER.launches
    got = _port(sig, pos0, vlen, read_id, shifts, scales, nvalid_blocks * BLK)
    assert WINDOW_GATHER.launches == before          # CPU: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (n_rows, QP)
    got_bits = _bits(got.view(torch.int16).numpy())
    np.testing.assert_array_equal(got_bits, _bits(want_xla)[:, :QP])
    np.testing.assert_array_equal(got_bits, _bits(want_tpu)[:, :QP])
    assert not got_bits[nvalid_blocks * BLK :].any()
    assert got_bits[: nvalid_blocks * BLK].any()
    assert (vlen < 50).any()


def test_plain_gather_clips_indices_like_xla():
    """Windows hanging off either end of the signal buffer read the clamped
    edge sample, exactly as the JAX fallback does."""
    n_rows, s_cap = 2 * BLK, 4 * 1024
    sig, pos0, vlen, read_id, shifts, scales = _rows(n_rows, s_cap, seed=9, lo=0)
    pos0 = (pos0 - 40).astype(np.int32)             # first rows start < 0
    pos0[-3:] = [s_cap - 30, s_cap - 10, s_cap - 1]  # last rows run past the end
    vlen[-3:] = 50
    from nanoreviser_tpu.ops.window_gather import window_gather_xla_f32

    # the XLA fallback takes block meta; rebuild it around the negative starts
    csr, rr, meta = _meta_any_span(pos0, vlen, read_id, s_cap)
    want = np.asarray(window_gather_xla_f32(
        jnp.asarray(sig[::-1].copy()), jnp.asarray(csr), jnp.asarray(rr),
        jnp.asarray(np.array([n_rows // BLK], np.int32)), jnp.asarray(meta),
        jnp.asarray(pack_read_tables(shifts, scales)), n_rows=n_rows))
    tabs = torch.from_numpy(port_read_tables(shifts, scales).view(np.int16)).view(
        torch.bfloat16).float()
    t = torch.from_numpy
    got = window_gather_plain(t(sig), t(pos0), t(vlen), t(read_id),
                              (tabs[0] + tabs[1]) + tabs[2],
                              (tabs[3] + tabs[4]) + tabs[5], n_rows,
                              out_dtype=torch.float32, width=50)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert pos0.min() < 0 and pos0.max() + 50 > s_cap


def _meta_any_span(pos0, vlen, read_id, s_cap):
    """pack_block_meta's arithmetic without its DMA-range checks (the XLA
    fallback has no DMA, so negative or overhanging starts are legal)."""
    from nanoreviser_tpu.ops.window_gather import ALIGN, CHUNK, DMA_LEN, META_ROWS

    nb = len(pos0) // BLK
    p = pos0.reshape(nb, BLK)
    fine = p.min(axis=1)
    cs = fine & ~(ALIGN - 1)
    csr = (s_cap - cs - DMA_LEN).astype(np.int32)
    rr = (CHUNK + (fine - cs)).astype(np.int32)
    relr = ((CHUNK - 1) - (p - fine[:, None])).astype(np.int32)
    meta = np.empty((nb, META_ROWS, 128), np.int32)
    meta[:, 0] = relr | (vlen.reshape(nb, BLK) << 13) | (read_id.reshape(nb, BLK) << 19)
    return csr, rr, meta
