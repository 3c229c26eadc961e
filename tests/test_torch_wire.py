"""Port batch assembly and wire decode vs the JAX package (CPU).

One batch of synthetic reads is assembled by the port engine and by the JAX
engine (``use_pallas=False``): the finalized upload arrays must be
byte-identical. The port's torch ``decode_wire`` must then reproduce the
JAX decode exactly: forward signal, per-row pos0 / vlen / read_id (which
JAX packs into its TPU block meta), per-read shift / scale, and features.
The reads exercise the signal, vlen, duration and color escapes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanoreviser_tpu.infer import StreamingReviser as JaxReviser
from nanoreviser_tpu.infer import wire as jwire
from nanoreviser_tpu.io import get_read_data as jax_get_read_data
from nanoreviser_tpu.ops.window_gather import BLK, CHUNK, DMA_LEN
from nanoreviser_tpu.signal.host_prep import compact_read_numpy as jax_compact
from nanoreviser_torch.infer import StreamingReviser
from nanoreviser_torch.infer import wire as twire
from nanoreviser_torch.io import get_read_data
from nanoreviser_torch.io.synthetic import write_synthetic_dir
from nanoreviser_torch.models import ReviserConfig, init_reviser_params, save_keras_weights
from nanoreviser_torch.signal import compact_read_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (fixture)

BATCH, BLOCK = 2048, 128


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("wire")
    names = write_synthetic_dir(d / "fast5", 6, (150, 350), seed=11)
    paths = []
    for k, nc in enumerate((6, 5)):
        p = init_reviser_params(torch.Generator().manual_seed(k),
                                ReviserConfig(window=11, n_classes=nc))
        paths.append(str(d / f"m{k}.h5"))
        save_keras_weights(p, paths[-1], 11, nc)
    reads = [os.path.join(d, "fast5", n) for n in names]
    return paths, reads


def _batches(setup):
    paths, reads = setup
    te = StreamingReviser(*paths, batch_windows=BATCH, block=BLOCK, device="cpu")
    je = JaxReviser(*paths, batch_windows=BATCH, block=BLOCK, use_pallas=False,
                    devices=jax.devices()[:1])
    tb, jb = te._new_batch(), je._new_batch()
    for p in reads:
        wt = twire.encode_read(compact_read_numpy(get_read_data(p)))
        wj = jwire.encode_read(jax_compact(jax_get_read_data(p)))
        assert te._add_read(tb, p, None, wt) and je._add_read(jb, p, None, wj)
    assert te.top.__dict__ == je.top.__dict__
    return te, te._finalize(tb, te.top), je._finalize(jb, je.top)


def test_finalized_batch_is_byte_identical(setup):
    _, tp, jp = _batches(setup)
    assert list(tp) == list(jp)
    for k in tp:
        a, b = np.asarray(tp[k]), np.asarray(jp[k])
        assert a.shape == b.shape and a.itemsize == b.itemsize, k
        assert a.tobytes() == b.tobytes(), k
    # every escape list is in use
    drop = int(twire.DROP)
    for k in ("sig_esc_idx", "vlen_esc_idx", "dur_esc_idx", "col_esc_idx"):
        assert (tp[k] != drop).sum() > 0, k


def test_torch_decode_matches_jax_decode(setup):
    te, tp, jp = _batches(setup)
    tier = te.top
    kw = dict(s_cap=tier.s_cap, n_rows=tier.n_rows, n_rows_g=tier.n_rows_g)
    d = twire.decode_wire(twire.wire_to_tensors(tp), **kw)
    sigr, csr, rr, meta, feats = jwire.decode_wire(
        {k: jnp.asarray(v) for k, v in jp.items()}, **kw)
    sigr, csr, rr = np.asarray(sigr), np.asarray(csr), np.asarray(rr)
    meta = np.asarray(meta)[:, 0, :]
    np.testing.assert_array_equal(d.sig.numpy(), sigr[::-1])
    # unpack the JAX block meta (ops/window_gather.py:208-224)
    fine = (tier.s_cap - csr - DMA_LEN) + (rr - CHUNK)
    pos0 = (np.repeat(fine, BLK) + (CHUNK - 1) - (meta & 0x1FFF).reshape(-1))
    np.testing.assert_array_equal(d.pos0.numpy(), pos0)
    np.testing.assert_array_equal(d.vlen.numpy(), ((meta >> 13) & 63).reshape(-1))
    np.testing.assert_array_equal(d.read_id.numpy(), ((meta >> 19) & 255).reshape(-1))
    assert d.feats.dtype == torch.float32
    np.testing.assert_array_equal(d.feats.numpy(), np.asarray(feats))
    tabs = np.asarray(jnp.asarray(jp["tabs"]).astype(jnp.float32))
    np.testing.assert_array_equal(d.shift.numpy(), (tabs[0] + tabs[1]) + tabs[2])
    np.testing.assert_array_equal(d.scale.numpy(), (tabs[3] + tabs[4]) + tabs[5])
    # the 3-term bf16 split rebuilds each read's f32 shift exactly
    shifts = [compact_read_numpy(get_read_data(p)).shift for p in setup[1]]
    np.testing.assert_array_equal(d.shift.numpy()[: len(shifts)],
                                  np.asarray(shifts, np.float32))


def test_scatter_drops_out_of_range_indices():
    dst = torch.zeros(5, dtype=torch.int32)
    idx = torch.tensor([1, int(twire.DROP), 4, 5], dtype=torch.int32)
    val = torch.tensor([7, 8, 9, 10], dtype=torch.int32)
    out = twire._scatter_drop(dst, idx, val)
    assert out.tolist() == [0, 7, 0, 0, 9]
