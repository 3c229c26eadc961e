"""The frozen operation and byte counts, pinned against a hand count from
NanoReviser's published widths."""

import json
import os

import pytest

from portbench import yardstick

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")


def _cfg(t):
    with open(os.path.join(CONFIGS, f"nanoreviser-t{t}.json")) as fp:
        return json.load(fp)


def test_per_row_by_hand():
    # conv1 1->8 and conv2 8->8 over 50 samples, kernel 3; Dense 400->64;
    # features 6 -> 2 directions x 4 gates x 16; signal 64 -> 2 x 4 x 128
    hand = 50 * 3 * 8 + 50 * 3 * 64 + 400 * 64 + 6 * 128 + 64 * 1024
    assert hand == 102_704
    assert yardstick.row_macs(_cfg(11)) == hand == yardstick.row_macs(_cfg(13))


@pytest.mark.parametrize("t", [11, 13])
def test_per_window_by_hand(t):
    recurrent = 2 * (16 * 64 + 64 * 256 + 128 * 512 + 64 * 256)      # 198,656
    inputs = 2 * (32 * 256 + 128 * 512 + 256 * 256)                   # 278,528
    heads = 128 * 128 + 128 * 32 + 32 * 6 + 6 * 16                   # 20,768
    assert (recurrent, inputs, heads) == (198_656, 278_528, 20_768)
    for nc in (6, 5):
        assert yardstick.window_macs(_cfg(t), nc) == 497_952 * t + 16 * nc


@pytest.mark.parametrize("t,mflop", [(11, 22.32), (13, 26.30)])
def test_flops_per_window(t, mflop):
    """Both models, one base row and one window: 22.32 MFLOP at T = 11,
    26.30 at T = 13."""
    assert round(yardstick.model_flops(_cfg(t), 1, 1) / 1e6, 2) == mflop


def test_read_work_and_bytes():
    cfg = _cfg(11)
    assert yardstick.read_work(cfg, 1000) == (989, 999)
    assert yardstick.read_work(cfg, 11) == (0, 0)
    w6, w5 = (yardstick.weight_count(cfg, nc) for nc in (6, 5))
    assert w6 - w5 == 17                      # final_out: 16 weights + 1 bias
    # conv 24+8+192+8, Dense 25,600+64, 5 BNs, 4 Bi-LSTMs, the heads
    lstm = 2 * (6 * 64 + 16 * 64 + 64) + 2 * (32 * 256 + 64 * 256 + 256) \
        + 2 * (192 * 512 + 128 * 512 + 512) + 2 * (256 * 256 + 64 * 256 + 256)
    heads = 128 * 128 + 128 + 128 * 32 + 32 + 32 * 6 + 6 + 66 * 16 + 16 + 16 * 6 + 6
    assert w6 == 24 + 8 + 192 + 8 + 25_664 + 4 * (8 + 8 + 32 + 128 + 256) + lstm + heads
    b = yardstick.stack_bytes(cfg, windows=989, rows=999, launches=1)
    assert b == 999 * 2 * 56 + 2 * (w6 + w5) + 989 * 4 * 11
    # a full batch of 191,232 windows is bound by its operations: 4.32 ms
    f = yardstick.model_flops(cfg, 191_232, 191_232)
    least = yardstick.least_seconds(f, yardstick.stack_bytes(cfg, 191_232, 191_242, 1))
    assert round(least * 1e3, 2) == 4.32
