"""The counts module against hand counts (PERF.md's kernel table)."""

import json
import os

import pytest

from vapbench.common import HERE
from vapbench.counts import attend_pair, conv_stack_fused, lstm_scan, model

PEAKS = json.load(open(os.path.join(HERE, "peaks.json")))


def test_k2_bytes_give_the_tables_bound():
    # B=4096, T=50, S=8, bf16: ring 419.4 MB, stage 67.1 MB, ages 0.95 MB,
    # q / k / v / out 16.8 MB -> 0.1505 ms at 3.35 TB/s
    b = attend_pair.launch_bytes(4096, 50, 8)
    assert b == (4096 * 50 * 1024 * 2 + 8 * 4096 * 1024 * 2
                 + (4096 * 50 + 8 * 4096) * 4 + 4 * 4096 * 2 * 256 * 2)
    assert attend_pair.bound_s(4096, 50, 8, PEAKS) * 1e3 == pytest.approx(
        0.1505, abs=5e-5)


def test_k7_operations():
    # per channel-stream of 800 samples: conv0 160 x 256 x 10, conv1 40 x
    # 256 x 256 x 8, conv2-4 20 / 10 / 5 x 256 x 256 x 4 multiply-adds
    per = 2 * (160 * 256 * 10 + 40 * 256 * 256 * 8
               + (20 + 10 + 5) * 256 * 256 * 4)
    assert conv_stack_fused.call_ops(1, 800) == per
    assert conv_stack_fused.call_ops(8192, 800) / 1e12 == pytest.approx(
        0.501, abs=5e-4)


def test_k5_operations():
    assert lstm_scan.call_ops(16, 1998) / 1e9 == pytest.approx(50.28,
                                                               abs=5e-3)
    assert lstm_scan.bound_s(16, 1998, PEAKS) * 1e3 == pytest.approx(
        0.1016, abs=5e-5)


def test_tick_flops_by_hand():
    m = {"dim": 256, "encoder_dim": 256, "dff_k": 3, "channel_layers": 1,
         "cross_layers": 3, "mode": "vap", "frame_hz": 20,
         "context_len_sec": 2.5}
    D, T = 256, 50
    enc = conv_stack_fused.call_ops(1, 800) + 5 * 2 * 2 * 256 * 1024 \
        + 2 * 256 * 256 * 5
    lin, att, ffn = 8 * D * D, 4 * T * D, 4 * D * 768
    trunk = 2 * (lin + att + ffn) + 6 * (2 * (lin + att) + ffn)
    heads = 4 * D * D + 2 * D * 256 + 4 * D
    assert model.tick_flops(m, 1) == 2 * enc + trunk + heads
    assert model.tick_flops(m, 10) == 10 * model.tick_flops(m, 1)


def test_train_frames():
    # 20 s at 16 kHz: 2000 CPC frames, 1998 after the trim, 399 at 20 Hz
    assert model._conv_frames(320000)[-1] == 2000
    assert model.train_frames(320000, 20) == 399
