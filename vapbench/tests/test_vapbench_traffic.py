"""Seeded traffic: the same seed gives the same frames, batches and
weights; another seed gives others."""

import numpy as np
import torch

from vapbench.audio import StreamAudio, train_batches
from vapbench.common import load_config, sub_seed
from vapbench.weights import make_params, tree_leaves

A = {"clips": 3, "seconds": 4, "spurt_s": 1.2, "pause_s": 0.8,
     "min_s": 0.2, "gain_db": [-30, -6], "pitch_hz": [90, 260]}
BIG = 2 ** 33 + 12345          # seeds past 32 bits


def _frames(seed, ticks=(0, 1, 7, 90)):
    au = StreamAudio(A, 6, 800, seed, "cpu")
    out = []
    for k in ticks:
        buf = torch.empty((6, 2, 800), dtype=torch.int16)
        au.fill(k, buf)
        out.append(buf.numpy().copy())
    return np.stack(out), au


def test_same_seed_same_frames():
    a, au = _frames(BIG)
    b, _ = _frames(BIG)
    assert np.array_equal(a, b)
    c, _ = _frames(BIG + 1)
    assert not np.array_equal(a, c)
    # the history the reference reads is what the frames carried
    h = au.history(3, 8)
    assert np.array_equal(h[:, 7 * 800:8 * 800], a[2, 3])


def test_frames_look_like_speech():
    a, _ = _frames(BIG, ticks=range(80))
    x = a.astype(np.float64)
    rms = np.sqrt((x ** 2).reshape(80, 6, 2, -1).mean(-1))
    assert 30 < np.median(rms) < 20000
    # talk spurts and pauses: loud and quiet frames on every channel
    assert (rms.max(0) / rms.min(0)).min() > 5


def test_same_seed_same_batches():
    kw = dict(n_batches=2, batch=2, seconds=2.0, frame_hz=20,
              horizon_s=2.0, device="cpu")
    a = train_batches(A, seed=sub_seed(BIG, 5), **kw)
    b = train_batches(A, seed=sub_seed(BIG, 5), **kw)
    c = train_batches(A, seed=sub_seed(BIG + 1, 5), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x["waveform"], y["waveform"])
        assert torch.equal(x["vad"], y["vad"])
    assert not torch.equal(a[0]["waveform"], c[0]["waveform"])
    assert a[0]["vad"].shape == (2, 80, 2)
    v = a[0]["vad"]
    assert 0.2 < float(v.mean()) < 0.9      # both talk, not always


def test_same_seed_same_weights():
    model = load_config("vap_jp_20hz_2500ms")["model"]
    a = dict(tree_leaves(make_params(model, BIG, "cpu", torch.bfloat16)))
    b = dict(tree_leaves(make_params(model, BIG, "cpu", torch.bfloat16)))
    c = dict(tree_leaves(make_params(model, BIG + 1, "cpu", torch.bfloat16)))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["ar/layers/0#/attn/q"],
                              c["ar/layers/0#/attn/q"])
    w = a["ar/layers/0#/attn/q"]
    # exact in bf16
    assert np.array_equal(torch.from_numpy(w).bfloat16().float().numpy(), w)
    assert abs(w.std() - 256 ** -0.5) < 0.01
