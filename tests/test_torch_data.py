"""The port's training data pipeline against the JAX package's: the
same manifest (rows, WAVs), the same onehot VAD, and the same batches
bit for bit for the same seed and epoch, flips and shuffles included."""

import os

import numpy as np
import pytest

from vap_realtime_tpu.train import data as jdata
from vap_realtime_tpu_torch.train import data as tdata


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    t = tmp_path_factory.mktemp("port")
    j = tmp_path_factory.mktemp("jax")
    return (tdata.synthetic_manifest(str(t), n_rows=5, duration=2.0),
            jdata.synthetic_manifest(str(j), n_rows=5, duration=2.0))


def test_synthetic_manifest_equals_jax(manifests):
    tp, jp = manifests
    rows_t, rows_j = tdata.load_manifest(tp), jdata.load_manifest(jp)
    assert len(rows_t) == len(rows_j) == 5
    for a, b in zip(rows_t, rows_j):
        assert a["vad_list"] == b["vad_list"]
        assert (a["start"], a["end"]) == (b["start"], b["end"])
        with open(a["audio_path"], "rb") as fa, \
                open(b["audio_path"], "rb") as fb:
            assert fa.read() == fb.read()
        assert os.path.dirname(a["audio_path"]) != os.path.dirname(
            b["audio_path"])


def test_vad_list_to_onehot_equals_jax():
    vl = [[[0.0, 0.5], [0.73, 1.9]], [[0.25, 1.0]]]
    for hz in (10, 20, 50):
        np.testing.assert_array_equal(
            tdata.vad_list_to_onehot(vl, 2.5, hz),
            jdata.vad_list_to_onehot(vl, 2.5, hz))


@pytest.mark.parametrize("train", [True, False])
def test_loader_batches_bit_equal_jax(manifests, train):
    path = manifests[1]
    kw = dict(batch_size=2, audio_duration=2.0, frame_hz=20)
    tl = tdata.VapDataLoader(path, tdata.DataConfig(**kw), shuffle=train,
                             train=train, seed=3)
    jl = jdata.VapDataLoader(path, jdata.DataConfig(**kw), shuffle=train,
                             train=train, seed=3)
    assert len(tl) == len(jl) == 2
    for epoch in (0, 4):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == 2
        for a, b in zip(tb, jb):
            assert a.keys() == b.keys() == {"waveform", "vad"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert tb[0]["waveform"].shape == (2, 2, 32000)
        assert tb[0]["vad"].shape == (2, 80, 2)


def test_flip_channels_equals_jax():
    rs = np.random.RandomState(0)
    batch = {"waveform": rs.randn(4, 2, 50).astype(np.float32),
             "vad": (rs.rand(4, 7, 2) > 0.5).astype(np.float32)}
    mask = np.array([True, False, True, False])
    got, want = (tdata.flip_channels(batch, mask),
                 jdata.flip_channels(batch, mask))
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["waveform"][0],
                                  batch["waveform"][0, ::-1])
