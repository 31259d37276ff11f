"""PyTorch port: the offline CSV runner and its WAV IO, on WAVs of the
20 Hz golden stream (the shape of tests/test_serving.py:23-52): against
the golden (loosely: the 16-bit WAV quantises the input) and against the
JAX package's `run_offline` on the same WAV audio at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden_stream
from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.runtime.offline import run_offline as jax_run_offline
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io.audio import read_wav, write_wav
from vap_realtime_tpu_torch.runtime.offline import main, run_offline
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_wav_roundtrip(tmp_path):
    rs = np.random.RandomState(0)
    data = np.clip(rs.randn(1600, 2) * 0.1, -1, 1).astype(np.float32)
    p = str(tmp_path / "x.wav")
    write_wav(p, data, 16000)
    back, rate = read_wav(p)
    assert rate == 16000 and back.shape == (1600, 2)
    np.testing.assert_allclose(back, data, atol=1.0 / 32768)


@pytest.fixture(scope="module")
def golden_wavs(tmp_path_factory):
    golden = load_golden_stream("stream_vap_20hz.npz")
    tmp = tmp_path_factory.mktemp("offline")
    left, right = str(tmp / "l.wav"), str(tmp / "r.wav")
    write_wav(left, golden["audio"][0], 16000)
    write_wav(right, golden["audio"][1], 16000)
    return golden, left, right, tmp


@pytest.mark.parametrize("path", ["full", "kv", "fast", "hybrid",
                                  "fast_hybrid"])
def test_offline_main_matches_jax_and_golden(golden_wavs, path):
    """main(--engine_path path --device cpu) writes the reference CSV;
    every row equals the JAX runner's on the same WAV audio at 1e-4; the
    full path also matches the golden at 2e-2 (WAV quantisation) and its
    timestamps at 1e-6."""
    golden, left, right, tmp = golden_wavs
    out_csv = str(tmp / f"{path}.csv")
    main(["--input_wav_left", left, "--input_wav_right", right,
          "--filename_output", out_csv, "--vap_process_rate", "20",
          "--context_len_sec", "2.5", "--synthetic_weights",
          "--engine_path", path, "--device", "cpu"])
    with open(out_csv) as f:
        assert f.readline() == ("time_sec,p_now(0=left),p_now(1=right),"
                                "p_future(0=left),p_future(1=right)\n")
    rows = np.loadtxt(out_csv, delimiter=",", skiprows=1)
    audio = np.stack([read_wav(left)[0], read_wav(right)[0]])
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(20))
    want = jax_run_offline(jp, audio, JaxConfig(frame_hz=20), path,
                           attend_impl="pallas" if path == "fast"
                           else "einsum")
    assert rows.shape == (len(want["t"]), 5)
    np.testing.assert_allclose(rows[:, 0], want["t"], atol=1e-9)
    np.testing.assert_allclose(rows[:, 1:3], want["p_now"], atol=1e-4)
    np.testing.assert_allclose(rows[:, 3:5], want["p_future"], atol=1e-4)
    if path == "full":
        assert rows.shape[0] == golden["p_now"].shape[0]
        np.testing.assert_allclose(rows[:, 1:3], golden["p_now"], atol=2e-2)
        np.testing.assert_allclose(rows[:, 0], golden["t"], atol=1e-6)


def test_hybrid_paths_raise():
    """The hybrid paths, refused before slice 5, now run: one row per
    frame, with the framing of their incremental twins; an unknown path
    raises."""
    audio = np.zeros((2, 4000), np.float32)
    for path, twin in (("hybrid", "kv"), ("fast_hybrid", "fast")):
        got, want = (run_offline(synthetic_params(20), audio, VapConfig(), p,
                                 device="cpu") for p in (path, twin))
        np.testing.assert_array_equal(got["t"], want["t"])
        assert got["p_now"].shape == want["p_now"].shape
    with pytest.raises(ValueError, match="unknown path"):
        run_offline(synthetic_params(20), audio, VapConfig(), "hybrid2",
                    device="cpu")
