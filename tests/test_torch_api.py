"""PyTorch port: the library API `Vap` and its checkpoint names against
the JAX package's `api.py`, and the new entry points' device default."""

import numpy as np
import pytest
import torch

from tests.conftest import load_golden_stream
from vap_realtime_tpu import api as jax_api
from vap_realtime_tpu.io.sources import Wav as JaxWav
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch import api
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io.audio import write_wav
from vap_realtime_tpu_torch.io.sources import Wav
from vap_realtime_tpu_torch.runtime import server, server_batched
from vap_realtime_tpu_torch.runtime.engine import VapEngine
from vap_realtime_tpu_torch.runtime.static import make_static_fn
from vap_realtime_tpu_torch.tools import export_static
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["vap", "vap_MC", "bc", "nod"])
def test_hf_checkpoint_file_matches_jax(mode):
    """The published checkpoints' (repo, file) names equal the JAX
    package's for every language, rate and context; an unknown mode
    raises in both."""
    assert api.HF_REPO_IDS == jax_api.HF_REPO_IDS
    for lang in ("jp", "en", "tri"):
        for hz, sec in ((20, 2.5), (10, 5.0), (20, 3.0)):
            want = jax_api.hf_checkpoint_file(mode, hz, sec, lang)
            assert api.hf_checkpoint_file(mode, hz, sec, lang) == want
    with pytest.raises(ValueError):
        api.hf_checkpoint_file(mode + "_x", 20, 2.5)


def test_vap_matches_jax_vap(tmp_path):
    """Vap(device="cpu") on the kv path, fed by two Wav(realtime=False)
    sources of the 20 Hz stream golden's audio, against the JAX Vap on
    the same WAVs: 10 results each, p_now / p_future / vad at atol 1e-4,
    the audio echo equal (both prepend 320 zero samples), and the worker
    joined after stop_process (a second call is harmless)."""
    golden = load_golden_stream("stream_vap_20hz.npz")
    left, right = str(tmp_path / "l.wav"), str(tmp_path / "r.wav")
    write_wav(left, golden["audio"][0])
    write_wav(right, golden["audio"][1])
    kw = dict(mode="vap", frame_rate=20, context_len_sec=2.5,
              engine_path="kv")
    runs = {}
    for name, vap in (
            ("port", api.Vap(mic1=Wav(left, realtime=False),
                             mic2=Wav(right, realtime=False),
                             params=synthetic_params(20), device="cpu",
                             **kw)),
            ("jax", jax_api.Vap(mic1=JaxWav(left, realtime=False),
                                mic2=JaxWav(right, realtime=False),
                                params=jax_params(20), **kw))):
        vap.start_process()
        try:
            runs[name] = [vap.get_result(timeout=60) if name == "port"
                          else vap.get_result() for _ in range(10)]
        finally:
            worker = vap._thread
            vap.stop_process()
        assert vap._thread is None and not worker.is_alive()
        vap.stop_process()
    assert runs["port"][0].keys() == runs["jax"][0].keys()
    for f, (got, want) in enumerate(zip(runs["port"], runs["jax"])):
        for k in ("p_now", "p_future", "vad"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       err_msg=f"{k} frame {f}")
        np.testing.assert_array_equal(got["x1"], want["x1"])
        assert len(got["x1"]) == 800


def test_vap_fast_path_takes_fresh_chunks(tmp_path):
    """On the fast path the worker cuts disjoint frame_shift chunks with
    no zero prepend (the JAX class cuts overlapped frames for every
    path); the results are the engine's on those chunks."""
    rs = np.random.RandomState(4)
    audio = np.clip(0.1 * rs.randn(2, 4000), -1, 1)
    left, right = str(tmp_path / "l.wav"), str(tmp_path / "r.wav")
    write_wav(left, audio[0])
    write_wav(right, audio[1])
    vap = api.Vap(mode="vap", frame_rate=20, context_len_sec=1.0,
                  mic1=Wav(left, realtime=False),
                  mic2=Wav(right, realtime=False),
                  params=synthetic_params(20), engine_path="fast",
                  device="cpu")
    assert (vap.audio_frame_size, vap.frame_contxt_padding) == (800, 0)
    vap.start_process()
    try:
        got = [vap.get_result(timeout=60) for _ in range(3)]
    finally:
        vap.stop_process()
    ref = VapEngine(VapConfig(frame_hz=20, context_len_sec=1.0),
                    params=synthetic_params(20), path="fast", device="cpu")
    for f, r in enumerate(got):
        chunk = Wav(left, realtime=False).data[f * 800:(f + 1) * 800]
        np.testing.assert_array_equal(r["x1"], chunk)
        x2 = Wav(right, realtime=False).data[f * 800:(f + 1) * 800]
        np.testing.assert_allclose(r["p_now"],
                                   ref.process(chunk, x2)["p_now"],
                                   atol=1e-6)


@pytest.mark.parametrize("entry", ["Vap", "make_static_fn", "export",
                                   "server", "server_batched"])
def test_new_entry_points_default_to_cuda(entry):
    """Each new entry point runs on the card unless given the CPU: on a
    machine without CUDA it raises instead of falling back."""
    if torch.cuda.is_available():
        return
    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    call = {
        "Vap": lambda: api.Vap(mode="vap", frame_rate=20,
                               context_len_sec=1.0,
                               params=synthetic_params(20)),
        "make_static_fn": lambda: make_static_fn(cfg, 8),
        "export": lambda: export_static.export_artifact(
            synthetic_params(20), cfg, 8),
        "server": lambda: server.main(["--synthetic_weights",
                                       "--port_num_in", "0",
                                       "--port_num_out", "0"]),
        "server_batched": lambda: server_batched.main(
            ["--synthetic_weights", "--port", "0", "--capacity", "2"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
