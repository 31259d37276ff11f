"""The port's VAD utilities against the JAX package's: smoothing and the
onehot -> list conversion on the same arrays, and `extract_vad` (the
model's binary VAD) on the same weights and audio."""

import jax
import numpy as np
import pytest
import torch

from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.utils import vad as jvad
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.utils import vad as tvad
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_params,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs (the suite runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_fill_and_omit_equal_jax():
    rs = np.random.RandomState(0)
    for _ in range(5):
        vad = (rs.rand(120, 2) > 0.5).astype(np.float32)
        for t in (0.02, 0.06, 0.1):
            np.testing.assert_array_equal(
                tvad.vad_fill_silences(vad, t, 50),
                jvad.vad_fill_silences(vad, t, 50))
            np.testing.assert_array_equal(
                tvad.vad_omit_spikes(vad, t, 50),
                jvad.vad_omit_spikes(vad, t, 50))


def test_onehot_to_vad_list_equals_jax():
    rs = np.random.RandomState(1)
    vad = (rs.rand(3, 100, 2) > 0.5).astype(np.float32)
    for thresh in (0.01, 0.1):
        assert (tvad.vad_onehot_to_vad_list(vad, 50, thresh)
                == jvad.vad_onehot_to_vad_list(vad, 50, thresh))


def test_extract_vad_equals_jax():
    """The va classifier is scaled up so every frame's probability lies
    well away from the cutoff (asserted on the JAX side); then the
    binary VADs must be equal."""
    params = synthetic_params(20)
    params["va_classifier"]["w"] = params["va_classifier"]["w"] * 300.0
    wav = synthetic_audio(16000)[None] * 0.5
    cfg = VapConfig(frame_hz=20, cross_layers=3)
    jp = jax.tree_util.tree_map(np.asarray, params)
    from vap_realtime_tpu.models.vap import forward_waveform

    outs = forward_waveform(jp, wav, JaxConfig(frame_hz=20))
    sig = jax.nn.sigmoid(np.concatenate([outs["vad1"], outs["vad2"]], -1))
    assert float(np.abs(np.asarray(sig) - 0.5).min()) > 1e-3
    want = jvad.extract_vad(jp, wav, JaxConfig(frame_hz=20))
    got = tvad.extract_vad(params, wav, cfg, device="cpu")
    assert got.shape == want.shape == (1, 19, 2)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_extract_vad_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvad.extract_vad(synthetic_params(20),
                         np.zeros((1, 2, 16000), np.float32), VapConfig())
