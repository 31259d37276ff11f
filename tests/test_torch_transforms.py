"""The port's augmentation transforms: the goldens of the torchaudio
pipeline (`tests/golden/transforms.npz`) at the JAX tests' own
tolerances, the resampler and phase vocoder against the JAX package's
at float64, and every `augment_batch` branch with its choice given."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import GOLDEN_DIR
from vap_realtime_tpu.train import transforms as jtr
from vap_realtime_tpu_torch.train import transforms as ttr


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs (the suite runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN_DIR, "transforms.npz"))


def test_stft_istft_match_golden(golden):
    x = torch.from_numpy(golden["input"])
    s = ttr._stft(x, 512, 128)
    np.testing.assert_allclose(s.real.numpy(), golden["stft_512_real"],
                               atol=1e-10)
    np.testing.assert_allclose(s.imag.numpy(), golden["stft_512_imag"],
                               atol=1e-10)
    np.testing.assert_allclose(ttr._istft(s, 512, 128, x.shape[-1]).numpy(),
                               golden["istft_512"], atol=1e-10)


@pytest.mark.parametrize("steps", [-2, -1, 1, 2])
def test_pitch_shift_matches_golden(golden, steps):
    """float64 at 1e-8; float32 within the JAX test's bound (phase
    accumulation drifts in float32)."""
    ref = golden[f"pitch_{steps}"]
    y64 = ttr.pitch_shift(torch.from_numpy(golden["input"]), steps)
    np.testing.assert_allclose(y64.numpy(), ref, atol=1e-8)
    y32 = ttr.pitch_shift(torch.from_numpy(
        golden["input"].astype(np.float32)), steps).numpy()
    assert y32.dtype == np.float32
    assert np.abs(y32 - ref).max() < 2e-2
    assert np.corrcoef(y32.ravel(), ref.ravel())[0, 1] > 0.999


def test_freq_mask_fixed_band_matches_golden(golden):
    """n_fft = 800, hop = 320, the REAL part of bins 50-119 zeroed."""
    x = torch.from_numpy(golden["input"])
    s = ttr._stft(x, 800, 320)
    real = s.real.clone()
    real[:, 50:120, :] = 0.0
    y = ttr._istft(torch.complex(real, s.imag), 800, 320, x.shape[-1])
    np.testing.assert_allclose(y.numpy(), golden["freqmask_fixed"],
                               atol=1e-10)


@pytest.mark.parametrize("orig,new", [(14254, 16000), (17959, 16000),
                                      (16000, 8000)])
def test_sinc_resample_and_vocoder_match_jax(golden, orig, new):
    x = golden["input"][:, :3000]
    with jax.enable_x64(True):
        want = np.asarray(jtr.sinc_resample(jnp.asarray(x), orig, new))
        spec = jtr._stft(jnp.asarray(x), 512, 128)
        voc = np.asarray(jtr.phase_vocoder(spec, orig / new, 128, 512))
    got = ttr.sinc_resample(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12)
    tv = ttr.phase_vocoder(ttr._stft(torch.from_numpy(x), 512, 128),
                           orig / new, 128, 512).numpy()
    np.testing.assert_allclose(tv, voc, atol=1e-9)


def test_add_noise_reference_recipe():
    g = torch.Generator().manual_seed(0)
    out = ttr.add_noise(torch.zeros(2, 4000), g, max_amplitude=0.01)
    assert abs(float(out.max() - out.min()) - 0.02) < 1e-6
    assert abs(float(out.mean())) < 0.005


def test_freq_mask_random_band():
    rs = np.random.RandomState(0)
    w = torch.from_numpy(0.2 * rs.randn(2, 2, 8000).astype(np.float32))
    out = ttr.freq_mask(w, torch.Generator().manual_seed(1))
    assert out.shape == w.shape
    e_in, e_out = float((w ** 2).mean()), float((out ** 2).mean())
    assert 0.05 * e_in < e_out <= 1.5 * e_in


@pytest.mark.parametrize("branch", [None, "pitch", "noise", "mask", "all"])
def test_augment_branches_with_given_choice(branch):
    """Each branch of the batch augmentation, its choice given: None
    returns the input; pitch alone equals `pitch_shift` on every channel;
    noise alone adds a band of 0.02; the others change the waveform."""
    rs = np.random.RandomState(0)
    w = torch.from_numpy(0.1 * rs.randn(2, 2, 4000).astype(np.float32))
    out = ttr.apply_augment(w, branch, 2, torch.Generator().manual_seed(3))
    assert out.shape == w.shape and torch.isfinite(out).all()
    d = (out - w).abs().max().item()
    if branch is None:
        assert out is w
    elif branch == "pitch":
        np.testing.assert_array_equal(
            out.numpy(), ttr.pitch_shift(w.reshape(4, -1), 2).reshape(
                w.shape).numpy())
    elif branch == "noise":
        assert abs((out - w).max() - (out - w).min() - 0.02) < 1e-6
    else:
        assert d > 1e-3


def test_augment_choices_follow_the_reference_rates():
    """Gate at 0.5, then the four branches at 0.25 each, every pitch step
    drawn; the draws come from the generator alone."""
    g = torch.Generator().manual_seed(0)
    draws = [ttr.augment_choices(g) for _ in range(4000)]
    branches = [b for b, _ in draws]
    assert abs(branches.count(None) / 4000 - 0.5) < 0.03
    for b in ttr.BRANCHES:
        assert abs(branches.count(b) / 4000 - 0.125) < 0.02, b
    assert {s for _, s in draws} == {-2, -1, 1, 2}
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    w = torch.randn(1, 2, 4000, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ttr.augment_batch(w, g1), ttr.augment_batch(w, g2))
