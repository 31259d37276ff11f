"""Waveform augmentations for noise-robust ("MC") training.

Reference contract (train/transforms.py:11-144 `Augmentation`): with
probability 0.5 per train batch, apply ONE of {pitch shift, additive
noise, waveform frequency masking} (p=0.25 each) or all three in
sequence (p=0.25).  These perturbations produced the published
noise-robust `*_MC` checkpoints (README.md:343-347).  The port's
counterpart of `vap_realtime_tpu/train/transforms.py`, the same recipes:

- Pitch shift (torchaudio `functional.pitch_shift`): STFT (n_fft=512,
  hop=128, centered hann) -> phase vocoder time-stretch by 1/rate ->
  iSTFT at length round(L/rate) -> windowed-sinc resample int(sr/rate)
  -> sr (`sinc_interp_hann`, lowpass_filter_width=6, rolloff=0.99),
  cropped or zero-padded back to L.  rate = 2**(-n_steps/12), n_steps
  drawn from {-2,-1,1,2}.
- Additive noise (reference transforms.py:74-90 `AddGaussianNoise`):
  Gaussian noise rescaled to a peak-to-peak band of 2*max_amplitude
  and re-centered.
- Frequency masking (reference transforms.py:110-141
  `WaveformFrequencyMasking`): complex STFT with n_fft = 0.05*sr = 800,
  hop = 0.02*sr = 320; a random band of width U[0, 100) bins starting
  at U[0, n_freq - width) is zeroed in the REAL part only (the
  reference masks `spec.real` and keeps the imaginary part; quirk
  kept), iid per (batch, channel); then the inverse STFT.

The STFT pair is `torch.stft` / `torch.istft` (center=True, reflect
pad, periodic hann).  Every random choice comes from an explicit
`torch.Generator` (on the waveform's device); `augment_choices` draws
the batch's choices and `apply_augment` applies them, so each branch
can run with its choice given.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
BRANCHES = ("pitch", "noise", "mask", "all")


@dataclass(frozen=True)
class AugmentConfig:
    """Reference Augmentation defaults (train/transforms.py:13-21)."""

    probability: float = 0.5
    noise_amplitude: float = 0.01
    pitch_steps: Tuple[int, ...] = (-2, -1, 1, 2)
    freq_mask_param: int = 100
    sample_rate: int = 16000


def _real_dtype(x: Tensor):
    return x.real.dtype if x.is_complex() else x.dtype


def _window(n_fft: int, like: Tensor) -> Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=_real_dtype(like),
                             device=like.device)


# ---------------------------------------------------------------------------
# STFT / iSTFT (center=True, reflect pad, hann)
# ---------------------------------------------------------------------------

def _stft(wav: Tensor, n_fft: int, hop: int) -> Tensor:
    """(..., L) -> complex (..., n_freq, frames): torch.stft, centered
    (reflect pad), periodic hann window, onesided."""
    s = torch.stft(wav.reshape(-1, wav.shape[-1]), n_fft, hop,
                   window=_window(n_fft, wav), center=True,
                   pad_mode="reflect", onesided=True, return_complex=True)
    return s.reshape(wav.shape[:-1] + s.shape[-2:])


def _istft(spec: Tensor, n_fft: int, hop: int, length: int) -> Tensor:
    """complex (..., n_freq, frames) -> (..., length): torch.istft
    (window-square overlap-add normalisation, center crop)."""
    y = torch.istft(spec.reshape((-1,) + spec.shape[-2:]), n_fft, hop,
                    window=_window(n_fft, spec), center=True, length=length)
    return y.reshape(spec.shape[:-2] + (length,))


def phase_vocoder(spec: Tensor, rate: float, hop: int,
                  n_fft: int) -> Tensor:
    """Time-stretch a complex STFT by `rate` (torchaudio
    `functional.phase_vocoder` formulas).

    spec: (..., n_freq, frames) -> (..., n_freq, ceil(frames/rate)).
    """
    n_freq, F = spec.shape[-2], spec.shape[-1]
    dtype, dev = _real_dtype(spec), spec.device
    phase_advance = torch.linspace(0, math.pi * hop, n_freq, dtype=dtype,
                                   device=dev)[:, None]
    steps = np.arange(0, F, rate, dtype=np.float64)
    alphas = torch.as_tensor(steps % 1.0, dtype=dtype, device=dev)
    i0 = torch.as_tensor(steps.astype(np.int64), device=dev)
    specp = torch.cat([spec, spec.new_zeros(spec.shape[:-1] + (2,))], -1)
    s0 = specp[..., i0]
    s1 = specp[..., i0 + 1]

    phase0 = torch.angle(spec[..., :1])
    phase = torch.angle(s1) - torch.angle(s0) - phase_advance
    phase = phase - 2 * math.pi * torch.round(phase / (2 * math.pi))
    phase = phase + phase_advance
    phase = torch.cat([phase0, phase[..., :-1]], dim=-1)
    phase_acc = torch.cumsum(phase, dim=-1)
    mag = alphas * s1.abs() + (1 - alphas) * s0.abs()
    return torch.polar(mag, phase_acc)


# ---------------------------------------------------------------------------
# Windowed-sinc resampling (torchaudio sinc_interp_hann)
# ---------------------------------------------------------------------------

def _resample_table(orig_freq: int, new_freq: int,
                    lowpass_filter_width: int = 6, rolloff: float = 0.99
                    ) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
    """Per-output-phase sinc kernel table (numpy, float64): the non-zero
    window of torchaudio's dense (new_freq, orig_freq + 2*width) kernel
    for each phase.  Returns (kernels (new, taps), start (new,), orig,
    new, width) with orig/new gcd-reduced."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    base = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base))
    taps = 2 * width + 2
    k = np.arange(new, dtype=np.float64)[:, None]         # output phase
    start = np.floor(k * orig / new).astype(np.int64) - width  # (new, 1)
    n = start + np.arange(taps, dtype=np.int64)[None, :]  # input index
    u = n / orig - k / new
    t = np.clip(u * base, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    tpi = t * math.pi
    kern = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1, tpi))
    kern = kern * window * (base / orig)
    return kern, start[:, 0], orig, new, width


def sinc_resample(wav: Tensor, orig_freq: int, new_freq: int) -> Tensor:
    """(..., L) at orig_freq -> (..., ceil(L*new/orig)) at new_freq,
    torchaudio `functional.resample`'s defaults (sinc_interp_hann,
    lowpass_filter_width=6, rolloff=0.99), as a gather over each output's
    taps."""
    kern, start, orig, new, _w = _resample_table(orig_freq, new_freq)
    L = wav.shape[-1]
    target = int(math.ceil(new * L / orig))
    m = np.arange(target, dtype=np.int64)
    block, phase = m // new, m % new
    idx = (block * orig + start[phase])[:, None] + np.arange(kern.shape[1])
    valid = torch.as_tensor((idx >= 0) & (idx < L), device=wav.device)
    gathered = wav[..., torch.as_tensor(np.clip(idx, 0, L - 1),
                                        device=wav.device)]
    gathered = torch.where(valid, gathered, torch.zeros((), dtype=wav.dtype,
                                                        device=wav.device))
    weights = torch.as_tensor(kern[phase], dtype=wav.dtype,
                              device=wav.device)  # (target, taps)
    return (gathered * weights).sum(dim=-1)


def pitch_shift(wav: Tensor, n_steps: int, sample_rate: int = 16000,
                n_fft: int = 512, bins_per_octave: int = 12) -> Tensor:
    """Duration-preserving pitch shift by `n_steps` semitones, the
    torchaudio `functional.pitch_shift` pipeline the reference uses
    (train/transforms.py:102-107; hop = n_fft//4, centered hann STFT).
    Deterministic (the reference turns torch's determinism off around
    it)."""
    hop = n_fft // 4
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    L = wav.shape[-1]
    stretched = phase_vocoder(_stft(wav, n_fft, hop), rate, hop, n_fft)
    y = _istft(stretched, n_fft, hop, int(round(L / rate)))
    z = sinc_resample(y, int(sample_rate / rate), sample_rate)
    if z.shape[-1] >= L:
        return z[..., :L]
    return torch.nn.functional.pad(z, (0, L - z.shape[-1]))


# ---------------------------------------------------------------------------
# Noise + frequency masking
# ---------------------------------------------------------------------------

def add_noise(wav: Tensor, generator: torch.Generator,
              max_amplitude: float = 0.01) -> Tensor:
    """Reference AddGaussianNoise (transforms.py:74-90): Gaussian noise
    rescaled so its peak-to-peak span is 2*max_amplitude, re-centered by
    half its max."""
    noise = torch.randn(wav.shape, generator=generator, device=wav.device,
                        dtype=wav.dtype)
    noise = noise - noise.min()
    noise = 2 * max_amplitude * noise / noise.max()
    noise = noise - noise.max() / 2
    return wav + noise


def freq_mask(wav: Tensor, generator: torch.Generator,
              sample_rate: int = 16000, mask_param: int = 100) -> Tensor:
    """Reference WaveformFrequencyMasking (transforms.py:110-141): complex
    STFT (n_fft=0.05*sr, hop=0.02*sr), zero a random band of the REAL
    part only, iid over the leading axes (torchaudio `iid_masks=True`),
    inverse STFT.  wav: (..., L)."""
    n_fft = int(0.05 * sample_rate)
    hop = int(0.02 * sample_rate)
    spec = _stft(wav, n_fft, hop)                  # (..., n_freq, T)
    n_freq = spec.shape[-2]
    lead = spec.shape[:-2]
    u = lambda: torch.rand(lead, generator=generator, device=wav.device)
    value = u() * mask_param
    vmin = u() * (n_freq - value)
    f = torch.arange(n_freq, dtype=torch.float32, device=wav.device)
    band = (f >= vmin[..., None]) & (f < (vmin + value)[..., None])
    real = torch.where(band[..., None], torch.zeros((), dtype=spec.real.dtype,
                                                    device=wav.device),
                       spec.real)
    return _istft(torch.complex(real, spec.imag), n_fft, hop, wav.shape[-1])


# ---------------------------------------------------------------------------
# Batch augmentation (reference Augmentation.forward branch structure)
# ---------------------------------------------------------------------------

def augment_choices(generator: torch.Generator,
                    cfg: Optional[AugmentConfig] = None
                    ) -> Tuple[Optional[str], int]:
    """One batch's draws (reference transforms.py:58-71): (branch or None
    when the gate is off, pitch steps).  The gate passes with probability
    `cfg.probability`; then pitch / noise / mask / all at 0.25 each."""
    cfg = cfg or AugmentConfig()
    u = torch.rand(3, generator=generator,
                   device=generator.device).tolist()
    gate, r, s = u
    steps = cfg.pitch_steps[min(int(s * len(cfg.pitch_steps)),
                                len(cfg.pitch_steps) - 1)]
    if gate > cfg.probability:
        return None, steps
    return BRANCHES[int(r >= 0.25) + int(r >= 0.5) + int(r >= 0.75)], steps


def apply_augment(wav: Tensor, branch: Optional[str], n_steps: int,
                  generator: torch.Generator,
                  cfg: Optional[AugmentConfig] = None) -> Tensor:
    """Apply one batch's choices to wav (B, 2, L): branch None (the
    input, unchanged), "pitch", "noise", "mask" or "all" (the reference's
    apply_all order: pitch -> freq mask -> noise); the noise and the mask
    bands are drawn from `generator`."""
    cfg = cfg or AugmentConfig()
    if branch is None:
        return wav
    B, C, L = wav.shape
    x = wav.reshape(B * C, L)
    if branch in ("pitch", "all"):
        x = pitch_shift(x, n_steps, cfg.sample_rate)
    if branch in ("mask", "all"):
        x = freq_mask(x, generator, cfg.sample_rate, cfg.freq_mask_param)
    if branch in ("noise", "all"):
        x = add_noise(x, generator, cfg.noise_amplitude)
    return x.reshape(B, C, L)


def augment_batch(wav: Tensor, generator: torch.Generator,
                  cfg: Optional[AugmentConfig] = None) -> Tensor:
    """One train-batch augmentation draw applied to the WHOLE batch
    (batch-level draws, like the reference's callback).  wav: (B, 2, L)."""
    branch, n_steps = augment_choices(generator, cfg)
    return apply_augment(wav, branch, n_steps, generator, cfg)
