"""Deterministic synthetic weights in the reference checkpoint namespace.

The upstream checkpoints are not redistributable (and are stripped from the
mounted reference), so numerical-parity testing uses synthetic weights:
the SAME numpy-seeded arrays are loaded into the reference PyTorch model
(by tools/generate_golden.py) and into this framework (via
weights.convert), and outputs are compared frame-by-frame.

Key names mirror the reference checkpoints exactly:
- VAP sd names from rvap/vap_main/vap_main.py:87-142 (VapGPT modules)
  plus the `encoder.downsample.*` keys patched manually at load time
  (vap_main.py:203-212).
- CPC "weights" names from CPCModel (encoder_components.py:162-176).

The port's own numpy copy of `vap_realtime_tpu/weights/synthetic.py`
(same seeds, same arrays).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

DIM = 256


def synthetic_cpc_weights(seed: int = 1234) -> Dict[str, np.ndarray]:
    rs = np.random.RandomState(seed)

    def w(*shape, scale):
        return rs.uniform(-scale, scale, size=shape).astype(np.float32)

    cpc: Dict[str, np.ndarray] = {}
    specs = [(1, 10), (DIM, 8), (DIM, 4), (DIM, 4), (DIM, 4)]
    for i, (in_ch, k) in enumerate(specs):
        scale = 1.0 / np.sqrt(in_ch * k)
        cpc[f"gEncoder.conv{i}.weight"] = w(DIM, in_ch, k, scale=scale)
        cpc[f"gEncoder.conv{i}.bias"] = w(DIM, scale=scale)
        cpc[f"gEncoder.batchNorm{i}.weight"] = (
            1.0 + 0.1 * rs.randn(1, DIM, 1)).astype(np.float32)
        cpc[f"gEncoder.batchNorm{i}.bias"] = (
            0.1 * rs.randn(1, DIM, 1)).astype(np.float32)
    # LSTM context net (load_CPC default arMode="LSTM"): 4 gates i,f,g,o
    s = 1.0 / np.sqrt(DIM)
    cpc["gAR.baseNet.weight_ih_l0"] = w(4 * DIM, DIM, scale=s)
    cpc["gAR.baseNet.weight_hh_l0"] = w(4 * DIM, DIM, scale=s)
    cpc["gAR.baseNet.bias_ih_l0"] = w(4 * DIM, scale=s)
    cpc["gAR.baseNet.bias_hh_l0"] = w(4 * DIM, scale=s)
    return cpc


def synthetic_vap_state_dict(frame_hz: int = 20, mode: str = "vap",
                             seed: int = 4321,
                             channel_layers: int = 1,
                             cross_layers: int = 3) -> Dict[str, np.ndarray]:
    rs = np.random.RandomState(seed + frame_hz)
    std = 0.02

    def nrm(*shape):
        return (std * rs.randn(*shape)).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    sd: Dict[str, np.ndarray] = {}

    # downsample conv: kernel = stride = 100 // frame_hz
    k = 100 // frame_hz
    scale = 1.0 / np.sqrt(DIM * k)
    sd["encoder.downsample.1.weight"] = rs.uniform(
        -scale, scale, (DIM, DIM, k)).astype(np.float32)
    sd["encoder.downsample.1.bias"] = rs.uniform(
        -scale, scale, (DIM,)).astype(np.float32)
    sd["encoder.downsample.2.ln.weight"] = ones(DIM)
    sd["encoder.downsample.2.ln.bias"] = zeros(DIM)

    def layer(prefix: str, cross: bool):
        sd[f"{prefix}.ln_self_attn.weight"] = ones(DIM)
        sd[f"{prefix}.ln_self_attn.bias"] = zeros(DIM)
        sd[f"{prefix}.ln_ffnetwork.weight"] = ones(DIM)
        sd[f"{prefix}.ln_ffnetwork.bias"] = zeros(DIM)
        for nm in ("query", "key", "value", "proj"):
            sd[f"{prefix}.mha.{nm}.weight"] = nrm(DIM, DIM)
        sd[f"{prefix}.ffnetwork.0.weight"] = nrm(3 * DIM, DIM)
        sd[f"{prefix}.ffnetwork.3.weight"] = nrm(DIM, 3 * DIM)
        if cross:
            sd[f"{prefix}.ln_src_attn.weight"] = ones(DIM)
            sd[f"{prefix}.ln_src_attn.bias"] = zeros(DIM)
            for nm in ("query", "key", "value", "proj"):
                sd[f"{prefix}.mha_cross.{nm}.weight"] = nrm(DIM, DIM)

    for i in range(channel_layers):
        layer(f"ar_channel.layers.{i}", cross=False)
    for i in range(cross_layers):
        layer(f"ar.layers.{i}", cross=True)

    sd["ar.combinator.h0_a.weight"] = nrm(DIM, DIM)
    sd["ar.combinator.h0_b.weight"] = nrm(DIM, DIM)
    sd["ar.combinator.ln.weight"] = ones(DIM)
    sd["ar.combinator.ln.bias"] = zeros(DIM)

    sd["vap_head.weight"] = nrm(256, DIM)
    sd["vap_head.bias"] = zeros(256)
    sd["va_classifier.weight"] = nrm(1, DIM)
    sd["va_classifier.bias"] = zeros(1)
    if mode == "bc":
        sd["bc_head.weight"] = nrm(3, DIM)
        sd["bc_head.bias"] = zeros(3)
    elif mode == "nod":
        sd["nod_head.weight"] = nrm(4, DIM)
        sd["nod_head.bias"] = zeros(4)
        sd["bc_head.weight"] = nrm(1, DIM)
        sd["bc_head.bias"] = zeros(1)
    return sd


def synthetic_audio(n_samples: int, seed: int = 7,
                    n_channels: int = 2) -> np.ndarray:
    """Deterministic speech-ish test audio: (C, N) float32 in [-1, 1]."""
    rs = np.random.RandomState(seed)
    t = np.arange(n_samples, dtype=np.float64) / 16000.0
    out = []
    for c in range(n_channels):
        sig = np.zeros_like(t)
        for f, a in [(110 + 70 * c, 0.3), (340 + 40 * c, 0.2),
                     (800 + 120 * c, 0.1)]:
            sig += a * np.sin(2 * np.pi * f * t + rs.uniform(0, 2 * np.pi))
        # amplitude modulation to emulate speech on/off activity
        env = 0.5 * (1 + np.sin(2 * np.pi * (0.31 + 0.17 * c) * t
                                + rs.uniform(0, 2 * np.pi)))
        sig = sig * env + 0.01 * rs.randn(n_samples)
        out.append(sig.astype(np.float32))
    return np.stack(out)


def synthetic_params(frame_hz: int = 20, mode: str = "vap"):
    """Convenience: the converted params pytree for the synthetic weights."""
    from vap_realtime_tpu_torch.weights.convert import convert_state_dict

    return convert_state_dict(
        synthetic_vap_state_dict(frame_hz, mode),
        synthetic_cpc_weights())
