"""VAD post-processing utilities (reference: train/utils.py:170-272).

- onehot <-> vad_list conversion (IPU merging on the way back)
- fill short silences / omit short spikes smoothing
- model-based VAD extraction (train/model.py:270-290 `VapGPT.vad`)

Host-side numpy (irregular run-length logic); `extract_vad` runs the
model on the card unless the caller passes `device="cpu"`.  The port's
counterpart of `vap_realtime_tpu/utils/vad.py`.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vap_realtime_tpu_torch.models.vap import forward_waveform
from vap_realtime_tpu_torch.parallel.mesh import replicate
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.train.events import find_island_idx_len

VAD_LIST = List[List[List[float]]]


def vad_onehot_to_vad_list(vad: np.ndarray, frame_hz: int = 50,
                           ipu_thresh_time: float = 0.1
                           ) -> List[VAD_LIST]:
    """(B, N, 2) onehot -> per-batch [[ch0 [s,e]...], [ch1 ...]] seconds,
    merging segments closer than `ipu_thresh_time` (utils.py:198-236)."""
    assert vad.ndim == 3, f"expected (B, N, 2), got {vad.shape}"
    out = []
    for b in range(vad.shape[0]):
        vad_list = []
        for ch in range(2):
            idx, dur, val = find_island_idx_len(vad[b, :, ch])
            starts = idx[val == 1] / frame_hz
            durs = dur[val == 1] / frame_hz
            segs: List[List[float]] = []
            last_end = None
            for s, d in zip(starts, durs):
                s, e = round(float(s), 2), round(float(s + d), 2)
                if last_end is not None and s - last_end < ipu_thresh_time:
                    segs[-1][-1] = e
                else:
                    segs.append([s, e])
                last_end = e
            vad_list.append(segs)
        out.append(vad_list)
    return out


def vad_fill_silences(vad: np.ndarray, max_fill_time: float = 0.02,
                      frame_hz: float = 50) -> np.ndarray:
    """Fill per-channel silences shorter than max_fill_time
    (utils.py:239-254)."""
    assert vad.ndim == 2 and vad.shape[-1] == 2
    vad = vad.copy()
    max_frames = round(max_fill_time * frame_hz)
    for ch in range(2):
        starts, dur, val = find_island_idx_len(vad[:, ch])
        for s, d in zip(starts[val == 0], dur[val == 0]):
            if d <= max_frames:
                vad[s:s + d, ch] = 1.0
    return vad


def vad_omit_spikes(vad: np.ndarray, max_omit_time: float = 0.02,
                    frame_hz: float = 50) -> np.ndarray:
    """Zero per-channel activity spikes shorter than max_omit_time
    (utils.py:257-271)."""
    assert vad.ndim == 2 and vad.shape[-1] == 2
    vad = vad.copy()
    max_frames = round(max_omit_time * frame_hz)
    for ch in range(2):
        starts, dur, val = find_island_idx_len(vad[:, ch])
        for s, d in zip(starts[val == 1], dur[val == 1]):
            if d <= max_frames:
                vad[s:s + d, ch] = 0.0
    return vad


def extract_vad(params, waveform: np.ndarray, cfg,
                max_fill_silence_time: float = 0.02,
                max_omit_spike_time: float = 0.02,
                vad_cutoff: float = 0.5, device="cuda") -> np.ndarray:
    """Binary VAD from the model with smoothing
    (train/model.py:270-290 `VapGPT.vad`).

    params: a params tree (numpy or tensors); waveform: (B, 2, L) ->
    (B, T, 2) binary.  Runs on CUDA unless device="cpu"; raises without
    CUDA.
    """
    dev = resolve_device(device)
    with torch.no_grad():
        outs = forward_waveform(replicate(params, dev),
                                torch.as_tensor(np.asarray(waveform),
                                                device=dev), cfg)
        sig = torch.sigmoid(torch.cat([outs["vad1"], outs["vad2"]], dim=-1))
    vad = (sig.cpu().numpy() >= vad_cutoff).astype(np.float32)
    for b in range(vad.shape[0]):
        vad[b] = vad_fill_silences(vad[b], max_fill_silence_time,
                                   cfg.frame_hz)
        vad[b] = vad_omit_spikes(vad[b], max_omit_spike_time, cfg.frame_hz)
    return vad
