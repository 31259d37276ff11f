"""Discrete VA-projection objective — codebook, bin sums, labels, losses.

The 256-class codebook maps class i to an 8-bit binary state, bits
LSB-first, reshaped (2 speakers, 4 future bins) with speaker c / bin b at
bit ``4*c + b`` (reference objective.py:93-110).  p_now sums bins 0-1,
p_future bins 2-3, each normalized with +1e-5 (objective.py:186-206).
The decode of all states folds into a constant (256, 2) bin-sum matrix,
so the aggregation is one matmul.

Train side (reference objective.py:40-76, 112-139, 211-275 and
rvap/vap_bc/objective.py:216-308): labels shift the VAD one frame,
window the next `horizon` frames, threshold each bin's mean activity at
0.5 and encode the binary state as its weighted bit sum; the losses are
CE over the classes and BCE-with-logits for the VAD and bc heads.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def codebook_states(n_bins: int = 4) -> np.ndarray:
    """(n_classes, 2, n_bins) binary states; bit (4c+b) LSB-first."""
    n_classes = 2 ** (2 * n_bins)
    idx = np.arange(n_classes, dtype=np.int64)
    bits = (idx[:, None] >> np.arange(2 * n_bins)[None, :]) & 1
    return bits.reshape(n_classes, 2, n_bins).astype(np.float32)


@functools.lru_cache(maxsize=None)
def bin_sum_matrix(from_bin: int, to_bin: int, n_bins: int = 4) -> np.ndarray:
    """(n_classes, 2): per-speaker activity summed over bins [from, to]."""
    return codebook_states(n_bins)[:, :, from_bin:to_bin + 1].sum(-1)


def bin_sum_table(from_bin: int, to_bin: int, n_bins: int, dtype,
                  device) -> Tensor:
    """`bin_sum_matrix` as a tensor, built once per bins, dtype and device
    (a copy from host memory, which on the card waits for all queued
    work: a serving tick that rebuilt it would stall its host); read-only.
    While a graph is traced (`torch.export`) it is built anew and not
    cached, so the cache never holds a traced stand-in for a tensor.
    `bin_sum_table.builds` counts the tables built for the cache."""
    if torch.compiler.is_compiling():
        return _bin_sum_table(from_bin, to_bin, n_bins, dtype, device)
    return _bin_sum_table_cached(from_bin, to_bin, n_bins, dtype, device)


bin_sum_table.builds = 0


def _bin_sum_table(from_bin: int, to_bin: int, n_bins: int, dtype,
                   device) -> Tensor:
    return torch.as_tensor(bin_sum_matrix(from_bin, to_bin, n_bins),
                           dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _bin_sum_table_cached(from_bin: int, to_bin: int, n_bins: int, dtype,
                          device) -> Tensor:
    bin_sum_table.builds += 1
    # a plain tensor even when first asked for under inference mode, so
    # that a later call with autograd on may save it for the backward
    with torch.inference_mode(False):
        return _bin_sum_table(from_bin, to_bin, n_bins, dtype, device)


def probs_next_speaker_aggregate(probs: torch.Tensor, from_bin: int,
                                 to_bin: int, n_bins: int = 4
                                 ) -> torch.Tensor:
    """probs: (..., n_classes) -> (..., 2) normalized next-speaker probs."""
    abp = bin_sum_table(from_bin, to_bin, n_bins, probs.dtype, probs.device)
    p = probs @ abp
    return p / (p.sum(dim=-1, keepdim=True) + 1e-5)


def p_now(probs: torch.Tensor, n_bins: int = 4) -> torch.Tensor:
    return probs_next_speaker_aggregate(probs, 0, 1, n_bins)


def p_future(probs: torch.Tensor, n_bins: int = 4) -> torch.Tensor:
    return probs_next_speaker_aggregate(probs, 2, 3, n_bins)


# ----------------------------------------------------------------------------
# Labels
# ----------------------------------------------------------------------------

def projection_windows(va: Tensor, bin_frames: Sequence[int],
                       threshold: float = 0.5) -> Tensor:
    """VAD (B, N, 2) -> binary projection bins (B, N - horizon, 2, n_bins):
    shift one frame into the future, then average each bin span's
    activity for every window through a cumulative sum and threshold it
    (ProjectionWindow.__call__, objective.py:40-76)."""
    horizon = int(sum(bin_frames))
    v = va[:, 1:, :]                                   # future shift
    T = v.shape[1] - horizon + 1                       # valid frames
    cs = torch.cumsum(v, dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    outs = []
    start = 0
    for bf in bin_frames:
        seg = (cs[:, start + bf:start + bf + T] - cs[:, start:start + T]) / bf
        outs.append((seg >= threshold).to(va.dtype))
        start += bf
    return torch.stack(outs, dim=-1)                   # (B, T, 2, n_bins)


def encode_codebook(bins: Tensor) -> Tensor:
    """Binary (., 2, n_bins) -> class index (int64); bit weight
    2^(4c+b)."""
    n_bins = bins.shape[-1]
    weights = torch.as_tensor(
        (2.0 ** np.arange(2 * n_bins)).reshape(2, n_bins),
        dtype=bins.dtype, device=bins.device)
    return (bins * weights).sum(dim=(-2, -1)).long()


def get_labels(va: Tensor, bin_frames: Sequence[int],
               threshold: float = 0.5) -> Tensor:
    """VAD (B, N, 2) -> class labels (B, N - horizon)
    (objective.py:211-214)."""
    return encode_codebook(projection_windows(va, bin_frames, threshold))


# ----------------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------------

def loss_vap(logits: Tensor, labels: Tensor,
             reduction: str = "mean") -> Tensor:
    """Cross-entropy over the 256 classes (objective.py:222-245).

    logits (B, T', n_classes), labels (B, T): both are cut to the common
    length (the reference drops extra logits, objective.py:232-234, and
    its 50 Hz arithmetic can leave labels one frame longer)."""
    nmax = min(labels.shape[1], logits.shape[1])
    logp = torch.log_softmax(logits[:, :nmax], dim=-1)
    nll = -torch.gather(logp, -1, labels[:, :nmax, None].long())[..., 0]
    return nll.mean() if reduction == "mean" else nll


def loss_vad(vad_logits: Tensor, vad: Tensor) -> Tensor:
    """BCE-with-logits; the labels cut to the logits' length
    (objective.py:273-275)."""
    n = vad_logits.shape[-2]
    vad = vad[:, :n]
    return (torch.clamp(vad_logits, min=0) - vad_logits * vad
            + torch.log1p(torch.exp(-vad_logits.abs()))).mean()


def get_labels_bc(bc_frame: Tensor, frame_hz: int, shift_sec: float = 0.5,
                  append_sec: float = 2.0) -> Tensor:
    """Backchannel labels: the per-frame bc track shifted `shift_sec`
    into the future and cut to N - append frames; the last `shift`
    outputs have no future signal and stay 0
    (rvap/vap_bc/objective.py:216-236).  (B, N) -> (B, N - append)."""
    shift = int(shift_sec * frame_hz)
    append = int(append_sec * frame_hz)
    body = bc_frame[:, shift:bc_frame.shape[1] - append]
    tail = bc_frame.new_zeros((bc_frame.shape[0], shift))
    return torch.cat([body, tail], dim=1)


def loss_bc(bc_logits: Tensor, bc_labels: Tensor,
            pos_weight: float = 1.0) -> Tensor:
    """BCE-with-logits with a positive-class weight, mean-reduced
    (rvap/vap_bc/objective.py:295-296):
    ``-(pw*y*log sigmoid(x) + (1-y)*log(1-sigmoid(x)))``."""
    nmax = min(bc_logits.shape[-1], bc_labels.shape[-1])
    x = bc_logits[..., :nmax]
    y = bc_labels[..., :nmax]
    return -(pos_weight * y * F.logsigmoid(x)
             + (1.0 - y) * F.logsigmoid(-x)).mean()


def loss_vad_mono(vad_logits: Tensor, vad: Tensor) -> Tensor:
    """Mono-channel VAD BCE: the squeezed logits against channel 1's (the
    user channel's) VAD (rvap/vap_bc/objective.py:302-308)."""
    n = vad_logits.shape[-2]
    return loss_bc(vad_logits.squeeze(-1), vad[:, :n, 1])


# the reference's loss_lid is token for token the CE of loss_vap
# (rvap/vap_bc/objective.py:269-291)
loss_lid = loss_vap


def bin_times_to_frames(bin_times: Sequence[float],
                        frame_hz: int) -> List[int]:
    return [int(t * frame_hz) for t in bin_times]
