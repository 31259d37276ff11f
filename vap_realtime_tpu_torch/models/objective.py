"""Discrete VA-projection objective — the inference-side bin sums.

The 256-class codebook maps class i to an 8-bit binary state, bits
LSB-first, reshaped (2 speakers, 4 future bins) with speaker c / bin b at
bit ``4*c + b`` (reference objective.py:93-110).  p_now sums bins 0-1,
p_future bins 2-3, each normalized with +1e-5 (objective.py:186-206).
The decode of all states folds into a constant (256, 2) bin-sum matrix,
so the aggregation is one matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def probs_next_speaker_aggregate(probs: torch.Tensor, from_bin: int,
                                 to_bin: int, n_bins: int = 4
                                 ) -> torch.Tensor:
    """probs: (..., n_classes) -> (..., 2) normalized next-speaker probs."""
    abp = torch.as_tensor(bin_sum_matrix(from_bin, to_bin, n_bins),
                          dtype=probs.dtype, device=probs.device)
    p = probs @ abp
    return p / (p.sum(dim=-1, keepdim=True) + 1e-5)


def p_now(probs: torch.Tensor, n_bins: int = 4) -> torch.Tensor:
    return probs_next_speaker_aggregate(probs, 0, 1, n_bins)


def p_future(probs: torch.Tensor, n_bins: int = 4) -> torch.Tensor:
    return probs_next_speaker_aggregate(probs, 2, 3, n_bins)
