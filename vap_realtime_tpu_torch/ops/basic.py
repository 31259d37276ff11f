"""Functional building-block ops with exact PyTorch-reference semantics.

The numerical contracts of `vap_realtime_tpu/ops/basic.py`, on tensors:

- `channel_norm`: per-timestep norm over the channel axis with *unbiased*
  variance, eps 1e-5, computed in ONE stats pass (sum and sum of squares)
  with the variance clamped at 0 (reference
  rvap/vap_main/encoder_components.py:62-70).
- `gelu`: exact erf formulation (torch ``nn.GELU`` default).
- `linear`: torch layout ``y = x @ W.T + b`` with W of shape (out, in).
- `conv1d`: NCW / OIW layout.
- `gru_cell` / `gru`: gate order r, z, n (torch ``nn.GRU``).
- `lstm_cell` / `lstm`: gate order i, f, g, o (torch ``nn.LSTM``).
- `softmax`: over one axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def linear(x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """x: (..., in), w: (out, in), b: (out,) or None."""
    return F.linear(x, w, b)


def gelu(x: Tensor) -> Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def layer_norm(x: Tensor, w: Tensor, b: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis; biased variance."""
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def channel_norm(x: Tensor, w: Tensor, b: Tensor, eps: float = 1e-5) -> Tensor:
    """ChannelNorm over axis -2 (channels) of (..., C, T) with UNBIASED
    variance.  w, b: (C, 1) affine parameters.

    One stats pass in float32: sum and sum of squares; the variance is
    clamped at 0 so that cancellation on a near-constant channel vector
    cannot make rsqrt(var + eps) NaN.
    """
    n = x.shape[-2]
    xf = x.float()
    s1 = xf.sum(dim=-2, keepdim=True)
    s2 = xf.square().sum(dim=-2, keepdim=True)
    mean = s1 / n
    var = ((s2 - n * mean.square()) / max(n - 1, 1)).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    return ((xf - mean) * rstd).to(x.dtype) * w + b


def conv1d(x: Tensor, w: Tensor, b: Optional[Tensor], stride: int,
           padding: int) -> Tensor:
    """x: (B, C_in, L); w: (C_out, C_in, K) -> (B, C_out, L_out)."""
    return F.conv1d(x, w, b, stride=stride, padding=padding)


def _gru_gates(gi: Tensor, gh: Tensor, h: Tensor) -> Tensor:
    """The GRU update from the input and hidden projections, both
    (..., 3H) ordered [r; z; n]."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def gru_cell(x: Tensor, h: Tensor, w_ih: Tensor, w_hh: Tensor,
             b_ih: Tensor, b_hh: Tensor) -> Tensor:
    """One GRU step.  x: (..., in), h: (..., H); w_ih: (3H, in), w_hh:
    (3H, H), biases (3H,), rows ordered [r; z; n]."""
    return _gru_gates(linear(x, w_ih, b_ih), linear(h, w_hh, b_hh), h)


def gru(x: Tensor, h0: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor,
        b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """Single-layer batch-first GRU.  x: (B, T, in), h0: (B, H).  Returns
    (ys (B, T, H), h_T).  The input projection runs once over all T
    steps; the recurrence is a Python loop."""
    gi = linear(x, w_ih, b_ih)                           # (B, T, 3H)
    h = h0
    ys = []
    for t in range(x.shape[1]):
        h = _gru_gates(gi[:, t], linear(h, w_hh, b_hh), h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def lstm_cell(gi: Tensor, h: Tensor, c: Tensor, w_hh: Tensor,
              b_hh: Tensor) -> Tuple[Tensor, Tensor]:
    """One LSTM step given the precomputed input gates gi = x @ W_ih.T +
    b_ih, (..., 4H) ordered [i; f; g; o].  Returns (h', c')."""
    H = h.shape[-1]
    g = gi + linear(h, w_hh, b_hh)
    i = torch.sigmoid(g[..., :H])
    f = torch.sigmoid(g[..., H:2 * H])
    gg = torch.tanh(g[..., 2 * H:3 * H])
    o = torch.sigmoid(g[..., 3 * H:])
    c_new = f * c + i * gg
    return o * torch.tanh(c_new), c_new


def lstm(x: Tensor, h0: Tensor, c0: Tensor, w_ih: Tensor, w_hh: Tensor,
         b_ih: Tensor, b_hh: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-layer batch-first LSTM, gate order i,f,g,o.

    x: (B, T, in); h0, c0: (B, H).  Returns (ys (B, T, H), h_T, c_T).
    The input projection runs once over all T steps; the recurrence is a
    Python loop (T = 100 // frame_hz, 5 steps at 20 Hz).
    """
    gi = linear(x, w_ih, b_ih)                           # (B, T, 4H)
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        h, c = lstm_cell(gi[:, t], h, c, w_hh, b_hh)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


def softmax(x: Tensor, axis: int = -1) -> Tensor:
    return torch.softmax(x, dim=axis)
