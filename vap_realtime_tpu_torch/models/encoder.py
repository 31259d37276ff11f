"""CPC waveform encoder — the seamless streaming form of the fast path.

Behavioural contract (reference rvap/vap_main/encoder_components.py):
5-layer strided conv stack 1->256->...->256, ChannelNorm+ReLU after each
conv, 160x downsample to 100 Hz; 1-layer LSTM context net (gates
i,f,g,o) whose (h, c) carries across frames; learned downsample conv
(kernel = stride = 100//frame_hz) + LayerNorm + GELU.

The fast path carries each conv layer's last (kernel - stride) inputs
across frames and runs a VALID convolution over only the frame's NEW
samples: identical to one seamless valid conv over the whole stream with
a (k - s) zero left pad per layer (`encode_sequence_streaming_oracle`).
Carries are channels-last, (B, k-s, C) for conv1-4 and (B, 1, 5) for
conv0, as in the JAX package.  `conv_impl="normk"` runs the ChannelNorm +
ReLU between the convs through the one-pass kernel
(ops/cuda/channorm.py) with the same numerics and state.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from vap_realtime_tpu_torch.ops.basic import (
    channel_norm, conv1d, gelu, layer_norm, lstm,
)
from vap_realtime_tpu_torch.ops.cuda.channorm import channel_norm_relu

# (kernel, stride, padding) for the 5 CPC convs
# (reference: encoder_components.py:83-92).
CPC_CONV_SPECS = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))
CPC_CONV_CARRY = tuple(k - s for k, s, _ in CPC_CONV_SPECS)  # (5,4,2,2,2)

Params = Dict[str, Any]

# conv_impl of the JAX package that the port has: "conv" (PyTorch convs,
# plain ChannelNorm) and "normk" (the ChannelNorm+ReLU kernel)
CONV_IMPLS = ("conv", "normk")


def check_conv_impl(conv_impl: str) -> None:
    """Raises for a conv_impl the port does not have, naming where it
    waits; never substitutes another implementation."""
    if conv_impl in ("fused", "blocked"):
        raise ValueError(
            f"conv_impl={conv_impl!r} is not ported yet: it waits for the "
            f"whole-stack encoder kernel (ROADMAP.md Queue 2, K7); use "
            f"one of {CONV_IMPLS}")
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r} not in {CONV_IMPLS}")


def init_conv_stream_state(batch: int, dim: int = 256,
                           dtype=torch.float32, device=None) -> Params:
    """Per-layer input tails for the seamless streaming conv stack.

    batch counts CHANNEL-streams (B*2 for B stereo streams).  c0:
    (batch, 1, 5); c1..c4 channels-last (batch, k-s, C).
    """
    st: Params = {"c0": torch.zeros((batch, 1, CPC_CONV_CARRY[0]),
                                    dtype=dtype, device=device)}
    for i, c in enumerate(CPC_CONV_CARRY[1:], start=1):
        st[f"c{i}"] = torch.zeros((batch, c, dim), dtype=dtype,
                                  device=device)
    return st


def _plain_norm_relu(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    return torch.relu(channel_norm(x, w, b))


def cpc_conv_stack_streaming(params: Params, new: torch.Tensor,
                             state: Params,
                             norm_relu: Callable = _plain_norm_relu):
    """Seamless strided conv over the NEW samples only.

    new: (B, L_new), stride-aligned (one frame's fresh samples).
    norm_relu(x, w, b): the ChannelNorm + ReLU after each conv.
    Returns ((B, L_new/160, C) features, new_state).
    """
    x = new[:, None, :]
    new_state: Params = {}
    for i, (k, s, _pad) in enumerate(CPC_CONV_SPECS):
        carry = state[f"c{i}"].to(x.dtype)
        if i > 0:
            carry = carry.transpose(1, 2)            # channels-last -> NCW
        x = torch.cat([carry, x], dim=-1)
        tail = x[..., x.shape[-1] - (k - s):]
        # copies, so the carries do not keep the whole activation alive
        new_state[f"c{i}"] = (tail.clone() if i == 0
                              else tail.transpose(1, 2).contiguous())
        c, n = params[f"conv{i}"], params[f"norm{i}"]
        x = conv1d(x, c["w"], c["b"], stride=s, padding=0)
        x = norm_relu(x, n["w"], n["b"])
    return x.transpose(1, 2), new_state


def cpc_conv_stack_streaming_normk(params: Params, new: torch.Tensor,
                                   state: Params):
    """`cpc_conv_stack_streaming` with each ChannelNorm + ReLU in one
    pass of the `channel_norm_relu` kernel (the JAX package's
    `cpc_conv_stack_streaming_normk`); same numerics and state."""
    return cpc_conv_stack_streaming(params, new, state, channel_norm_relu)


def cpc_context(params: Params, z: torch.Tensor, h0: torch.Tensor,
                c0: torch.Tensor):
    """LSTM context network over (B, T, C); returns (y, h_T, c_T)."""
    g = params["lstm"]
    return lstm(z, h0, c0, g["w_ih"], g["w_hh"], g["b_ih"], g["b_hh"])


def downsample(params: Params, z: torch.Tensor, kernel: int) -> torch.Tensor:
    """Learned downsample: conv(k=s=kernel) + LayerNorm + GELU.

    z: (B, T, C) -> (B, T//kernel, C).
    """
    d = params["down_conv"]
    x = conv1d(z.transpose(1, 2), d["w"], d["b"], stride=kernel, padding=0)
    ln = params["down_ln"]
    return gelu(layer_norm(x.transpose(1, 2), ln["w"], ln["b"]))


def encode_chunk_streaming(params: Params, new: torch.Tensor,
                           conv_state: Params, h0: torch.Tensor,
                           c0: torch.Tensor, downsample_kernel: int,
                           conv_impl: str = "conv"):
    """Fast-path chunk encoder over ONLY the frame's fresh samples.

    new: (B, 16000//frame_hz); h0, c0: (B, C) LSTM state.  conv_impl:
    "conv" or "normk" (see CONV_IMPLS; "fused" and "blocked" raise).
    Returns (emb (B, C), new_conv_state, h_new, c_new).
    """
    check_conv_impl(conv_impl)
    stack = (cpc_conv_stack_streaming_normk if conv_impl == "normk"
             else cpc_conv_stack_streaming)
    z, conv_state = stack(params, new, conv_state)
    y, h_new, c_new = cpc_context(params, z, h0, c0)
    e = downsample(params, y, downsample_kernel)
    return e[:, 0, :], conv_state, h_new, c_new


def encode_sequence_streaming_oracle(params: Params, wav: torch.Tensor,
                                     downsample_kernel: int) -> torch.Tensor:
    """ONE seamless valid conv over the whole stream with a (k-s) zero
    left pad per layer (== `encode_chunk_streaming` frame by frame).
    Test oracle only.  wav: (B, L) -> (B, L // (160*k), C).
    """
    x = wav[:, None, :]
    for i, (k, s, _pad) in enumerate(CPC_CONV_SPECS):
        x = torch.nn.functional.pad(x, (k - s, 0))
        c, n = params[f"conv{i}"], params[f"norm{i}"]
        x = conv1d(x, c["w"], c["b"], stride=s, padding=0)
        x = _plain_norm_relu(x, n["w"], n["b"])
    z = x.transpose(1, 2)
    zeros = z.new_zeros((wav.shape[0], z.shape[-1]))
    y, _, _ = cpc_context(params, z, zeros, zeros)
    return downsample(params, y, downsample_kernel)
