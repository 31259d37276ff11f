"""CPC waveform encoder — the chunked form (`encode_chunk`, the
full-recompute and kv paths) and the seamless streaming form of the fast
path.

Behavioural contract (reference rvap/vap_main/encoder_components.py):
5-layer strided conv stack 1->256->...->256, ChannelNorm+ReLU after each
conv, 160x downsample to 100 Hz; 1-layer LSTM context net (gates
i,f,g,o) whose (h, c) carries across frames; learned downsample conv
(kernel = stride = 100//frame_hz) + LayerNorm + GELU.

`cpc_conv_stack` zero-pads each conv at the chunk's own edges (torch
conv padding) and `encode_chunk` trims the first and last CPC frame
``z[:, 1:-1]`` (reference encoder.py:74-77), the parity-exact recipe.

The fast path carries each conv layer's last (kernel - stride) inputs
across frames and runs a VALID convolution over only the frame's NEW
samples: identical to one seamless valid conv over the whole stream with
a (k - s) zero left pad per layer (`encode_sequence_streaming_oracle`).
Carries are channels-last, (B, k-s, C) for conv1-4 and (B, 1, 5) for
conv0, as in the JAX package.  `conv_impl="normk"` runs the ChannelNorm +
ReLU between the convs through the one-pass kernel
(ops/cuda/channorm.py) with the same numerics and state;
`conv_impl="fused"` runs the whole stack in one kernel
(ops/cuda/encoder.py), and `"blocked"` is the channels-last stride-block
matmul form in plain PyTorch; all four share one state layout.

`encode_sequence` is the whole-waveform form of training and offline
batches (reference train/encoder.py, train/model.py): one conv stack over
the whole clip, the 1:-1 trim, the LSTM from zero state through the
`lstm_scan` kernel (K5, ops/cuda/lstm.py; about 2,000 steps for 20 s),
then the downsample.  The encoder is frozen in training, so the conv
stack and the LSTM run without autograd; only the downsample is
trainable.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from vap_realtime_tpu_torch.config import CPC_DOWNSAMPLE
from vap_realtime_tpu_torch.ops.basic import (
    channel_norm, conv1d, gelu, layer_norm, lstm,
)
from vap_realtime_tpu_torch.ops.cuda.channorm import channel_norm_relu
from vap_realtime_tpu_torch.ops.cuda.encoder import (
    cpc_conv_stack_streaming_fused, wait_all,
)
from vap_realtime_tpu_torch.ops.cuda.lstm import lstm_fused, lstm_serve
from vap_realtime_tpu_torch.utils.spans import span

# (kernel, stride, padding) for the 5 CPC convs
# (reference: encoder_components.py:83-92).
CPC_CONV_SPECS = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))
CPC_CONV_CARRY = tuple(k - s for k, s, _ in CPC_CONV_SPECS)  # (5,4,2,2,2)

Params = Dict[str, Any]

# conv_impl of the JAX package: "conv" (PyTorch convs, plain
# ChannelNorm), "normk" (the ChannelNorm+ReLU kernel between the convs),
# "fused" (the whole stack in one kernel) and "blocked" (stride-block
# matmuls, plain PyTorch)
CONV_IMPLS = ("conv", "normk", "fused", "blocked")


def check_conv_impl(conv_impl: str) -> None:
    """Raises for a conv_impl the port does not have; never substitutes
    another implementation."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r} not in {CONV_IMPLS}")


def init_cpc_encoder_params(generator: torch.Generator, dim: int = 256,
                            downsample_kernel: int = 5,
                            dtype=torch.float32, device=None) -> Params:
    """Random init with torch-default distributions, U(+-1/sqrt(fan_in)),
    in the JAX package's tree and shapes (ChannelNorm and LayerNorm
    affines at 1 and 0), drawn from `generator`."""

    def unif(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        u = torch.rand(shape, generator=generator, device=device)
        return ((2 * u - 1) * bound).to(dtype)

    p: Params = {}
    in_ch = 1
    for i, (k, _s, _p) in enumerate(CPC_CONV_SPECS):
        fan = in_ch * k
        p[f"conv{i}"] = {"w": unif((dim, in_ch, k), fan),
                         "b": unif((dim,), fan)}
        p[f"norm{i}"] = {"w": torch.ones((dim, 1), dtype=dtype,
                                         device=device),
                         "b": torch.zeros((dim, 1), dtype=dtype,
                                          device=device)}
        in_ch = dim
    p["lstm"] = {"w_ih": unif((4 * dim, dim), dim),
                 "w_hh": unif((4 * dim, dim), dim),
                 "b_ih": unif((4 * dim,), dim),
                 "b_hh": unif((4 * dim,), dim)}
    kd = downsample_kernel
    p["down_conv"] = {"w": unif((dim, dim, kd), dim * kd),
                      "b": unif((dim,), dim * kd)}
    p["down_ln"] = {"w": torch.ones(dim, dtype=dtype, device=device),
                    "b": torch.zeros(dim, dtype=dtype, device=device)}
    return p


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


def cpc_conv_stack_streaming_blocked(params: Params, new: torch.Tensor,
                                     state: Params):
    """Seamless strided conv over the NEW samples in the channels-last
    stride-block matmul form (the JAX package's
    `cpc_conv_stack_streaming_blocked`): conv0 stays an NCW conv; every
    later conv (kernel = 2 * stride) is two (s*C_in, C_out) matmuls over
    adjacent stride blocks, float32-accumulated, with a float32 bias.
    Unlike the fused kernel, the ChannelNorm affine runs in float32 and
    the result is cast to the activation dtype after the ReLU.  Same state
    as `cpc_conv_stack_streaming`."""
    f32 = torch.float32
    dt = new.dtype

    def norm_relu_last(y, n):
        # single-stats-pass unbiased ChannelNorm over the last axis
        C = y.shape[-1]
        s1 = y.sum(-1, keepdim=True)
        s2 = y.square().sum(-1, keepdim=True)
        mean = s1 / C
        var = torch.clamp((s2 - C * mean.square()) / (C - 1), min=0.0)
        y = (y - mean) * torch.rsqrt(var + 1e-5)
        return torch.relu(y * n["w"][:, 0].float() + n["b"][:, 0].float())

    new_state: Params = {}
    k0, s0, _ = CPC_CONV_SPECS[0]
    xc0 = torch.cat([state["c0"].to(dt), new[:, None, :]], dim=-1)
    new_state["c0"] = xc0[..., xc0.shape[-1] - (k0 - s0):].clone()
    c0, n0 = params["conv0"], params["norm0"]
    y0 = conv1d(xc0, c0["w"], c0["b"], stride=s0, padding=0)
    x = norm_relu_last(y0.transpose(1, 2).to(f32), n0).to(dt)
    for i, (k, s, _pad) in enumerate(CPC_CONV_SPECS[1:], start=1):
        xc = torch.cat([state[f"c{i}"].to(x.dtype), x], dim=1)
        new_state[f"c{i}"] = xc[:, xc.shape[1] - (k - s):].contiguous()
        B, L, Cin = xc.shape
        n_blk = L // s
        xb = xc[:, :n_blk * s].reshape(B * n_blk, s * Cin).to(f32)
        c, n = params[f"conv{i}"], params[f"norm{i}"]
        wt = c["w"].permute(2, 1, 0)                      # (K, C_in, C_out)
        w0 = wt[:s].reshape(s * Cin, -1).to(f32)
        w1 = wt[s:].reshape(s * Cin, -1).to(f32)
        z0 = (xb @ w0).reshape(B, n_blk, -1)
        z1 = (xb @ w1).reshape(B, n_blk, -1)
        y = z0[:, :n_blk - 1] + z1[:, 1:] + c["b"].to(f32)
        x = norm_relu_last(y, n).to(xc.dtype)
    return x, new_state


def cpc_conv_stack(params: Params, wav: torch.Tensor) -> torch.Tensor:
    """Strided conv stack with per-chunk zero padding: (B, L) waveform ->
    (B, N, C) features at 100 Hz (the JAX package's `cpc_conv_stack`)."""
    x = wav[:, None, :]
    for i, (k, s, pad) in enumerate(CPC_CONV_SPECS):
        c, n = params[f"conv{i}"], params[f"norm{i}"]
        x = conv1d(x, c["w"], c["b"], stride=s, padding=pad)
        x = _plain_norm_relu(x, n["w"], n["b"])
    return x.transpose(1, 2)


def cpc_context(params: Params, z: torch.Tensor, h0: torch.Tensor,
                c0: torch.Tensor):
    """LSTM context network over (B, T, C); returns (y, h_T, c_T).  CUDA
    bf16 tensors (z, the state and the weights) take the serving kernel
    (`lstm_serve`, ops/cuda/lstm.py: all T steps in one launch); any
    other device or dtype `ops.basic.lstm`."""
    g = params["lstm"]
    args = (z, h0, c0, g["w_ih"], g["w_hh"], g["b_ih"], g["b_hh"])
    if z.is_cuda and all(t.dtype == torch.bfloat16 for t in args):
        # the chunked conv stack's z is a (B, C, T) view transposed
        return lstm_serve(z.contiguous(), *args[1:])
    return lstm(*args)


def downsample(params: Params, z: torch.Tensor, kernel: int) -> torch.Tensor:
    """Learned downsample: conv(k=s=kernel) + LayerNorm + GELU.

    z: (B, T, C) -> (B, T//kernel, C).
    """
    d = params["down_conv"]
    x = conv1d(z.transpose(1, 2), d["w"], d["b"], stride=kernel, padding=0)
    ln = params["down_ln"]
    return gelu(layer_norm(x.transpose(1, 2), ln["w"], ln["b"]))


def encode_chunk(params: Params, wav: torch.Tensor, h0: torch.Tensor,
                 c0: torch.Tensor, downsample_kernel: int):
    """Encode one model frame of audio into exactly ONE embedding.

    wav: (B, frame_samples), frame_samples = 16000//frame_hz + 320; h0,
    c0: (B, C) carried LSTM state.  Conv stack -> trim the first and
    last frame -> LSTM -> downsample (reference encoder.py:58-80).
    Returns (emb (B, C), h_new, c_new).
    """
    z = cpc_conv_stack(params, wav)[:, 1:-1]
    y, h_new, c_new = cpc_context(params, z, h0, c0)
    return downsample(params, y, downsample_kernel)[:, 0], h_new, c_new


def encode_chunk_streaming(params: Params, new: torch.Tensor,
                           conv_state: Params, h0: torch.Tensor,
                           c0: torch.Tensor, downsample_kernel: int,
                           conv_impl: str = "conv", fence=None):
    """Fast-path chunk encoder over ONLY the frame's fresh samples.

    new: (B, 16000//frame_hz); h0, c0: (B, C) LSTM state.  conv_impl:
    one of CONV_IMPLS ("fused": the whole-stack kernel, whose results in
    bf16 are more precise than the "conv" path's; see ops/cuda/encoder.py).
    fence: None (new is already on the stream) or the events of the
    copies that bring it: the fused stack waits on each before the body
    call that reads its piece, every other stack on all of them first.
    Returns (emb (B, C), new_conv_state, h_new, c_new).  Its three
    stages are the spans `vap.encode.conv` (the conv stack), `.lstm` (the
    100 // frame_hz steps of the LSTM: `cpc_context`, one `lstm_serve`
    launch on CUDA bf16) and `.down` (the downsample).
    """
    check_conv_impl(conv_impl)
    stack = {"normk": cpc_conv_stack_streaming_normk,
             "fused": cpc_conv_stack_streaming_fused,
             "blocked": cpc_conv_stack_streaming_blocked,
             }.get(conv_impl, cpc_conv_stack_streaming)
    with span("vap.encode.conv"):
        if conv_impl == "fused":
            z, conv_state = stack(params, new, conv_state, fence)
        else:
            wait_all(fence)
            z, conv_state = stack(params, new, conv_state)
    with span("vap.encode.lstm"):
        y, h_new, c_new = cpc_context(params, z, h0, c0)
    with span("vap.encode.down"):
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
    g = params["lstm"]
    y, _, _ = lstm(z, zeros, zeros, g["w_ih"], g["w_hh"], g["b_ih"],
                   g["b_hh"])
    return downsample(params, y, downsample_kernel)


def encode_sequence(params: Params, wav: torch.Tensor,
                    downsample_kernel: int) -> torch.Tensor:
    """Whole-waveform encoding (training and offline batches): one conv
    stack over the whole clip, the 1:-1 trim, the LSTM from zero state
    through `lstm_fused` (the K5 kernel on CUDA tensors, its plain scan
    on CPU ones), then the downsample.  The frozen conv stack and LSTM
    run without autograd; the downsample keeps its graph.

    wav: (B, L) -> (B, (L // 160 - 2) // downsample_kernel, C).
    """
    with torch.no_grad():
        z = cpc_conv_stack(params, wav)[:, 1:-1]
        zeros = z.new_zeros((wav.shape[0], z.shape[-1]))
        g = params["lstm"]
        y, _, _ = lstm_fused(z, zeros, zeros, g["w_ih"], g["w_hh"],
                             g["b_ih"], g["b_hh"])
    return downsample(params, y, downsample_kernel)


def encode_sequence_limited(params: Params, wav: torch.Tensor,
                            downsample_kernel: int, limit_sec: float,
                            sample_rate: int = 16000,
                            max_rows: int = 256) -> torch.Tensor:
    """Truncated-context encoding (reference train/encoder.py:119-247,
    `lim_context_sec`): each frame's embedding is recomputed from only
    the trailing `limit_sec` of audio (frame-aligned, at least two
    frames), zero-padded on the left at the clip's start.  The JAX
    package scans over the frames; here the frames' windows go through
    `encode_sequence` in batches of at most `max_rows` windows, with the
    same result.

    wav: (B, L) -> (B, T_frames, C), T_frames as `encode_sequence`'s.
    """
    hop = CPC_DOWNSAMPLE * downsample_kernel          # samples per frame
    B, L = wav.shape
    n_frames = (L // CPC_DOWNSAMPLE - 2) // downsample_kernel
    win = int(limit_sec * sample_rate)
    win = max((win // hop) * hop, hop * 2)
    span = win + 2 * CPC_DOWNSAMPLE
    # frame t's window: padded samples [(t + 1) hop, (t + 1) hop + span)
    windows = torch.nn.functional.pad(wav, (win, 0)).unfold(1, span, hop)
    windows = windows[:, 1:n_frames + 1]              # (B, n_frames, span)
    step = max(1, max_rows // B)
    outs = []
    for t0 in range(0, n_frames, step):
        w = windows[:, t0:t0 + step]
        e = encode_sequence(params, w.reshape(-1, span), downsample_kernel)
        outs.append(e[:, -1].reshape(B, w.shape[1], -1))
    return torch.cat(outs, dim=1)
