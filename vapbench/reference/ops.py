"""Plain float64 building blocks of the reference.

Contracts (rvap/vap_main): ChannelNorm over channels with the unbiased
variance and eps 1e-5 (encoder_components.py:62-70); LayerNorm with the
biased variance, eps 1e-5; exact-erf GELU; the LSTM's gates i, f, g, o;
attention scores scaled by 1/sqrt(D) of the full width D, with the AliBi
bias -(i - j) * m_h on key j for query i (modules.py:52, 126-188)."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

# the type the reference computes in, None for float64 throughout: bf16
# to model a sound bf16 program's rounding, float8 (e4m3, the step below
# bf16) for the control of a bf16 configuration
_LOW = {"dtype": None, "outputs": False}


@contextlib.contextmanager
def low_precision(dtype, outputs: bool = False):
    """Round both operands of every product (matmuls, convs, attention
    scores and values) to `dtype` with a per-tensor scale, as an fp8 GEMM
    takes them; sums stay float64.  outputs: round every stored result
    too (each product's, each norm, activation, softmax, residual sum and
    LSTM state, each served field), as a computation that keeps its
    activations in `dtype` does."""
    _LOW.update(dtype=dtype, outputs=outputs)
    try:
        yield
    finally:
        _LOW.update(dtype=None, outputs=False)


def q(x):
    dt = _LOW["dtype"]
    if dt is None:
        return x
    amax = x.abs().amax().clamp_min(1e-30)
    s = amax / torch.finfo(dt).max
    return (x / s).to(dt).to(x.dtype) * s


def out(x):
    """A result as the computation stores it."""
    return q(x) if _LOW["outputs"] else x


def mm(a, b):
    return out(q(a) @ q(b))


def conv(x, w, b, stride: int, padding: int = 0):
    return out(F.conv1d(q(x), q(w), b, stride=stride, padding=padding))


# (kernel, stride, padding) of the 5 CPC convs (encoder_components.py:83-92)
CPC = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))


def channel_norm_relu(x, w, b):
    """x (N, C, T); w, b (C, 1)."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=True)
    return out(torch.relu((x - mean) / torch.sqrt(var + 1e-5) * w + b))


def layer_norm(x, p):
    return out(F.layer_norm(x, (x.shape[-1],), p["w"], p["b"], 1e-5))


def gelu(x):
    return out(F.gelu(x))


def conv_stack(enc, wav, streaming: bool):
    """(N, L) -> (N, n, C) CPC features at 100 Hz.  streaming: a (k - s)
    zero pad on the left of each conv, no padding on the right (one
    seamless valid conv over the stream); otherwise the symmetric conv
    padding of the offline forward."""
    x = wav[:, None]
    for i, (k, s, p) in enumerate(CPC):
        c, n = enc[f"conv{i}"], enc[f"norm{i}"]
        if streaming:
            x = conv(F.pad(x, (k - s, 0)), c["w"], c["b"], s)
        else:
            x = conv(x, c["w"], c["b"], s, p)
        x = channel_norm_relu(x, n["w"], n["b"])
    return x.transpose(1, 2)


def lstm(z, p):
    """LSTM from zero state over (N, T, C); returns (N, T, H)."""
    N = z.shape[0]
    H = p["w_hh"].shape[1]
    gi = mm(z, p["w_ih"].T) + p["b_ih"]
    h = z.new_zeros((N, H))
    c = z.new_zeros((N, H))
    ys = []
    for t in range(z.shape[1]):
        g = gi[:, t] + mm(h, p["w_hh"].T) + p["b_hh"]
        i, f, gg, o = g.split(H, dim=-1)
        c = out(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg))
        h = out(torch.sigmoid(o) * torch.tanh(c))
        ys.append(h)
    return torch.stack(ys, dim=1)


def downsample(enc, y, kernel: int):
    d = enc["down_conv"]
    x = conv(y.transpose(1, 2), d["w"], d["b"], kernel)
    return gelu(layer_norm(x.transpose(1, 2), enc["down_ln"]))


def slopes(H: int):
    """AliBi slopes for a power-of-two head count (modules.py:126-159)."""
    start = 2 ** (-(2 ** -(math.log2(H) - 3)))
    return [start * start ** i for i in range(H)]


def alibi(T: int, H: int, window: Optional[int], device, dtype):
    """(H, T, T) bias: -(i - j) m_h for keys j in [i - window + 1, i]
    (every j <= i when window is None), -inf elsewhere."""
    i = torch.arange(T, device=device)
    age = (i[:, None] - i[None, :]).to(dtype)
    ok = age >= 0
    if window is not None:
        ok = ok & (age <= window - 1)
    m = torch.tensor(slopes(H), device=device, dtype=dtype)
    bias = -age[None] * m[:, None, None]
    return bias.masked_fill(~ok[None], float("-inf"))


def attention(p, q_in, kv_in, bias, H: int, drop=None):
    """Multi-head attention of (N, T, D) queries over (N, T, D) keys and
    values, bias-free projections; drop(x) is applied to the attention
    weights and then to the projected output (None: inference)."""
    N, T, D = q_in.shape
    Dh = D // H

    def heads(x):
        return x.reshape(N, T, H, Dh).transpose(1, 2)

    qh = heads(mm(q_in, p["q"].T))
    k = heads(mm(kv_in, p["k"].T))
    v = heads(mm(kv_in, p["v"].T))
    s = mm(qh, k.transpose(-1, -2)) / math.sqrt(D) + bias
    a = out(torch.softmax(s, dim=-1))
    if drop is not None:
        a = drop(a)
    y = mm(mm(a, v).transpose(1, 2).reshape(N, T, D), p["proj"].T)
    return y if drop is None else drop(y)


def ffn(p, x, drop=None):
    h = gelu(mm(x, p["w1"].T))
    if drop is not None:
        h = drop(h)
    return mm(h, p["w2"].T)


def layer(p, x, bias, H: int, src=None, drop=None):
    """Pre-LN layer with optional cross-attention whose K/V come from the
    RAW src (modules.py:257-286).  drop: dropout on the attention
    weights and outputs, the FFN hidden layer and each residual branch,
    in that call order."""
    d = drop if drop is not None else (lambda t: t)
    z = layer_norm(x, p["ln_self"])
    x = out(x + d(attention(p["attn"], z, z, bias, H, drop)))
    if src is not None:
        z = layer_norm(x, p["ln_src"])
        x = out(x + d(attention(p["attn_cross"], z, src, bias, H, drop)))
    return out(x + d(ffn(p["ffn"], layer_norm(x, p["ln_ffn"]), drop)))


def combinator(p, x1, x2):
    a = gelu(layer_norm(mm(x1, p["h0_a"].T), p["ln"]))
    b = gelu(layer_norm(mm(x2, p["h0_b"].T), p["ln"]))
    return out(a + b)


def bin_sums(n_bins: int, lo: int, hi: int, device, dtype):
    """(2^(2 n_bins), 2): speaker c's activity summed over bins lo..hi of
    each class; class i's bit 4c + b is speaker c, bin b (objective.py
    :93-110)."""
    idx = torch.arange(2 ** (2 * n_bins), device=device)
    bits = (idx[:, None] >> torch.arange(2 * n_bins, device=device)) & 1
    return bits.reshape(-1, 2, n_bins)[:, :, lo:hi + 1].sum(-1).to(dtype)


def next_speaker(probs, lo: int, hi: int):
    m = bin_sums(4, lo, hi, probs.device, probs.dtype)
    p = mm(probs, m)
    return out(p / (out(p.sum(-1, keepdim=True)) + 1e-5))


def to_tensors(tree, device, dtype=torch.float64):
    """A params tree of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device, dtype) for v in tree]
    return torch.as_tensor(tree, dtype=dtype, device=device)
