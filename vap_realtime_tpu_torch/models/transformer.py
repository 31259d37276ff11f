"""Stereo VAP transformer — AliBi attention, channel GPT, cross-channel GPT.

Port of `vap_realtime_tpu/models/transformer.py`, inference form (no
dropout; the dropout arguments belong to training).  Contract from the
reference (rvap/vap_main/modules.py):

- MHA with separate bias-free Q/K/V/out projections; scores are scaled by
  ``1/sqrt(dim)`` with the FULL model dim (256), not the per-head dim
  (modules.py:52).
- AliBi positional bias: per-head slope m_h, score bias ``j * m_h`` for
  key position j, plus a causal -inf mask (modules.py:161-188); softmax
  is shift-invariant per row, so this equals the relative ``-(i-j) m_h``
  form the incremental path keys on age.  AliBi slopes for 4 heads:
  [2^-2, 2^-4, 2^-6, 2^-8] (modules.py:126-159).
- Optional ``context_limit`` band: key j is masked for query i when
  ``j <= i - context_limit`` (modules.py:196-200).
- Pre-LN layer, bias-free FFN (dff = 3*dim, GELU); cross-attention takes
  K/V from the RAW src, which is not layer-normed (modules.py:276-283).
- The stereo layer runs the shared-weight layer twice with swapped roles;
  both towers read the PRE-update opposite stream (modules.py:289-300).
- Combinator: per-channel bias-free linear -> shared LayerNorm -> GELU,
  then sum (modules.py:449-464).

The attention is an einsum + softmax with an additive bias, as in the
JAX package, so the -inf band and the 1/sqrt(D) scale round as there.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from vap_realtime_tpu_torch.ops.basic import gelu, layer_norm, linear

Params = Dict[str, Any]
Tensor = torch.Tensor


def alibi_slopes(n_heads: int) -> List[float]:
    """AliBi head slopes (modules.py:126-159)."""

    def power_of_2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return power_of_2(n_heads)
    closest = 2 ** math.floor(math.log2(n_heads))
    return (power_of_2(closest)
            + alibi_slopes(2 * closest)[0::2][: n_heads - closest])


@functools.lru_cache(maxsize=None)
def alibi_bias(T: int, num_heads: int, context_limit: int = -1,
               dtype=torch.float32, device=None) -> Tensor:
    """(H, T, T) additive attention bias: j*m_h on/below the diagonal,
    -inf above (and outside the context_limit band when enabled).  Built
    once per shape, dtype and device (its slopes are a host-to-device
    copy, which would stall a step that rebuilt it); read-only."""
    m = torch.tensor(alibi_slopes(num_heads), dtype=dtype, device=device)
    j = torch.arange(T, dtype=dtype, device=device)
    bias = (m[:, None, None] * j[None, None, :]).expand(num_heads, T, T)
    i = torch.arange(T, device=device)
    causal = i[:, None] >= i[None, :]
    if context_limit > 0:
        causal = causal & (i[None, :] > i[:, None] - context_limit)
    return bias.masked_fill(~causal[None], float("-inf"))


def _heads(x: Tensor, H: int) -> Tensor:
    """(B, T, D) -> (B, H, T, D/H)."""
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)


def attend_full(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                allowed=None) -> Tensor:
    """Softmax attention of (B, H, Tq, Dh) queries over (B, H, Tk, Dh)
    keys/values with an additive bias broadcast to (B, H, Tq, Tk); scores
    scaled by 1/sqrt(D) of the FULL width D = H * Dh.  allowed: an
    optional boolean mask of the same broadcast shape; masked scores are
    -inf.  Returns (B, Tq, D)."""
    B, H, Tq, Dh = q.shape
    s = torch.einsum("bhid,bhjd->bhij", q, k) * (1.0 / math.sqrt(H * Dh))
    s = s + bias
    if allowed is not None:
        s = s.masked_fill(~allowed, float("-inf"))
    a = torch.softmax(s, dim=-1)
    y = torch.einsum("bhij,bhjd->bhid", a, v)
    return y.transpose(1, 2).reshape(B, Tq, H * Dh)


def mha(params: Params, q_in: Tensor, kv_in: Tensor, bias: Tensor,
        num_heads: int, allowed=None, kv_out: Optional[list] = None
        ) -> Tensor:
    """Multi-head attention over full sequences.

    q_in: (B, Tq, D); kv_in: (B, Tk, D); bias: (H, Tq, Tk) additive;
    allowed: optional (B, 1, Tq, Tk) boolean mask (see `attend_full`).
    Scale is 1/sqrt(D) with the FULL dim (reference modules.py:52).
    kv_out: a list that receives this call's (k, v), each (B, Tk, D), as
    the KV cache stores them (the hybrid resync rebuilds the cache so).
    """
    k_lin, v_lin = linear(kv_in, params["k"]), linear(kv_in, params["v"])
    if kv_out is not None:
        kv_out.append((k_lin, v_lin))
    q = _heads(linear(q_in, params["q"]), num_heads)
    k, v = _heads(k_lin, num_heads), _heads(v_lin, num_heads)
    return linear(attend_full(q, k, v, bias[None], allowed), params["proj"])


def ffn(params: Params, x: Tensor) -> Tensor:
    """Bias-free FFN: Linear -> GELU -> Linear (modules.py:9-21)."""
    return linear(gelu(linear(x, params["w1"])), params["w2"])


def transformer_layer(params: Params, x: Tensor, bias: Tensor,
                      num_heads: int, src=None, allowed=None,
                      kv_out: Optional[list] = None) -> Tensor:
    """Pre-LN layer with optional cross-attention (modules.py:257-286);
    allowed, kv_out: see `mha` (self-attention's (k, v) first)."""
    z = layer_norm(x, params["ln_self"]["w"], params["ln_self"]["b"])
    x = x + mha(params["attn"], z, z, bias, num_heads, allowed, kv_out)
    if src is not None:
        z = layer_norm(x, params["ln_src"]["w"], params["ln_src"]["b"])
        # K/V come from the RAW src (the reference does not normalise it)
        x = x + mha(params["attn_cross"], z, src, bias, num_heads, allowed,
                    kv_out)
    h = layer_norm(x, params["ln_ffn"]["w"], params["ln_ffn"]["b"])
    return x + ffn(params["ffn"], h)


def gpt_forward(params: Params, x: Tensor, num_heads: int,
                context_limit: int = -1) -> Tensor:
    """Channel-wise GPT: N self-attention layers (modules.py:303-372)."""
    bias = alibi_bias(x.shape[1], num_heads, context_limit, x.dtype,
                      x.device)
    for layer in params["layers"]:
        x = transformer_layer(layer, x, bias, num_heads)
    return x


def combinator(params: Params, x1: Tensor, x2: Tensor) -> Tensor:
    """Merge the ego-centric towers (modules.py:449-464)."""
    ln = params["ln"]
    ha = gelu(layer_norm(linear(x1, params["h0_a"]), ln["w"], ln["b"]))
    hb = gelu(layer_norm(linear(x2, params["h0_b"]), ln["w"], ln["b"]))
    return ha + hb


def gpt_stereo_forward(params: Params, x1: Tensor, x2: Tensor,
                       num_heads: int, context_limit: int = -1
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Cross-channel GPT (modules.py:375-423).  Returns (combined, x1,
    x2)."""
    bias = alibi_bias(x1.shape[1], num_heads, context_limit, x1.dtype,
                      x1.device)
    for layer in params["layers"]:
        # both towers consume the PRE-update opposite stream
        x1, x2 = (transformer_layer(layer, x1, bias, num_heads, src=x2),
                  transformer_layer(layer, x2, bias, num_heads, src=x1))
    return combinator(params["combinator"], x1, x2), x1, x2
