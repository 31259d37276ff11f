"""Stereo VAP transformer — AliBi attention, channel GPT, cross-channel GPT.

Port of `vap_realtime_tpu/models/transformer.py`.  Contract from the
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

Dropout (training) sits where the JAX package puts it: on the attention
weights and the projected output inside `mha`, on the hidden layer
inside `ffn`, and on each residual branch of `transformer_layer`.  Its
masks come from an explicit `torch.Generator`: `gpt_forward` gives each
layer its own stream, `fold_in(generator, i)` (the role of
`jax.random.fold_in`), and a layer draws its masks from that stream in
call order.  The masks never equal JAX's.  With no generator every
function is the inference function.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vap_realtime_tpu_torch.ops.basic import gelu, layer_norm, linear

Params = Dict[str, Any]
Tensor = torch.Tensor
Gen = Optional[torch.Generator]


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


def alibi_bias(T: int, num_heads: int, context_limit: int = -1,
               dtype=torch.float32, device=None) -> Tensor:
    """(H, T, T) additive attention bias: j*m_h on/below the diagonal,
    -inf above (and outside the context_limit band when enabled).  Built
    once per shape, dtype and device (its slopes are a host-to-device
    copy, which would stall a step that rebuilt it); read-only.  While a
    graph is traced (`torch.export`) it is built anew and not cached, so
    the cache never holds a traced stand-in for a tensor."""
    if torch.compiler.is_compiling():
        return _alibi_bias(T, num_heads, context_limit, dtype, device)
    return _alibi_bias_cached(T, num_heads, context_limit, dtype, device)


def _alibi_bias(T: int, num_heads: int, context_limit: int, dtype,
                device) -> Tensor:
    m = torch.tensor(alibi_slopes(num_heads), dtype=dtype, device=device)
    j = torch.arange(T, dtype=dtype, device=device)
    bias = (m[:, None, None] * j[None, None, :]).expand(num_heads, T, T)
    i = torch.arange(T, device=device)
    causal = i[:, None] >= i[None, :]
    if context_limit > 0:
        causal = causal & (i[None, :] > i[:, None] - context_limit)
    return bias.masked_fill(~causal[None], float("-inf"))


_alibi_bias_cached = functools.lru_cache(maxsize=None)(_alibi_bias)


def fold_in(generator: Gen, i: int) -> Gen:
    """A new generator on `generator`'s device, seeded from its seed and
    `i` (the role of `jax.random.fold_in`): it neither reads nor
    advances `generator`'s state.  None stays None."""
    if generator is None:
        return None
    state = np.random.SeedSequence([generator.initial_seed(), i])
    seed = int(state.generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=generator.device).manual_seed(seed)


def _dropout(x: Tensor, rate: float, generator: Gen) -> Tensor:
    """Inverted dropout, the JAX form ``where(mask, x / keep, 0)`` with a
    Bernoulli(keep) mask drawn from `generator`; x itself when there is
    no generator or the rate is 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _heads(x: Tensor, H: int) -> Tensor:
    """(B, T, D) -> (B, H, T, D/H)."""
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)


def attend_full(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                allowed=None, dropout: float = 0.0,
                generator: Gen = None) -> Tensor:
    """Softmax attention of (B, H, Tq, Dh) queries over (B, H, Tk, Dh)
    keys/values with an additive bias broadcast to (B, H, Tq, Tk); scores
    scaled by 1/sqrt(D) of the FULL width D = H * Dh.  allowed: an
    optional boolean mask of the same broadcast shape; masked scores are
    -inf.  dropout / generator: dropout on the attention weights.
    Returns (B, Tq, D)."""
    B, H, Tq, Dh = q.shape
    s = torch.einsum("bhid,bhjd->bhij", q, k) * (1.0 / math.sqrt(H * Dh))
    s = s + bias
    if allowed is not None:
        s = s.masked_fill(~allowed, float("-inf"))
    a = _dropout(torch.softmax(s, dim=-1), dropout, generator)
    y = torch.einsum("bhij,bhjd->bhid", a, v)
    return y.transpose(1, 2).reshape(B, Tq, H * Dh)


def mha(params: Params, q_in: Tensor, kv_in: Tensor, bias: Tensor,
        num_heads: int, allowed=None, kv_out: Optional[list] = None,
        dropout: float = 0.0, generator: Gen = None) -> Tensor:
    """Multi-head attention over full sequences.

    q_in: (B, Tq, D); kv_in: (B, Tk, D); bias: (H, Tq, Tk) additive;
    allowed: optional (B, 1, Tq, Tk) boolean mask (see `attend_full`).
    Scale is 1/sqrt(D) with the FULL dim (reference modules.py:52).
    kv_out: a list that receives this call's (k, v), each (B, Tk, D), as
    the KV cache stores them (the hybrid resync rebuilds the cache so).
    dropout / generator: dropout on the attention weights, then on the
    projected output.
    """
    k_lin, v_lin = linear(kv_in, params["k"]), linear(kv_in, params["v"])
    if kv_out is not None:
        kv_out.append((k_lin, v_lin))
    q = _heads(linear(q_in, params["q"]), num_heads)
    k, v = _heads(k_lin, num_heads), _heads(v_lin, num_heads)
    y = linear(attend_full(q, k, v, bias[None], allowed, dropout, generator),
               params["proj"])
    return _dropout(y, dropout, generator)


def ffn(params: Params, x: Tensor, dropout: float = 0.0,
        generator: Gen = None) -> Tensor:
    """Bias-free FFN: Linear -> GELU -> Dropout -> Linear
    (modules.py:9-21)."""
    h = _dropout(gelu(linear(x, params["w1"])), dropout, generator)
    return linear(h, params["w2"])


def transformer_layer(params: Params, x: Tensor, bias: Tensor,
                      num_heads: int, src=None, allowed=None,
                      kv_out: Optional[list] = None, dropout: float = 0.0,
                      generator: Gen = None) -> Tensor:
    """Pre-LN layer with optional cross-attention (modules.py:257-286);
    allowed, kv_out: see `mha` (self-attention's (k, v) first).
    dropout / generator: dropout inside both attentions and the FFN and
    on each residual branch, the masks drawn from `generator` in call
    order."""
    z = layer_norm(x, params["ln_self"]["w"], params["ln_self"]["b"])
    a = mha(params["attn"], z, z, bias, num_heads, allowed, kv_out,
            dropout, generator)
    x = x + _dropout(a, dropout, generator)
    if src is not None:
        z = layer_norm(x, params["ln_src"]["w"], params["ln_src"]["b"])
        # K/V come from the RAW src (the reference does not normalise it)
        c = mha(params["attn_cross"], z, src, bias, num_heads, allowed,
                kv_out, dropout, generator)
        x = x + _dropout(c, dropout, generator)
    h = layer_norm(x, params["ln_ffn"]["w"], params["ln_ffn"]["b"])
    f = ffn(params["ffn"], h, dropout, generator)
    return x + _dropout(f, dropout, generator)


def gpt_forward(params: Params, x: Tensor, num_heads: int,
                context_limit: int = -1, dropout: float = 0.0,
                generator: Gen = None) -> Tensor:
    """Channel-wise GPT: N self-attention layers (modules.py:303-372);
    layer i draws its dropout masks from `fold_in(generator, i)`."""
    bias = alibi_bias(x.shape[1], num_heads, context_limit, x.dtype,
                      x.device)
    for i, layer in enumerate(params["layers"]):
        x = transformer_layer(layer, x, bias, num_heads, dropout=dropout,
                              generator=fold_in(generator, i))
    return x


def combinator(params: Params, x1: Tensor, x2: Tensor) -> Tensor:
    """Merge the ego-centric towers (modules.py:449-464)."""
    ln = params["ln"]
    ha = gelu(layer_norm(linear(x1, params["h0_a"]), ln["w"], ln["b"]))
    hb = gelu(layer_norm(linear(x2, params["h0_b"]), ln["w"], ln["b"]))
    return ha + hb


def gpt_stereo_forward(params: Params, x1: Tensor, x2: Tensor,
                       num_heads: int, context_limit: int = -1,
                       dropout: float = 0.0, generator: Gen = None
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Cross-channel GPT (modules.py:375-423); layer i's towers draw
    their dropout masks from `fold_in(generator, 2i)` and `(2i + 1)`.
    Returns (combined, x1, x2)."""
    bias = alibi_bias(x1.shape[1], num_heads, context_limit, x1.dtype,
                      x1.device)
    for i, layer in enumerate(params["layers"]):
        # both towers consume the PRE-update opposite stream
        x1, x2 = (transformer_layer(layer, x1, bias, num_heads, src=x2,
                                    dropout=dropout,
                                    generator=fold_in(generator, 2 * i)),
                  transformer_layer(layer, x2, bias, num_heads, src=x1,
                                    dropout=dropout,
                                    generator=fold_in(generator, 2 * i + 1)))
    return combinator(params["combinator"], x1, x2), x1, x2


# ----------------------------------------------------------------------------
# init (the JAX package's tree, shapes and distributions)
# ----------------------------------------------------------------------------

def init_linear(generator: torch.Generator, out_dim: int, in_dim: int,
                std: float = 0.02, dtype=torch.float32,
                device=None) -> Tensor:
    """GPT init: normal(0, std) (modules.py:347-354)."""
    return torch.randn(out_dim, in_dim, generator=generator,
                       device=device).to(dtype) * std


def init_transformer_layer_params(generator: torch.Generator, dim: int,
                                  ffn_dim: int, cross: bool,
                                  dtype=torch.float32, device=None
                                  ) -> Params:
    lin = lambda o, i: init_linear(generator, o, i, dtype=dtype,
                                   device=device)
    ln = lambda: {"w": torch.ones(dim, dtype=dtype, device=device),
                  "b": torch.zeros(dim, dtype=dtype, device=device)}
    attn = lambda: {k: lin(dim, dim) for k in ("q", "k", "v", "proj")}
    p: Params = {"ln_self": ln(), "attn": attn(), "ln_ffn": ln(),
                 "ffn": {"w1": lin(ffn_dim, dim), "w2": lin(dim, ffn_dim)}}
    if cross:
        p["ln_src"] = ln()
        p["attn_cross"] = attn()
    return p


def init_gpt_params(generator: torch.Generator, dim: int, ffn_dim: int,
                    num_layers: int, cross: bool = False,
                    with_combinator: bool = False, dtype=torch.float32,
                    device=None) -> Params:
    p: Params = {"layers": [
        init_transformer_layer_params(generator, dim, ffn_dim, cross,
                                      dtype, device)
        for _ in range(num_layers)]}
    if with_combinator:
        p["combinator"] = {
            "h0_a": init_linear(generator, dim, dim, dtype=dtype,
                                device=device),
            "h0_b": init_linear(generator, dim, dim, dtype=dtype,
                                device=device),
            "ln": {"w": torch.ones(dim, dtype=dtype, device=device),
                   "b": torch.zeros(dim, dtype=dtype, device=device)},
        }
    return p
