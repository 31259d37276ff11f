"""Stereo VAP transformer pieces used by the incremental step.

- AliBi slopes per head (reference modules.py:126-159); for 4 heads
  [2^-2, 2^-4, 2^-6, 2^-8].
- Combinator: per-channel bias-free linear -> shared LayerNorm -> GELU,
  then sum (modules.py:449-464).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from vap_realtime_tpu_torch.ops.basic import gelu, layer_norm, linear

Params = Dict[str, Any]


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


def combinator(params: Params, x1: torch.Tensor,
               x2: torch.Tensor) -> torch.Tensor:
    """Merge the ego-centric towers (modules.py:449-464)."""
    ln = params["ln"]
    ha = gelu(layer_norm(linear(x1, params["h0_a"]), ln["w"], ln["b"]))
    hb = gelu(layer_norm(linear(x2, params["h0_b"]), ln["w"], ln["b"]))
    return ha + hb
