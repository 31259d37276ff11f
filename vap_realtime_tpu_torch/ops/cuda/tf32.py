"""The 3xTF32 product of the tensor-core kernels, emulated on the CPU.

`csrc/cpc_conv_tail.cu` (K9) and `csrc/lstm_scan.cu` (K5) take their
float32 products on Hopper's tensor cores as 3xTF32 (`csrc/tf32_mma.cuh`):
each float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
by `cvt.rna.tf32.f32` (round to nearest, ties away from zero, the 13 low
mantissa bits cleared), and a b is summed as hi_a hi_b + (hi_a lo_b +
lo_a hi_b) in float32.  `tf32_split` reproduces that rounding bit for bit
and `matmul_3xtf32` the product (`matmul_3xtf32_ksplit` as K5's sequence
body sums it: K in consecutive slices, their partial products added in K
order), so the CPU tests keep the evidence for the rounding choice the
card's kernels rely on.  Only tests use them.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_LOW = (1 << 13) - 1          # the mantissa bits TF32 drops
_HALF = 1 << 12               # half a TF32 unit in the last place


def tf32_round(x: Tensor) -> Tensor:
    """float32 -> float32 rounded to TF32 as `cvt.rna.tf32.f32` rounds:
    to nearest, ties away from zero (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    # sign-magnitude: adding half an ulp to the bits rounds the magnitude
    # half away from zero whatever the sign
    return ((bits + _HALF) & ~_LOW).view(torch.float32)


def tf32_split(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi); x - hi is exact in
    float32."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def matmul_3xtf32(a: Tensor, b: Tensor) -> Tensor:
    """a @ b (float32) as the kernels take it: hi_a hi_b + (hi_a lo_b +
    lo_a hi_b), every product of two TF32 values exact in float32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def matmul_3xtf32_ksplit(a: Tensor, b: Tensor, parts: int) -> Tensor:
    """a @ b as K5's sequence body takes it: K cut into `parts`
    consecutive slices, each slice's product in 3xTF32 (one warp's
    accumulator), the partial products added in K order (the shared-memory
    reduction)."""
    k = a.shape[-1] // parts
    out = None
    for j in range(parts):
        p = matmul_3xtf32(a[..., j * k:(j + 1) * k], b[j * k:(j + 1) * k])
        out = p if out is None else out + p
    return out
