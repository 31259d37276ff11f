"""PyTorch port: the 3xTF32 rounding contract of the tensor-core kernels
(K9 `cpc_conv_tail`, K5 `lstm_scan`), emulated on the CPU.

The card's kernels split each float32 operand with `cvt.rna.tf32.f32`
and sum hi hi + (hi lo + lo hi).  `ops/cuda/tf32.py` emulates that bit for
bit; these tests hold the emulated plain versions against float64 runs,
which is the evidence that 3xTF32 keeps the kernels' float32 contracts
(K9 atol 1e-4, K5 1e-5) where one TF32 pass does not."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.ops.cuda.cpc_conv import (
    cpc_conv_tail_plain, pack_tail_params,
)
from vap_realtime_tpu_torch.ops.cuda.lstm import (
    SEQ_K_SPLITS, lstm_scan_plain,
)
from vap_realtime_tpu_torch.ops.cuda.tf32 import (
    matmul_3xtf32, matmul_3xtf32_ksplit, tf32_round, tf32_split,
)
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params


def _matmul_1xtf32(a, b):
    """One TF32 pass: both operands rounded, the product in float32."""
    return tf32_round(a) @ tf32_round(b)


@pytest.fixture(scope="module")
def enc():
    return params_to_torch(synthetic_params(20)["encoder"], "cpu")


def test_tf32_round_is_round_to_nearest_ties_away():
    """cvt.rna: 13 low mantissa bits cleared, to nearest, ties away from
    zero in either sign; TF32 values (and bf16 ones) are fixed points."""
    ulp = 2.0 ** -10                                   # TF32 ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3 * 2.0 ** -100, 1 + ulp, 0.0,
                      -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp,
                         3 * 2.0 ** -100, 1 + ulp, 0.0, -0.0],
                        dtype=torch.float32)
    got = tf32_round(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    rs = np.random.RandomState(0)
    v = torch.from_numpy((rs.randn(4096) * 10.0 ** rs.uniform(-20, 20, 4096))
                         .astype(np.float32))
    hi = tf32_round(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(tf32_round(hi), hi)
    bf = v.bfloat16().float()
    assert torch.equal(tf32_round(bf), bf)
    # against float64 arithmetic: |hi - v| <= half a TF32 ulp of v
    e = torch.floor(torch.log2(v.double().abs()))
    assert bool(((hi.double() - v.double()).abs()
                 <= 2.0 ** (e - 11) * (1 + 1e-12)).all())


def test_tf32_split_reconstructs_to_2_pow_minus_21():
    """hi + lo gives x back to 2^-21 relative (hi carries 11 significant
    bits, lo the next 11)."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy((rs.randn(1 << 16) * 10.0 ** rs.uniform(-8, 8,
                                                                1 << 16))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    assert rel.max().item() <= 2.0 ** -21


def _tail_errors(enc, matmul):
    """max |plain(matmul) - float64 run| of K9's plain version on 32
    channel-streams x L0 = 224 (20 Hz) with the synthetic tail weights."""
    packed = pack_tail_params(enc)
    rs = np.random.RandomState(2)
    x0 = torch.from_numpy(np.maximum(rs.randn(32, 224, 256), 0)
                          .astype(np.float32))
    ref = cpc_conv_tail_plain(x0.double(), packed)
    got = cpc_conv_tail_plain(x0, packed, matmul=matmul)
    return (got.double() - ref).abs().max().item()


def test_cpc_tail_3xtf32_within_1e5_of_float64(enc):
    """K9's arithmetic in 3xTF32 stays within 1e-5 of a float64 run (the
    float32 contract against the plain version is 1e-4); one TF32 pass
    does not hold the 1e-4 contract."""
    err3 = _tail_errors(enc, matmul_3xtf32)
    err32 = _tail_errors(enc, torch.matmul)
    assert err3 <= 1e-5, err3
    assert err3 <= 4 * max(err32, 1e-7), (err3, err32)
    assert _tail_errors(enc, _matmul_1xtf32) > 1e-4


@pytest.mark.parametrize("T", [5, 10, 1998])
def test_lstm_3xtf32_within_1e6_of_float64(T):
    """K5's recurrence in 3xTF32 stays within 1e-6 of a float64 run (its
    float32 contract against the plain version is 1e-5): the serving
    body's product at 20 Hz (T = 5) and 10 Hz (T = 10), 512 streams; and
    at the training encoder's length (16 streams, T = 1998, 20 s) the
    sequence body's summation order at both its cluster sizes
    (`matmul_3xtf32_ksplit`: the K slices in 3xTF32, their partial sums
    added in K order, then added to gi + b_hh)."""
    rs = np.random.RandomState(3)
    B, H = (16 if T == 1998 else 512), 256
    gi = torch.from_numpy((0.5 * rs.randn(B, T, 4 * H)).astype(np.float32))
    h0, c0 = (torch.from_numpy((0.1 * rs.randn(B, H)).astype(np.float32))
              for _ in range(2))
    w = torch.from_numpy((rs.randn(H, 4 * H) / 16).astype(np.float32))
    b = torch.from_numpy((0.06 * rs.randn(4 * H)).astype(np.float32))
    ref = lstm_scan_plain(gi.double(), h0.double(), c0.double(), w, b)
    matmuls = ([matmul_3xtf32] if T != 1998 else
               [lambda a, b, ks=ks: matmul_3xtf32_ksplit(a, b, ks)
                for ks in SEQ_K_SPLITS.values()])
    for matmul in matmuls:
        got = lstm_scan_plain(gi, h0, c0, w, b, matmul=matmul)
        for a, r in zip(got, ref):
            assert a.dtype == torch.float32
            assert (a.double() - r).abs().max().item() <= 1e-6
