"""PyTorch port: K10's int8 body (the compact attend on an int8 cache,
`vap_realtime_tpu_torch/csrc/attend_pair.cu` `attend_q8_kernel`).

The kernel runs only on the card.  Here a plain-torch replay of its order
of operations — the plane in chunks of rows, the two-pass compact softmax
per chunk with the running state rescaled once per chunk, the row scale
folded into the weight after the denominator, the V sum in interleaved
row groups, the int8-to-float bit trick — is held against the JAX
package's `fused_attend_pair(impl="compact")` in interpret mode, on int8
caches with row scales and under the frozen-scale fold, with float32 q."""

import os
import re

import numpy as np
import pytest
import torch

from vap_realtime_tpu.ops.pallas.attend import fused_attend_pair
from vap_realtime_tpu_torch.ops.cuda.attend import DEAD, _prescale, _slopes

SRC = os.path.join(os.path.dirname(__file__), "..", "vap_realtime_tpu_torch",
                   "csrc", "attend_pair.cu")
# the kernel's chunk geometry (attend_pair.cu: kQ8Stage, kQ8Threads),
# checked against the source below
STAGE, THREADS = 52 * 1024, 256
MAGIC = 8388736.0  # 2^23 + 128
B, P, D, H = 3, 2, 256, 4
C_GLOBAL = 1 / 127  # the frozen scale of the fold (k and v alike)


def codes_to_float(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes -> float32 as the kernel's `codes4`: the code with its
    sign bit flipped (x + 128) as the low mantissa byte of 2^23, minus
    2^23 + 128."""
    u = (codes.to(torch.int32) & 0xFF) ^ 0x80
    return (u | 0x4B000000).view(torch.float32) - MAGIC


def geometry(T: int, row_bytes: int):
    """(rows a chunk, V row groups) of the kernel for T rows."""
    rows = T if T * row_bytes <= STAGE else STAGE // row_bytes
    return rows, max(1, THREADS // (32 * H))


def replay(cache, q2, kc2, vc2, age, scale, pair_base):
    """K10's int8 body in plain torch, float32, in the kernel's order."""
    Bn, _, T, D4 = cache.shape
    J = 2 * H
    q = _prescale(q2, "compact")
    m = _slopes(H, "cpu", 1.0).repeat(2)                        # (J,)
    plane = codes_to_float(cache[:, pair_base // 2])            # (B, T, 4D)
    kv = plane.view(Bn, T, 2, 2, D)                  # (set, k|v, column)

    def pairs(p):
        return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])

    def head_dot(x, y, words):
        """(.., 2, D) . (.., 2, D) -> (.., J): each of a head's 4 threads
        sums its 16 products in order (words=True, the K rows: one sum per
        4 codes, then (w0+w1) + (w2+w3)); the threads then add up as
        (t0+t1) + (t2+t3)."""
        x = x.reshape(*x.shape[:-2], 2, H, 4, 16)
        y = y.reshape(*y.shape[:-2], 2, H, 4, 16)
        if words:
            x, y = x.unflatten(-1, (4, 4)), y.unflatten(-1, (4, 4))
        p = torch.zeros(x.shape[:-1])
        for i in range(x.shape[-1]):
            p = p + x[..., i] * y[..., i]
        s = pairs(pairs(p) if words else p)
        return s.reshape(*s.shape[:-2], J)

    s = head_dot(kv[:, :, :, 0], q[:, None], True)             # (B, T, J)
    if scale is not None:
        s = s * scale[..., None]
    s = s - age[..., None] * m
    # the running state starts at the current position: max s_cur,
    # denominator 1, and v_cur in row group 0
    mrun, drun = head_dot(kc2, q, False), torch.ones(Bn, J)
    rows, G = geometry(T, D4)
    acc = [vc2.clone()] + [torch.zeros_like(vc2) for _ in range(G - 1)]
    cols = lambda x: x.reshape(*x.shape[:-1], 2, H, 1).expand(
        *x.shape[:-1], 2, H, D // H).reshape(*x.shape[:-1], 2, D)
    for c0 in range(0, T, rows):
        sc = s[:, c0:c0 + rows]
        mx = torch.maximum(mrun, sc.amax(1))
        e = torch.exp(sc - mx[:, None])
        corr = torch.where(mrun == mx, 1.0, torch.exp(mrun - mx))
        drun = drun * corr + e.sum(1)
        mrun = mx
        if scale is not None:   # the value dequant, after the denominator
            e = e * scale[:, c0:c0 + rows, None]
        w = cols(e)                                          # (B, n, 2, D)
        for g in range(G):
            acc[g] = acc[g] * cols(corr)
            for r in range(g, sc.shape[1], G):
                acc[g] = acc[g] + w[:, r] * kv[:, c0 + r, :, 1]
    total = acc[0]
    for g in range(1, G):
        total = total + acc[g]
    return total / cols(drun)


def test_code_trick_is_exact_for_every_code():
    """The byte-permute conversion gives every one of the 256 codes
    exactly."""
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = codes_to_float(codes)
    assert torch.equal(got, codes.float())
    assert got.dtype == torch.float32


def test_replay_geometry_matches_kernel_source():
    """The replay's chunk geometry is the kernel's: its constants as the
    source states them."""
    src = open(SRC).read()
    const = lambda name: eval(re.search(
        rf"constexpr int {name} = ([0-9 *]+);", src).group(1))
    assert (const("kQ8Stage"), const("kQ8Threads")) == (STAGE, THREADS)
    assert f"constexpr float kQ8Magic = {int(MAGIC)}.f;" in src
    # T=50 (the serving plane) is one chunk; T=70 two (52 + 18 rows)
    assert geometry(50, 4 * D) == (50, 2)
    assert geometry(70, 4 * D) == (52, 2)


CASES = [("T12", "row"), ("T12", "global"), ("T1", "row"), ("T1", "global"),
         ("T70", "row"), ("T70", "global"), ("dead", "row"),
         ("dead", "global"), ("zero_scale", "row"), ("big_score", "row"),
         ("big_score", "global")]


def _inputs(case, seed):
    rs = np.random.RandomState(seed)
    T = {"T1": 1, "T70": 70}.get(case, 12)
    f = lambda *s: (0.3 * rs.randn(*s)).astype(np.float32)
    cache = rs.randint(-127, 128, (B, P, T, 4 * D)).astype(np.int8)
    q, kc, vc = f(B, 2, D), f(B, 2, D), f(B, 2, D)
    sc = (rs.uniform(0.5, 1.5, (B, P, T)) / 127).astype(np.float32)
    age = rs.randint(1, T + 1, (B, T)).astype(np.float32)
    age[rs.rand(B, T) < 0.35] = DEAD
    if case == "dead":
        age[:] = DEAD
    elif case == "zero_scale":
        sc[rs.rand(B, P, T) < 0.3] = 0.0
    elif case == "big_score":
        # stream 1, set 0, phase 1: q 100x larger, row 5's K along sign(q),
        # live, scale 1: its score (~1e4 with row scales, ~1e2 folded)
        # takes every head's softmax
        q[1, 0] *= 100
        cache[1, 1, 5, :D] = 127 * np.sign(q[1, 0]).astype(np.int8)
        age[1, 5], sc[1, 1, 5] = 1.0, 1.0
    return cache, q, kc, vc, age, sc


@pytest.mark.parametrize("case,mode", CASES)
def test_q8_replay_matches_pallas_kernel(case, mode):
    """The replay against fused_attend_pair(impl="compact",
    interpret=True), phase 1, float32 q: row scales at atol 2e-4 (as
    tests/test_torch_compact.py), the frozen-scale fold (q * c, k_cur /
    c, v_cur / c; the output times c, in float units, as the step reads
    it) at 2e-5.  All-DEAD rows give v_cur exactly."""
    cache, q, kc, vc, age, sc = _inputs(case, seed=3)
    phase = 1
    scale = sc[:, phase] if mode == "row" else None
    unit = 1.0
    if mode == "global":
        q, kc, vc, unit = q * C_GLOBAL, kc / C_GLOBAL, vc / C_GLOBAL, C_GLOBAL
    want = np.asarray(fused_attend_pair(
        cache, q, kc, vc, age, scale=scale, interpret=True, impl="compact",
        pair_base=2 * phase, num_heads=H))
    got = replay(*map(torch.as_tensor, (cache, q, kc, vc, age)),
                 None if scale is None else torch.as_tensor(scale),
                 2 * phase)
    if case == "big_score":  # out = row 5's v (scale 1)
        v5 = codes_to_float(torch.as_tensor(cache[1, phase, 5, D:2 * D]))
        np.testing.assert_allclose(got[1, 0].numpy() * unit,
                                   v5.numpy() * unit, atol=1e-6)
    atol = 2e-4 if mode == "row" else 2e-5
    np.testing.assert_allclose(got.numpy() * unit, want * unit, atol=atol,
                               err_msg=f"{case} {mode}")
    if case == "dead":
        assert torch.equal(got, torch.as_tensor(vc))
    assert torch.isfinite(got).all()
