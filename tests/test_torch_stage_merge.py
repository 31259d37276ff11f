"""PyTorch port: the staged merge (`ops/cuda/merge.py`).

`stage_merge` on CPU tensors runs the plain sequence; these tests hold it
against that sequence spelled out (`scatter_rows_multi` for the cache,
the stamps and the row scales, then `fill_(-1)`), bit for bit, in every
element type and int8 mode, with wrapped stamps, invalid rows, an empty
stage and a slot reset's stale stamps.  The CUDA kernel runs only on the
card (chip_smoke.py holds it against the plain version there); here a
numpy replay of its byte addressing and write order
(`csrc/stage_merge.cu`) is held against the same sequence.  Then the
staged serving core with the merge against slots="stream"."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.vap import init_vap_params
from vap_realtime_tpu_torch.ops.cuda import merge
from vap_realtime_tpu_torch.runtime import incremental as inc

S = inc.STAGE_S
MODES = {"bf16": (torch.bfloat16, False), "float32": (torch.float32, False),
         "q8_row": (torch.int8, "row"), "q8_global": (torch.int8, "global")}


def _stamps(rs, case, B, T):
    """(S, B) int32 stage stamps of a case; each stream's valid stamps are
    distinct mod T unless the case is "collide"."""
    base = rs.randint(0, 6 * T, size=B)
    st = base[None, :] + np.arange(S)[:, None]           # wraps the ring
    if case == "mixed":                                  # frozen ticks: -1
        st = np.where(rs.rand(S, B) < 0.3, -1, st)
        st[:, 0] = -1                                    # a stream all -1
    elif case == "empty":
        st[:] = -1
    elif case == "reset":
        # stream 1 reset three ticks before the merge: its older staged
        # rows are a stale occupant's (cleared to -1 by the arena's reset,
        # or left as they were by a caller that resets only the count:
        # stream 2), the newer ones count again from 0
        st[:, 1] = np.r_[np.full(S - 3, -1), np.arange(3)]
        st[:, 2] = np.r_[4 * T + 5 + np.arange(S - 3), np.arange(3)]
    elif case == "collide":
        st[S - 1, :] = st[2, :] + T                      # same ring row
    return torch.as_tensor(st.astype(np.int32))


def _state(mode, case, B=5, T=12, P=7, X=64, seed=0):
    """A random ring, stamps, stage and scales of one mode:
    (cache, stamp, stage, stage_stamp, scale, stage_scale)."""
    dtype, quant = MODES[mode]
    rs = np.random.RandomState(seed)
    if dtype == torch.int8:
        def draw(*shape):
            return torch.as_tensor(rs.randint(-127, 128, shape)
                                   .astype(np.int8))
    else:
        def draw(*shape):
            return torch.as_tensor(rs.randn(*shape).astype(np.float32)
                                   ).to(dtype)
    cache, stage = draw(B, P, T, X), draw(S, B, P * X)
    stamp = torch.as_tensor(rs.randint(-1, 5 * T, (B, T)).astype(np.int32))
    scale = stage_scale = None
    if quant == "row":
        scale = torch.as_tensor(rs.rand(B, P, T).astype(np.float32))
        stage_scale = torch.as_tensor(rs.rand(S, B, P).astype(np.float32))
    return (cache, stamp, stage, _stamps(rs, case, B, T), scale,
            stage_scale)


def _clone(ts):
    return [None if t is None else t.clone() for t in ts]


def _sequence(cache, stamp, stage, stage_stamp, scale, stage_scale):
    """The plain merge, spelled out: three row scatters and a fill."""
    B, P, T = cache.shape[:3]
    valid = stage_stamp >= 0
    idx = torch.remainder(stage_stamp, T)
    merge.scatter_rows_multi(cache, stage.view(S, B, P, -1), idx, valid)
    merge.scatter_rows_multi(stamp.view(B, 1, T, 1),
                             stage_stamp.view(S, B, 1, 1), idx, valid)
    if scale is not None:
        merge.scatter_rows_multi(scale[..., None], stage_scale[..., None],
                                 idx, valid)
    stage_stamp.fill_(-1)


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


def _replay(cache, stamp, stage, stage_stamp, scale, stage_scale):
    """The kernel's addressing in numpy, on byte views: per stream, the
    stage stamps read once, each valid staged row's vectors v copied in
    stage order to ring byte b*P*plane + p*plane + (st % T)*row_bytes +
    (v - p*row_vecs)*V with p = v // row_vecs, then stamps, scales and the
    reset, V = 16.  Returns the new (cache, stamp, scale, stage_stamp) as
    numpy."""
    V = 16
    B, P, T, X = cache.shape
    row_bytes = X * cache.element_size()
    plane = T * row_bytes
    row_vecs = row_bytes // V
    ring, src = _bytes(cache).copy(), _bytes(stage)
    stamp_o = stamp.numpy().copy().reshape(-1)
    scale_o = None if scale is None else scale.numpy().copy().reshape(-1)
    sst = stage_stamp.numpy().copy()
    v = np.arange(P * row_vecs)
    p = v // row_vecs
    lane = np.arange(V)
    for b in range(B):
        s_stamp = sst[:, b].copy()
        for i in range(S):
            st = s_stamp[i]
            if st < 0:
                continue
            dst = (b * P * plane + (st % T) * row_bytes + p * plane
                   + (v - p * row_vecs) * V)
            at = (i * B + b) * P * row_bytes + v * V
            ring[(dst[:, None] + lane).reshape(-1)] = \
                src[(at[:, None] + lane).reshape(-1)]
        for i in range(S):
            if s_stamp[i] >= 0:
                stamp_o[b * T + s_stamp[i] % T] = s_stamp[i]
        if scale_o is not None:
            ssc = stage_scale.numpy().reshape(-1)
            for pp in range(P):
                for i in range(S):
                    if s_stamp[i] >= 0:
                        scale_o[(b * P + pp) * T + s_stamp[i] % T] = \
                            ssc[(i * B + b) * P + pp]
        sst[:, b] = -1
    return ring, stamp_o, scale_o, sst


@pytest.mark.parametrize("case", ["mixed", "empty", "reset"])
@pytest.mark.parametrize("mode", list(MODES))
def test_stage_merge_cpu_equals_the_plain_sequence(mode, case):
    """Ring, stamps and row scales bit-equal to the sequence, the stage
    marked empty, and no kernel launch counted for CPU tensors."""
    ts = _state(mode, case, seed=len(mode) + 7 * len(case))
    want = _clone(ts)
    _sequence(*want)
    launches = merge.stage_merge.launches
    got = _clone(ts)
    merge.stage_merge(*got)
    assert merge.stage_merge.launches == launches
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)
    assert (got[3] == -1).all()
    if case == "empty":                  # nothing valid: the ring unchanged
        assert torch.equal(got[0], ts[0]) and torch.equal(got[1], ts[1])
    else:
        assert not torch.equal(got[0], ts[0])


@pytest.mark.parametrize("case", ["mixed", "empty", "reset", "collide"])
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_addressing_replay_equals_the_plain_sequence(mode, case):
    """The kernel's byte addressing and write order, replayed in numpy,
    against the sequence; a ragged batch and a row width that is not a
    multiple of the block.  "collide" gives two staged rows of a stream
    one ring row (the serving step never does): the later one wins in
    both."""
    ts = _state(mode, case, B=7, T=10, P=3, X=48, seed=3 + len(case))
    want = _clone(ts)
    _sequence(*want)
    ring, stamp, scale, sst = _replay(*ts)
    assert np.array_equal(ring, _bytes(want[0]))
    assert np.array_equal(stamp, want[1].numpy().reshape(-1))
    if scale is not None:
        assert np.array_equal(scale, want[4].numpy().reshape(-1))
    assert (sst == -1).all()


def test_stage_merge_refuses_what_the_kernel_does_not_take():
    """A tensor neither on the CPU nor on a CUDA device raises; nothing
    falls back to the plain version."""
    ts = [None if t is None else t.to("meta")
          for t in _state("bf16", "mixed")]
    with pytest.raises(ValueError, match="unsupported device"):
        merge.stage_merge(*ts)


@pytest.mark.parametrize("attend_impl", ["kernel", "einsum"])
def test_kv_core_staged_merge_equals_stream(attend_impl):
    """`_kv_core` with staged slots and merge="auto" over 24 ticks (three
    merges, the 20-row ring wrapped, frozen ticks) against slots="stream"
    on the same embeddings: the outputs at the staged-vs-stream
    tolerances, and right after each merge the stamps bit-equal, the
    cache at float32 rounding, the stage empty."""
    cfg = VapConfig(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
                    context_len_sec=1.0)                    # T = 20
    params = init_vap_params(torch.Generator().manual_seed(5), cfg)
    B, D = 3, cfg.dim
    st_s = inc.init_kv_state(cfg, B)
    st_g = inc.init_kv_state(cfg, B, staged=True)
    rs = np.random.RandomState(4)
    merges = 0
    for f in range(24):
        e = torch.as_tensor(rs.randn(B, 2, D).astype(np.float32))
        h = torch.as_tensor(rs.randn(B, 2, D).astype(np.float32))
        c = torch.as_tensor(rs.randn(B, 2, D).astype(np.float32))
        act = torch.as_tensor(np.array([True, f % 2 == 0, f % 3 != 0])
                              & (f != 5))
        out_s = inc._kv_core(params, st_s, e, h, c, cfg, act, "stream",
                             attend_impl)
        out_g = inc._kv_core(params, st_g, e, h, c, cfg, act, "staged",
                             attend_impl, merge="auto")
        np.testing.assert_allclose(out_g["p_now"][0].numpy(),
                                   out_s["p_now"][0].numpy(), atol=2e-5)
        if (f + 1) % S == 0:
            merges += 1
            assert torch.equal(st_g.stamp, st_s.stamp)
            assert torch.equal(st_g.cache[:, 0], st_s.cache[:, 0])
            np.testing.assert_allclose(st_g.cache.numpy(),
                                       st_s.cache.numpy(), atol=1e-6)
            assert (st_g.stage_stamp == -1).all()
    assert merges == 3 and st_s.stamp[0].max() >= cfg.context_frames
