"""PyTorch port: the KV step's three seams — the cache's format
(`runtime/cache_format.py`: each format's encode and decode against the
formulas written out, the resync's ring re-encode), the slot policies'
writers (placement, frozen streams untouched) and the checks of the
(slots, attend_impl, state) combination."""

import re

import pytest
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime import cache_format as cf
from vap_realtime_tpu_torch.runtime import incremental as inc

CFG = VapConfig(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
                context_len_sec=1.0)                           # T = 20
B, D, T, S = 3, 64, 20, inc.STAGE_S
P = len(inc.cache_layout(CFG)) // 4
ACTIVE = torch.tensor([True, False, True])


def _rows(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g)
            * torch.rand(*shape[:-1], 1, generator=g) * 3)


def _codes(f, sc):
    return torch.clamp(torch.round(f / sc), -127, 127).to(torch.int8)


def _global_formula(f, gscale, active):
    """f (B, n, 4, D/4), gscale (B, n', 4) with n' = n or 1 (the whole
    ring): unset scales of active streams take 1.5 x max-abs / 127."""
    amax = f.abs().amax(-1)                                    # (B, n, 4)
    if gscale.shape[1] == 1:
        amax = amax.amax(1, keepdim=True)
    fresh = torch.clamp(amax * (1.5 / 127.0), min=1e-8)
    gs = torch.where((gscale == 0) & active[:, None, None], fresh, gscale)
    return gs, torch.where(gs == 0, 1.0, gs)


@pytest.mark.parametrize("quant", [False, True, "row", "global"])
def test_encode_then_decode_matches_the_formulas(quant):
    """A frame's rows encoded into its planes (the K/V codes, the row
    scales where the format keeps them), then placed in ring slot 3 and
    stage slot 5 and decoded by `load_rows` for every k/v slot: codes,
    scales and decoded rows equal the formulas; an int8 row decodes
    within half a scale step of the original."""
    t, si = 3, 5                    # the ring and stage slots written
    st = inc.init_kv_state(CFG, B, staged=True, quant=quant)
    rows = _rows(0, B, P, 4 * D)
    planes = cf.encode(st, rows, ACTIVE)
    codes = planes[0][0]
    assert planes[0][1] is st.cache and planes[0][2] is st.stage
    f = rows.view(B, P, 4, D)
    if not quant:
        assert len(planes) == 1 and torch.equal(codes, rows)
        unit = torch.ones(B, P, 4)
    elif quant == "global":
        gs, sc = _global_formula(f, torch.zeros(B, P, 4), ACTIVE)
        assert len(planes) == 1
        assert torch.equal(codes, _codes(f, sc[..., None]).view(B, P, -1))
        assert torch.equal(st.scale, gs.view(B, P, 1, 4))
        assert (st.scale[1] == 0).all() and (st.scale[0] > 0).all()
        unit = st.scale[:, :, 0]
    else:
        sc = torch.clamp(rows.abs().amax(-1) / 127.0, min=1e-12)  # (B, P)
        assert len(planes) == 2
        assert torch.equal(codes, _codes(rows, sc[..., None]))
        val, ring, stage = planes[1]
        assert torch.equal(val, sc)
        assert ring is st.scale and stage is st.stage_scale
        st.scale[:, :, t], st.stage_scale[si] = sc, sc
        unit = sc[..., None].expand(B, P, 4)
    st.cache[:, :, t] = codes
    st.stage[si] = codes.reshape(B, -1)
    for ph in range(P):
        for grp in range(4):
            got = cf.load_rows(st, ph, grp * D, D, staged=True)  # (B, T+S, D)
            assert got.shape == (B, T + S, D)
            c = codes[:, ph, grp * D:(grp + 1) * D]
            want = (c if not quant
                    else (c.float() * unit[:, ph, grp, None]).float())
            assert torch.equal(got[:, t], want)
            assert torch.equal(got[:, T + si], want)
            if quant in (True, "row"):
                err = (got[:, t] - f[:, ph, grp]).abs()
                assert (err <= unit[:, ph, grp, None] / 2 + 1e-6).all()


def test_ring_reencode_with_set_scales_equals_per_row_encode():
    """quant="global", scales already set: the resync's ring re-encode
    equals the per-row encode of every row with those scales, and no
    scale moves."""
    r = _rows(1, B, T, 4 * D)
    gs = torch.rand(B, 4) * 0.05 + 0.01
    q_ring, gs_ring = cf.quantize_ring_global(r, gs, ACTIVE)
    q_rows, gs_rows = cf.quantize_rows_global(
        r, gs[:, None, None, :].expand(B, T, 1, 4).contiguous(), ACTIVE)
    assert torch.equal(q_ring, q_rows) and torch.equal(gs_ring, gs)
    assert torch.equal(gs_rows[:, :, 0], gs[:, None].expand(B, T, 4))


def test_ring_reencode_calibrates_unset_scales_over_the_whole_ring():
    """quant="global", scales unset: an active stream's scale is 1.5 x the
    max-abs over ALL T rows of its group / 127 (a frozen stream's stays
    0 and its codes are the rows rounded and clamped)."""
    r = _rows(2, B, T, 4 * D)
    q, gs = cf.quantize_ring_global(r, torch.zeros(B, 4), ACTIVE)
    f = r.view(B, T, 4, D)
    want_gs, sc = _global_formula(f, torch.zeros(B, 1, 4), ACTIVE)
    assert torch.equal(gs, want_gs[:, 0])
    assert torch.equal(q, _codes(f, sc[:, :, :, None]).view(B, T, -1))
    assert (gs[1] == 0).all()


@pytest.mark.parametrize("quant", [False, "row", "global"])
def test_encode_ring_per_format(quant):
    """`encode_ring` writes one phase's whole ring in the cache's format:
    the rows as they are, the per-row quantisation with its scales, or
    the whole-ring calibration; the other phases stay."""
    st = inc.init_kv_state(CFG, B, quant=quant)
    before = st.cache.clone()
    r = _rows(3, B, T, 4 * D)
    cf.encode_ring(st, 1, r, ACTIVE)
    if not quant:
        assert torch.equal(st.cache[:, 1], r)
    elif quant == "row":
        q, sc = cf.quantize_rows(r)
        assert torch.equal(st.cache[:, 1], q) and torch.equal(st.scale[:, 1],
                                                              sc)
    else:
        q, gs = cf.quantize_ring_global(r, torch.zeros(B, 4), ACTIVE)
        assert torch.equal(st.cache[:, 1], q)
        assert torch.equal(st.scale[:, 1, 0], gs)
        assert (st.scale[:, 0] == 0).all()
    keep = [p for p in range(P) if p != 1]
    assert torch.equal(st.cache[:, keep], before[:, keep])


def _written_state(quant, staged, step, count):
    st = inc.init_kv_state(CFG, B, staged=staged, quant=quant)
    st.cache.fill_(7)
    if st.scale is not None and quant == "row":
        st.scale.fill_(0.5)
    st.step = step
    st.count = torch.tensor(count, dtype=torch.int32)
    return st


@pytest.mark.parametrize("quant", [False, "row", "global"])
@pytest.mark.parametrize("slots", ["stream", "global"])
def test_ring_writers_place_rows_and_leave_frozen_streams(slots, quant):
    """"stream" puts each active stream's row (and its row scales) at its
    own count % T, "global" at the tick's g % T; the frozen stream's
    rows, scales and stamps stay as they were."""
    st = _written_state(quant, False, step=27, count=[3, 5, 25])
    old = (st.cache.clone(), st.stamp.clone(),
           None if st.scale is None else st.scale.clone())
    planes = cf.encode(st, _rows(4, B, P, 4 * D), ACTIVE)
    inc.SLOT_WRITERS[slots](st, planes, ACTIVE, "auto")
    t_of = ([3, 5, 5] if slots == "stream" else [27 % T] * B)
    for b in range(B):
        if not ACTIVE[b]:
            assert torch.equal(st.cache[b], old[0][b])
            assert torch.equal(st.stamp[b], old[1][b])
            if quant == "row":
                assert torch.equal(st.scale[b], old[2][b])
            continue
        t = t_of[b]
        assert torch.equal(st.cache[b, :, t], planes[0][0][b])
        assert st.stamp[b, t] == st.count[b]
        others = [i for i in range(T) if i != t]
        assert torch.equal(st.cache[b][:, others], old[0][b][:, others])
        assert (st.stamp[b, others] == -1).all()
        if quant == "row":
            assert torch.equal(st.scale[b, :, t], planes[1][0][b])
            assert torch.equal(st.scale[b][:, others], old[2][b][:, others])


@pytest.mark.parametrize("quant", [False, "row", "global"])
def test_staged_writer_stages_then_merges(quant):
    """"staged" writes every stream's row (and row scales) to stage slot
    g % S, the frozen stream's stamp -1, the ring untouched; on the merge
    tick (g + 1) % S == 0 each valid staged row lands at its stream's
    count % T, as "stream" would place it, and the stage empties."""
    st = _written_state(quant, True, step=S - 2, count=[3, 5, 25])
    ref = _written_state(quant, False, step=S - 2, count=[3, 5, 25])
    ring0 = st.cache.clone()
    for tick in range(2):
        rows = _rows(5 + tick, B, P, 4 * D)
        planes = cf.encode(st, rows, ACTIVE)
        inc.SLOT_WRITERS["staged"](st, planes, ACTIVE, "auto")
        inc.SLOT_WRITERS["stream"](ref, cf.encode(ref, rows, ACTIVE),
                                   ACTIVE, "auto")
        if tick == 0:
            si = (S - 2) % S
            assert torch.equal(st.stage[si], planes[0][0].reshape(B, -1))
            assert st.stage_stamp[si].tolist() == [3, -1, 25]
            if quant == "row":
                assert torch.equal(st.stage_scale[si], planes[1][0])
            assert torch.equal(st.cache, ring0)
        for x in (st, ref):
            x.count = x.count + ACTIVE.to(torch.int32)
            x.step += 1
    assert (st.stage_stamp == -1).all()
    assert torch.equal(st.cache, ref.cache)
    assert torch.equal(st.stamp, ref.stamp)
    if quant == "row":
        assert torch.equal(st.scale, ref.scale)


ATTEND_ERR = ("attend_impl 'bogus' not in ('kernel', 'kernel3', 'plain', "
              "'plain3', 'grouped', 'einsum')")
NO_STAGE = 'slots="staged" needs a state built with staged=True'


def _compact(impl):
    return (f"staged slots: use attend_impl='kernel' (the compact body of "
            f"{impl!r} has no staged form)")


@pytest.mark.parametrize("staged,slots,impl,msg", [
    (False, "staged", "kernel", NO_STAGE),
    (False, "staged", "kernel3", NO_STAGE),
    (True, "staged", "kernel3", _compact("kernel3")),
    (True, "staged", "plain3", _compact("plain3")),
    (False, "stream", "bogus", ATTEND_ERR),
    (True, "bogus", "bogus", ATTEND_ERR),
    (False, "bogus", "kernel3", "unknown slots policy 'bogus'"),
    (True, "bogus", "einsum", "unknown slots policy 'bogus'"),
])
def test_invalid_combinations_raise(staged, slots, impl, msg):
    """Each invalid (slots, attend_impl, state) combination raises its
    ValueError before the step touches the state."""
    st = inc.init_kv_state(CFG, B, staged=staged)
    e = torch.zeros(B, 2, D)
    with pytest.raises(ValueError, match=re.escape(msg)) as err:
        inc._kv_core({}, st, e, e, e, CFG, ACTIVE, slots, impl)
    assert str(err.value) == msg
    assert st.step == 0 and (st.stamp == -1).all()


@pytest.mark.parametrize("quant", [2, "int8", None])
def test_unknown_quant_raises(quant):
    with pytest.raises(ValueError, match="not in"):
        inc.init_kv_state(CFG, B, quant=quant)
