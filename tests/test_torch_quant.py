"""PyTorch port: the int8 KV cache (quant="row" and quant="global")
against the JAX package — the quantisers, the attend kernel's plain
version on int8 codes (against `fused_attend_pair`, Pallas in interpret
mode), the fast staged step frame by frame, the arena's slot reset and
the int8-vs-float deviation."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.ops.pallas.attend import fused_attend_pair
from vap_realtime_tpu.runtime import arena as jarena
from vap_realtime_tpu.runtime import incremental as jinc
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.ops.cuda.attend import DEAD, attend_pair_plain
from vap_realtime_tpu_torch.runtime import arena as tarena
from vap_realtime_tpu_torch.runtime import cache_format
from vap_realtime_tpu_torch.runtime import incremental as tinc
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_params,
)

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)                      # T = 20
OUT_KEYS = ("p_now", "p_future", "vad")
T_ = torch.as_tensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and timing-sensitive socket tests share the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    jc = jcfg.VapConfig(**NARROW)
    init = jax.jit(init_vap_params, static_argnums=1)
    return jc, jax.tree_util.tree_map(np.asarray,
                                      init(jax.random.PRNGKey(1), jc))


def _active(f, B):
    """Stream 0 always on; the others tick with gaps (stream 2 first
    active at tick 1); tick 5 all frozen."""
    act = np.array([True, f % 2 == 0, f % 3 != 0][:B])
    return act & (f != 5)


# --- the quantisers ---------------------------------------------------------

def test_quantize_rows_matches_jax():
    """Per-row int8: codes equal, scales to rtol 1e-6 (an all-zero row
    takes the 1e-12 floor in both)."""
    rs = np.random.RandomState(0)
    rows = (rs.randn(3, 7, 256) * rs.rand(3, 7, 1) * 4).astype(np.float32)
    rows[1, 2] = 0.0
    jq, js = jinc.quantize_rows(jnp.asarray(rows))
    tq, ts = cache_format.quantize_rows(T_(rows))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (3, 7)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_quantize_rows_global_gating_and_freeze():
    """Frozen per-stream scales: set only on a stream's first ACTIVE
    frame, unchanged afterwards, later rows that exceed the 1.5x margin
    saturate at +-127.  Codes equal, scales to rtol 1e-6, against JAX."""
    rs = np.random.RandomState(1)
    B, P, D4 = 3, 2, 4 * 16
    gs_j = jnp.zeros((B, P, 1, 4), jnp.float32)
    gs_t = torch.zeros((B, P, 1, 4))
    history = []
    for f, act in enumerate(([True, False, False], [True, True, False],
                             [False, True, True])):
        rows = (rs.randn(B, P, D4) * (1 + 2 * f)).astype(np.float32)
        act = np.asarray(act)
        jq, gs_j = jinc.quantize_rows_global(jnp.asarray(rows), gs_j,
                                             jnp.asarray(act))
        tq, gs_t = cache_format.quantize_rows_global(T_(rows), gs_t,
                                                     T_(act))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(gs_t.numpy(), np.asarray(gs_j),
                                   rtol=1e-6)
        history.append(gs_t.clone())
        if f == 2:       # 5x the calibration frame's range: saturated
            assert (tq.abs() == 127).any()
    h0, h1, h2 = (h.numpy() for h in history)
    assert (h0[0] > 0).all() and (h0[1:] == 0).all()    # gated on activity
    assert (h1[1] > 0).all() and (h1[2] == 0).all()
    np.testing.assert_array_equal(h1[0], h0[0])         # frozen after set
    np.testing.assert_array_equal(h2[:2], h1[:2])
    assert (h2[2] > 0).all()


# --- the attend kernel's plain version on int8 codes ------------------------

B, P, T, D, H, S = 3, 2, 20, 64, 4, 8


def _int8_inputs(seed):
    """Int8 cache/stage codes; float q/k_cur/v_cur; row scales > 0; live
    ages in [1, T+S) with about a third of the rows DEAD."""
    rs = np.random.RandomState(seed)
    codes = lambda *s: rs.randint(-127, 128, s).astype(np.int8)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    cache, stage = codes(B, P, T, 4 * D), codes(S, B, P * 4 * D)
    q, kc, vc = f(B, 2, D), f(B, 2, D), f(B, 2, D)
    sc = (rs.uniform(0.5, 1.5, (B, T)) * 3 / 127).astype(np.float32)
    ssc = (rs.uniform(0.5, 1.5, (S, B)) * 3 / 127).astype(np.float32)
    age = rs.randint(1, T + S, (B, T)).astype(np.float32)
    sage = rs.randint(1, T + S, (S, B)).astype(np.float32)
    age[rs.rand(B, T) < 0.35] = DEAD
    sage[rs.rand(S, B) < 0.35] = DEAD
    return cache, q, kc, vc, age, stage, sage, sc, ssc


@pytest.mark.parametrize("mode,staged", [("global", False), ("global", True),
                                         ("row", False), ("row", True)])
def test_plain_int8_matches_pallas_kernel(mode, staged):
    """attend_pair_plain on int8 codes against the TPU kernel in interpret
    mode, float32, atol 2e-5.  "global": the codes read as they are, with
    the frozen scales folded into q / k_cur / v_cur and the output the
    way `_kv_core` does (so the comparison is in float units, where the
    step uses it); "row": the per-row scales of the ring and the stage."""
    cache, q, kc, vc, age, stage, sage, sc, ssc = _int8_inputs(seed=11)
    jst = dict(stage=stage, stage_age=sage) if staged else {}
    tst = (T_(stage), T_(sage)) if staged else (None, None)
    for phase in range(P):
        kw = dict(pair_base=2 * phase, num_heads=H)
        if mode == "global":
            ck = np.float32(3.0 / 127)
            cv = np.float32(2.0 / 127)
            args = (q * ck, kc / ck, vc / cv)
            want = np.asarray(fused_attend_pair(
                cache, *args, age, interpret=True, **jst, **kw)) * cv
            got = attend_pair_plain(T_(cache), *map(T_, args), T_(age),
                                    *tst, **kw).numpy() * cv
        else:
            if staged:
                jst = dict(jst, stage_scale=ssc)
            want = np.asarray(fused_attend_pair(
                cache, q, kc, vc, age, scale=sc, interpret=True, **jst,
                **kw))
            got = attend_pair_plain(
                T_(cache), T_(q), T_(kc), T_(vc), T_(age), *tst,
                scale=T_(sc), stage_scale=T_(ssc) if staged else None,
                **kw).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5,
                                   err_msg=f"{mode} phase {phase}")


# --- the fast staged step ---------------------------------------------------

@pytest.mark.parametrize("attend_impl,jax_impl", [("kernel", "pallas"),
                                                  ("einsum", "einsum")])
@pytest.mark.parametrize("quant", ["global", "row"])
def test_fast_staged_int8_step_matches_jax(quant, attend_impl, jax_impl):
    """28 frames with the int8 cache: the ring (T=20) wraps for stream 0,
    frozen ticks, three merges.  p_now / p_future / vad to atol 1e-4;
    count, stamp and stage_stamp equal; int8 codes within 1 (a rounding
    tie moved by 1e-6 of float32 noise upstream); scales to rtol 5e-5: a
    code that moved by 1 (one scale step) shifts the later attentions of
    its stream and with them the max-abs of its later rows (measured
    worst 1.2e-5, quant="row")."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**NARROW)
    Bs, F = 3, 28
    assert F > jc.context_frames and F > 3 * tinc.STAGE_S
    jstep = jax.jit(functools.partial(jinc.fast_step, cfg=jc, slots="staged",
                                      attend_impl=jax_impl))
    js = jinc.init_fast_state(jc, Bs, quant=quant, staged=True)
    tp = params_to_torch(jp)
    ts = tinc.init_fast_state(tc, Bs, staged=True, quant=quant)
    assert ts.kv.quant == quant and ts.kv.cache.dtype == torch.int8
    rs = np.random.RandomState(4)
    for f in range(F):
        new = (0.1 * rs.randn(Bs, 2, jc.frame_shift)).astype(np.float32)
        act = _active(f, Bs)
        js, jo = jstep(jp, js, jnp.asarray(new), active=jnp.asarray(act))
        ts, to = tinc.fast_step(tp, ts, T_(new), tc, T_(act), slots="staged",
                                attend_impl=attend_impl)
        for k in OUT_KEYS:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        jk, tk = js.kv, ts.kv
        for name in ("count", "stamp", "stage_stamp"):
            np.testing.assert_array_equal(getattr(tk, name).numpy(),
                                          np.asarray(getattr(jk, name)),
                                          err_msg=f"{name} frame {f}")
        for name in ("cache", "stage"):
            d = np.abs(getattr(tk, name).numpy().astype(np.int32)
                       - np.asarray(getattr(jk, name)).astype(np.int32))
            assert d.max() <= 1, f"{name} codes differ by {d.max()}, f {f}"
        np.testing.assert_allclose(tk.scale.numpy(), np.asarray(jk.scale),
                                   rtol=5e-5, err_msg=f"scale frame {f}")
        if quant == "row":
            np.testing.assert_allclose(tk.stage_scale.numpy(),
                                       np.asarray(jk.stage_scale),
                                       rtol=5e-5, err_msg=f"frame {f}")
    assert int(ts.kv.count[0]) == F - 1                  # tick 5 frozen


# --- the arena's slot reset -------------------------------------------------

@pytest.mark.parametrize("quant", ["global", "row"])
def test_reset_slot_zeroes_only_global_scales(quant):
    """A slot reset re-zeroes the reset slot's frozen global scales only
    (the next stream calibrates anew), and leaves per-row scales as they
    are (read only for live rows); the JAX arena's `_reset_slot` agrees."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**NARROW)
    tp = params_to_torch(jp)
    jstep = jax.jit(functools.partial(jinc.fast_step, cfg=jc, slots="staged",
                                      attend_impl="einsum"))
    js = jinc.init_fast_state(jc, 2, quant=quant, staged=True)
    ts = tinc.init_fast_state(tc, 2, staged=True, quant=quant)
    rs = np.random.RandomState(5)
    for act in ([True, False], [True, True]):
        new = (0.1 * rs.randn(2, 2, jc.frame_shift)).astype(np.float32)
        js, _ = jstep(jp, js, jnp.asarray(new), active=jnp.asarray(act))
        ts, _ = tinc.fast_step(tp, ts, T_(new), tc, T_(np.asarray(act)),
                               slots="staged", attend_impl="einsum")
    before = ts.kv.scale.clone()
    if quant == "global":
        assert (before > 0).all()
    mask = np.array([True, False])
    js = jarena._reset_slot(js, jnp.asarray(mask))
    tarena._reset_slot(ts, T_(mask))
    after = ts.kv.scale
    np.testing.assert_allclose(after.numpy(), np.asarray(js.kv.scale),
                               rtol=1e-5)
    if quant == "global":
        assert (after[0] == 0).all()
    else:
        assert torch.equal(after[0], before[0])
    assert torch.equal(after[1], before[1])
    assert ts.kv.count.tolist() == [0, 1]


# --- int8 against the float cache -------------------------------------------

# max |p_now(int8) - p_now(float32 cache)| over 40 frames of the full-width
# model on synthetic weights and audio (port, CPU, float32 state), pinned
# at about 10x the measured value: row 8.3e-6, global 1.36e-5 (coarser:
# one frozen scale covers all of a stream's rows)
_DEVIATION = {"row": 1e-4, "global": 1.4e-4}


@pytest.mark.parametrize("quant", ["row", "global"])
def test_int8_cache_tracks_float_cache(quant):
    """The int8 cache's deviation from the float cache, pinned at its
    measured order (see _DEVIATION): full width (D=256, T=20), 2 s of
    synthetic audio, the ring wraps; staged slots, kernel attend."""
    cfg = tcfg.VapConfig(frame_hz=20, context_len_sec=1.0)
    p = params_to_torch(synthetic_params(20))
    audio = synthetic_audio(16000 * 2)
    frames = T_(audio.reshape(2, -1, cfg.frame_shift).transpose(1, 0, 2)
                [:, None].copy())                       # (F, 1, 2, shift)
    assert frames.shape[0] > cfg.context_frames
    outs = {}
    for q in (False, quant):
        st = tinc.init_fast_state(cfg, 1, staged=True, quant=q)
        _, o = tinc.run_frames_fast(p, st, frames, cfg, slots="staged",
                                    attend_impl="kernel")
        outs[q] = o["p_now"].numpy()
    d = np.abs(outs[quant] - outs[False]).max()
    print(f"\n[int8 {quant}] max |p_now - float cache| = {d:.3e}")
    assert 0 < d <= _DEVIATION[quant], d


@pytest.mark.parametrize("quant,conv_impl", [("global", "normk"),
                                             (True, "conv")])
def test_arena_int8_matches_jax_arena(quant, conv_impl):
    """The serving arena with an int8 cache (and, for global, the normk
    encoder) against the JAX arena over the same slot lifecycle: add,
    partial ticks, reset_slots (global scales recalibrate), slot reuse,
    past two merges; every served output to atol 1e-4."""
    jc, jp = _params()
    kw = dict(capacity=3, path="fast", quant_cache=quant,
              conv_impl=conv_impl)
    ja = jarena.StreamArena(jc, jp, attend_impl="pallas", **kw)
    ta = tarena.StreamArena(tcfg.VapConfig(**NARROW), jp, device="cpu", **kw)
    assert ta.state.kv.quant == ("global" if quant == "global" else "row")
    ja.warmup()
    ta.warmup()
    slots = [ja.add_stream() for _ in range(2)]
    assert [ta.add_stream() for _ in range(2)] == slots
    rs = np.random.RandomState(8)
    for tick in range(18):
        if tick == 7:
            ja.reset_slots([slots[1]])
            ta.reset_slots([slots[1]])
        if tick == 11:
            ja.remove_stream(slots[0])
            ta.remove_stream(slots[0])
            assert ja.add_stream() == ta.add_stream() == slots[0]
        feed = [s for i, s in enumerate(slots) if (tick + i) % 3 != 1]
        chunks = {s: (0.1 * rs.randn(2, ta.chunk_samples))
                  .astype(np.float32) for s in feed}
        out_j, out_t = ja.step(chunks), ta.step(chunks)
        for s in feed:
            for k in ("p_now", "p_future", "vad"):
                np.testing.assert_allclose(out_t[s][k], out_j[s][k],
                                           atol=1e-4,
                                           err_msg=f"{k} slot {s} tick {tick}")


@pytest.mark.parametrize("argv,want", [([], False), (["--quant_cache"], "row"),
                                       (["--quant_cache", "row"], "row"),
                                       (["--quant_cache", "global"],
                                        "global")])
def test_server_quant_cache_flag(argv, want):
    """The port's native server: a bare --quant_cache or 'row' selects
    per-row scales, 'global' frozen scales.  Every value the help lists
    ({row,global}) is accepted as typed; the JAX server lists True, which
    a typed 'True' never matches."""
    from vap_realtime_tpu_torch.runtime.server_native import parse_args

    args = parse_args(["--synthetic_weights"] + argv + ["--bf16"])
    assert args.quant_cache == want and args.bf16
    with pytest.raises(SystemExit):
        parse_args(["--synthetic_weights", "--quant_cache", "True"])
