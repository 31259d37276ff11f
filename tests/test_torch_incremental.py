"""PyTorch port: the fast staged serving step against the JAX package's
`fast_step(slots="staged", attend_impl="pallas")` (Pallas in interpret
mode on the CPU), frame by frame, float32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.runtime import incremental as jinc
from vap_realtime_tpu.weights.synthetic import synthetic_params
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.runtime import incremental as tinc
from vap_realtime_tpu_torch.weights.convert import params_to_torch

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)                      # T = 20
OUT_KEYS = ("p_now", "p_future", "vad", "H")


@functools.lru_cache(maxsize=None)
def _params(mode="vap"):
    jc = jcfg.VapConfig(**NARROW, mode=mode)
    init = jax.jit(init_vap_params, static_argnums=1)
    return jc, jax.tree_util.tree_map(np.asarray,
                                      init(jax.random.PRNGKey(1), jc))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and timing-sensitive socket tests share the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _active(f, B):
    """Stream 0 always on; the others tick with gaps; tick 5 all frozen."""
    act = np.array([True, f % 2 == 0, f % 3 != 0][:B])
    return act & (f != 5)


def _run_both(jc, jp, F, B, keys=OUT_KEYS, check_state=True, seed=0):
    """Steps the JAX and the port fast_step side by side over F frames;
    returns the port's final state."""
    tc = tcfg.VapConfig(**{f: getattr(jc, f) for f in
                           ("dim", "encoder_dim", "num_heads", "frame_hz",
                            "context_len_sec", "mode")})
    tp = params_to_torch(jp)
    jstep = jax.jit(functools.partial(jinc.fast_step, cfg=jc, slots="staged",
                                      attend_impl="pallas"))
    js = jinc.init_fast_state(jc, B, staged=True)
    ts = tinc.init_fast_state(tc, B, staged=True)
    rs = np.random.RandomState(seed)
    for f in range(F):
        new = (0.1 * rs.randn(B, 2, jc.frame_shift)).astype(np.float32)
        act = _active(f, B)
        js, jo = jstep(jp, js, jnp.asarray(new), active=jnp.asarray(act))
        ts, to = tinc.fast_step(tp, ts, torch.as_tensor(new), tc,
                                torch.as_tensor(act), slots="staged",
                                attend_impl="kernel")
        for k in keys:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        if not check_state:
            continue
        jk, tk = js.kv, ts.kv
        for name in ("count", "stamp", "stage_stamp"):
            np.testing.assert_array_equal(getattr(tk, name).numpy(),
                                          np.asarray(getattr(jk, name)),
                                          err_msg=f"{name} frame {f}")
        assert tk.step == int(jk.step)
        np.testing.assert_allclose(tk.cache.numpy(), np.asarray(jk.cache),
                                   atol=1e-4, err_msg=f"cache frame {f}")
        np.testing.assert_allclose(tk.stage.numpy(), np.asarray(jk.stage),
                                   atol=1e-4, err_msg=f"stage frame {f}")
    return ts


def test_fast_staged_step_matches_jax():
    """32 frames: four merges, the ring (T=20) wraps for stream 0, mixed
    activity with frozen ticks; outputs, ring, stage and stamps held."""
    jc, jp = _params()
    F = 32
    assert F > 2 * tinc.STAGE_S and F > jc.context_frames
    ts = _run_both(jc, jp, F, B=3)
    assert int(ts.kv.count[0]) == F - 1                  # tick 5 frozen


@pytest.mark.parametrize("mode", ["bc", "nod"])
def test_fast_step_variant_heads_match_jax(mode):
    jc, jp = _params(mode)
    keys = {"bc": ("p_bc_react", "p_bc_emo"),
            "nod": ("p_bc", "p_nod_short", "p_nod_long", "p_nod_long_p")}
    _run_both(jc, jp, 10, B=2, keys=keys[mode] + ("p_now",),
              check_state=False)


def test_fast_step_full_width_synthetic_matches_jax():
    """The full-width model (D=256, 20 Hz, 2.5 s context, T=50) on the
    synthetic weights, B=2, past one merge."""
    jc = jcfg.VapConfig(frame_hz=20, context_len_sec=2.5)
    jp = jax.tree_util.tree_map(np.asarray, synthetic_params(20))
    _run_both(jc, jp, 10, B=2, check_state=False)


@pytest.mark.parametrize("attend_impl", ["kernel", "einsum"])
def test_staged_equals_stream(attend_impl):
    """slots="staged" == slots="stream" in the port: same outputs, the
    same ring placement and bit-identical stamps right after each merge.
    Phase 0 (the channel layer's k/v, computed before any attention) is
    bit-identical; later phases hold rows computed from attentions that
    sum ring + stage in another order than ring alone, so they agree to
    float32 rounding (atol 1e-6, as the JAX package's own test)."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**NARROW)
    tp = params_to_torch(jp)
    B = 3
    st_s = tinc.init_fast_state(tc, B)
    st_g = tinc.init_fast_state(tc, B, staged=True)
    rs = np.random.RandomState(2)
    for f in range(3 * tc.context_frames + 5):
        new = torch.as_tensor(
            (0.1 * rs.randn(B, 2, tc.frame_shift)).astype(np.float32))
        act = torch.as_tensor(_active(f, B))
        st_s, out_s = tinc.fast_step(tp, st_s, new, tc, act, slots="stream",
                                     attend_impl=attend_impl)
        st_g, out_g = tinc.fast_step(tp, st_g, new, tc, act, slots="staged",
                                     attend_impl=attend_impl)
        np.testing.assert_allclose(out_g["p_now"][0].numpy(),
                                   out_s["p_now"][0].numpy(), atol=2e-5)
        if (f + 1) % tinc.STAGE_S == 0:
            assert torch.equal(st_g.kv.stamp, st_s.kv.stamp)
            assert torch.equal(st_g.kv.cache[:, 0], st_s.kv.cache[:, 0])
            np.testing.assert_allclose(st_g.kv.cache.numpy(),
                                       st_s.kv.cache.numpy(), atol=1e-6)
            assert (st_g.kv.stage_stamp == -1).all()


def test_run_frames_fast_and_conv_chunks():
    """run_frames_fast stacks per-frame outputs; conv_chunks sub-batches
    the encoder (same math; CPU matmuls of another batch size may round
    differently in the last bit)."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**NARROW)
    tp = params_to_torch(jp)
    rs = np.random.RandomState(3)
    frames = torch.as_tensor(
        (0.1 * rs.randn(4, 2, 2, tc.frame_shift)).astype(np.float32))
    _, outs = tinc.run_frames_fast(tp, tinc.init_fast_state(tc, 2), frames,
                                   tc)
    assert outs["p_now"].shape == (4, 2, 2)
    st = tinc.init_fast_state(tc, 2)
    for f in range(4):
        st, o = tinc.fast_step(tp, st, frames[f], tc, conv_chunks=2)
        np.testing.assert_allclose(o["p_now"].numpy(),
                                   outs["p_now"][f].numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="staged"):
        tinc.init_kv_state(tcfg.VapConfig(context_len_sec=0.25),
                           staged=True)
