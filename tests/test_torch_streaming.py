"""PyTorch port: the full-recompute stream step, the whole-sequence model
core and the incremental `kv_step` against the JAX package's functions on
the same numpy inputs (Pallas in interpret mode on the CPU), float32; and
the port's kv path against its own full path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.encoder import encode_chunk as j_encode_chunk
from vap_realtime_tpu.models.vap import forward_context as j_forward_context
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.models.vap import trunk_forward as j_trunk_forward
from vap_realtime_tpu.runtime import incremental as jinc
from vap_realtime_tpu.runtime import streaming as jst
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.models.encoder import encode_chunk
from vap_realtime_tpu_torch.models.vap import forward_context, trunk_forward
from vap_realtime_tpu_torch.runtime import incremental as tinc
from vap_realtime_tpu_torch.runtime import streaming as tst
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_params,
)

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)                      # T = 20
OUT_KEYS = ("p_now", "p_future", "vad", "H")


@functools.lru_cache(maxsize=None)
def _params(context_limit=-1):
    jc = jcfg.VapConfig(**NARROW, context_limit=context_limit)
    init = jax.jit(init_vap_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(4), jc))
    return jc, tcfg.VapConfig(**NARROW, context_limit=context_limit), jp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _active(f, B):
    """Stream 0 always on; the others tick with gaps; tick 4 all frozen."""
    act = np.array([True, f % 2 == 0, f % 3 != 0][:B])
    return act & (f != 4)


def _frames(F, B, n, seed):
    rs = np.random.RandomState(seed)
    return (0.1 * rs.randn(F, B, 2, n)).astype(np.float32)


def _close(got, want, keys, atol, what):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, err_msg=f"{k} {what}")


def test_encode_chunk_matches_jax():
    jc, tc, jp = _params()
    rs = np.random.RandomState(1)
    wav = (0.1 * rs.randn(3, jc.frame_samples)).astype(np.float32)
    h, c = (0.1 * rs.randn(2, 3, jc.encoder_dim)).astype(np.float32)
    want = j_encode_chunk(jp["encoder"], jnp.asarray(wav), jnp.asarray(h),
                          jnp.asarray(c), jc.downsample_kernel)
    got = encode_chunk(params_to_torch(jp)["encoder"], torch.as_tensor(wav),
                       torch.as_tensor(h), torch.as_tensor(c),
                       tc.downsample_kernel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("context_limit", [-1, 6])
def test_trunk_and_forward_context_match_jax(context_limit):
    """trunk_forward and forward_context on random embeddings, with and
    without the context_limit band."""
    jc, tc, jp = _params(context_limit)
    rs = np.random.RandomState(2)
    e1, e2 = (rs.randn(2, 2, jc.context_frames, jc.dim)).astype(np.float32)
    tp = params_to_torch(jp)
    te = torch.as_tensor(e1), torch.as_tensor(e2)
    want = j_trunk_forward(jp, jnp.asarray(e1), jnp.asarray(e2), jc)
    _close(trunk_forward(tp, *te, tc), want, ("x", "x1", "x2", "o1", "o2"),
           1e-5, "trunk")
    want = j_forward_context(jp, jnp.asarray(e1), jnp.asarray(e2), jc)
    _close(forward_context(tp, *te, tc), want, want.keys(), 1e-5, "heads")


def test_stream_step_matches_jax():
    """stream_step at B=3 over 24 frames (the window slides after 20),
    streams frozen on some ticks: outputs, counts and buffers held."""
    jc, tc, jp = _params()
    B, F = 3, 24
    tp = params_to_torch(jp)
    jstep = jax.jit(functools.partial(jst.stream_step, cfg=jc))
    js = jst.init_stream_state(jc, B)
    ts = tst.init_stream_state(tc, B)
    for f, fr in enumerate(_frames(F, B, jc.frame_samples, 3)):
        act = _active(f, B)
        js, jo = jstep(jp, js, jnp.asarray(fr), active=jnp.asarray(act))
        ts, to = tst.stream_step(tp, ts, torch.as_tensor(fr), tc,
                                 torch.as_tensor(act))
        _close(to, jo, OUT_KEYS, 1e-4, f"frame {f}")
        np.testing.assert_array_equal(ts.count.numpy(), np.asarray(js.count))
        np.testing.assert_allclose(ts.e_ctx.numpy(), np.asarray(js.e_ctx),
                                   atol=1e-5)
    assert int(ts.count[0]) == F - 1


@pytest.mark.parametrize("slots,attend_impl,jax_impl,quant", [
    ("staged", "kernel", "pallas", False),
    ("stream", "einsum", "einsum", False),
    ("stream", "einsum", "einsum", "global"),
])
def test_kv_step_matches_jax(slots, attend_impl, jax_impl, quant):
    """kv_step over 12 frames with frozen ticks, past one staged merge:
    outputs at 1e-4, stamps and counts bit-equal."""
    jc, tc, jp = _params()
    B, F = 3, 12
    tp = params_to_torch(jp)
    staged = slots == "staged"
    jstep = jax.jit(functools.partial(jinc.kv_step, cfg=jc, slots=slots,
                                      attend_impl=jax_impl))
    js = jinc.init_kv_state(jc, B, quant=quant, staged=staged)
    ts = tinc.init_kv_state(tc, B, staged=staged, quant=quant)
    for f, fr in enumerate(_frames(F, B, jc.frame_samples, 4)):
        act = _active(f, B)
        js, jo = jstep(jp, js, jnp.asarray(fr), active=jnp.asarray(act))
        ts, to = tinc.kv_step(tp, ts, torch.as_tensor(fr), tc,
                              torch.as_tensor(act), slots=slots,
                              attend_impl=attend_impl)
        _close(to, jo, OUT_KEYS, 1e-4, f"frame {f}")
        for name in ("count", "stamp") + (("stage_stamp",) if staged else ()):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=f"{name} frame {f}")
        assert ts.step == int(js.step)


@functools.lru_cache(maxsize=None)
def _kv_and_full(context_len_sec, seconds):
    """The port's kv (run_frames_kv) and full (run_frames) outputs on the
    full-width synthetic model over synthetic audio."""
    cfg = tcfg.VapConfig(frame_hz=20, context_len_sec=context_len_sec)
    p = params_to_torch(synthetic_params(20))
    frames = torch.as_tensor(
        tst.frame_audio(synthetic_audio(16000 * seconds), cfg)[:, None])
    _, full = tst.run_frames(p, tst.init_stream_state(cfg, 1), frames, cfg)
    _, kv = tinc.run_frames_kv(p, tinc.init_kv_state(cfg, 1), frames, cfg)
    return cfg, frames, full, kv


def test_kv_equals_full_while_growing():
    """While the context grows (39 frames < T = 50) the incremental step
    is exact: causal attention and distance-only AliBi make appends
    non-retroactive (tests/test_incremental.py:39-47)."""
    cfg, frames, full, kv = _kv_and_full(2.5, 2)
    assert frames.shape[0] < cfg.context_frames
    for key in ("p_now", "p_future", "vad"):
        np.testing.assert_allclose(kv[key].numpy(), full[key].numpy(),
                                   atol=2e-5, err_msg=key)


def test_kv_bounded_after_slide():
    """After the window slides (T = 20, 59 frames) the cached upper-layer
    K/V keep their as-computed values: exact until the first slide, then
    a bounded deviation (tests/test_incremental.py:50-61)."""
    cfg, frames, full, kv = _kv_and_full(1.0, 3)
    g = cfg.context_frames
    assert frames.shape[0] > 2 * g
    np.testing.assert_allclose(kv["p_now"][:g].numpy(),
                               full["p_now"][:g].numpy(), atol=2e-5)
    dev = (kv["p_now"] - full["p_now"]).abs().max().item()
    assert dev < 0.05, f"sliding-window deviation too large: {dev}"


def test_run_frames_kv_and_run_frames_match_jax():
    """run_frames_kv (global slots) and run_frames against the JAX scans
    over 10 frames of the narrow model; frame_audio against the JAX
    windowing."""
    jc, tc, jp = _params()
    audio = synthetic_audio(16000 // 2 + jc.frame_samples)
    frames = tst.frame_audio(audio, tc)
    np.testing.assert_array_equal(frames, jst.frame_audio(audio, jc))
    frames = frames[:, None]
    tp = params_to_torch(jp)
    _, jkv = jax.jit(jinc.run_frames_kv, static_argnums=3)(
        jp, jinc.init_kv_state(jc, 1), jnp.asarray(frames), jc)
    _, tkv = tinc.run_frames_kv(tp, tinc.init_kv_state(tc, 1),
                                torch.as_tensor(frames), tc)
    _close(tkv, jkv, OUT_KEYS, 1e-4, "run_frames_kv")
    _, jfull = jax.jit(jst.run_frames, static_argnums=3)(
        jp, jst.init_stream_state(jc, 1), jnp.asarray(frames), jc)
    _, tfull = tst.run_frames(tp, tst.init_stream_state(tc, 1),
                              torch.as_tensor(frames), tc)
    _close(tfull, jfull, OUT_KEYS, 1e-4, "run_frames")
    assert tkv["p_now"].shape == (frames.shape[0], 1, 2)
