"""PyTorch port: the hybrid paths (`hybrid_step`, `fast_hybrid_step`: the
incremental KV step with a periodic full-trunk resync) against the JAX
package's on the same numpy inputs (Pallas in interpret mode), float32;
their resync frames against the full-trunk oracles; the int8 caches
through several resyncs; the resync-aligned blocked cadence."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.runtime import incremental as jinc
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.runtime import incremental as tinc
from vap_realtime_tpu_torch.runtime import streaming as tst
from vap_realtime_tpu_torch.weights.convert import params_to_torch

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)                      # T = 20
OUT_KEYS = ("p_now", "p_future", "vad", "H")
N = 6   # resync cadence: not a multiple of STAGE_S, so merges and resyncs
        # fall on different ticks (tests/test_incremental.py:531)


@functools.lru_cache(maxsize=None)
def _params():
    jc = jcfg.VapConfig(**NARROW)
    init = jax.jit(init_vap_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(5), jc))
    return jc, tcfg.VapConfig(**NARROW), jp


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


def _states(kind, jc, tc, B, staged, quant=False):
    if kind == "hybrid":
        return (jinc.init_hybrid_state(jc, B, quant=quant, staged=staged),
                tinc.init_hybrid_state(tc, B, staged=staged, quant=quant),
                jc.frame_samples)
    return (jinc.init_fast_hybrid_state(jc, B, quant=quant, staged=staged),
            tinc.init_fast_hybrid_state(tc, B, staged=staged, quant=quant),
            jc.frame_shift)


def test_trunk_rows_matches_jax():
    """The resync trunk with its K/V capture, on a right-aligned buffer
    with streams at several fill levels: probabilities and every captured
    row (B, P, T, 4D) at 1e-5."""
    jc, tc, jp = _params()
    rs = np.random.RandomState(0)
    e = rs.randn(3, 2, jc.context_frames, jc.dim).astype(np.float32)
    count = np.array([3, 20, 31], np.int32)
    jprobs, jrows = jinc._trunk_rows(jp, jnp.asarray(e), jnp.asarray(count),
                                     jc)
    tprobs, trows = tinc._trunk_rows(params_to_torch(jp), torch.as_tensor(e),
                                     torch.as_tensor(count), tc)
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), atol=1e-5)
    for k in OUT_KEYS:
        np.testing.assert_allclose(tprobs[k].numpy(), np.asarray(jprobs[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["hybrid", "fast_hybrid"])
@pytest.mark.parametrize("staged,attend_impl,jax_impl", [
    (True, "kernel", "pallas"), (False, "einsum", "einsum")])
def test_hybrid_step_matches_jax(kind, staged, attend_impl, jax_impl):
    """24 frames at resync_every=6 (four resyncs), frozen ticks, the ring
    (T=20) wrapping, staged merges: outputs at 1e-4; count, stamp and
    step equal; the stage invalidated after each resync; the embedding
    ring equal to the JAX package's right-aligned buffer at 1e-5."""
    jc, tc, jp = _params()
    B, F = 3, 24
    tp = params_to_torch(jp)
    js, ts, n = _states(kind, jc, tc, B, staged)
    jfn = jinc.hybrid_step if kind == "hybrid" else jinc.fast_hybrid_step
    tfn = tinc.hybrid_step if kind == "hybrid" else tinc.fast_hybrid_step
    jstep = jax.jit(functools.partial(jfn, cfg=jc, resync_every=N,
                                      attend_impl=jax_impl))
    for f, fr in enumerate(_frames(F, B, n, 6)):
        act = _active(f, B)
        js, jo = jstep(jp, js, jnp.asarray(fr), active=jnp.asarray(act))
        ts, to = tfn(tp, ts, torch.as_tensor(fr), tc, torch.as_tensor(act),
                     resync_every=N, attend_impl=attend_impl)
        for k in OUT_KEYS:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        for name in ("count", "stamp") + (("stage_stamp",) if staged else ()):
            np.testing.assert_array_equal(getattr(ts.kv, name).numpy(),
                                          np.asarray(getattr(js.kv, name)),
                                          err_msg=f"{name} frame {f}")
        assert ts.kv.step == int(js.kv.step) == f + 1
        if staged and (f + 1) % N == 0:
            assert (ts.kv.stage_stamp == -1).all(), f"stage after resync {f}"
        np.testing.assert_allclose(
            tinc.right_aligned(ts.e_ctx, ts.kv.count).numpy(),
            np.asarray(js.e_ctx), atol=1e-5, err_msg=f"e_ctx frame {f}")


def test_resync_frames_match_full_trunk_oracles():
    """Resync frames are exact against the full-trunk oracles
    (tests/test_incremental.py:91, 279): hybrid against the full
    recompute (`run_frames`), fast_hybrid against itself at
    resync_every=1; 64 frames at T=20, resync every 10, at 2e-5; between
    resyncs the deviation stays bounded."""
    _, tc, jp = _params()
    tp = params_to_torch(jp)
    rs = np.random.RandomState(7)
    audio = (0.1 * rs.randn(2, tc.frame_shift * 65)).astype(np.float32)
    R = 10
    frames = torch.as_tensor(tst.frame_audio(audio, tc)[:, None])
    F = frames.shape[0]
    assert F > 3 * tc.context_frames
    _, full = tst.run_frames(tp, tst.init_stream_state(tc, 1), frames, tc)
    _, hyb = tinc.run_frames_hybrid(tp, tinc.init_hybrid_state(tc, 1),
                                    frames, tc, R)
    fresh = torch.as_tensor(audio[:, :F * tc.frame_shift].reshape(
        2, F, -1).transpose(1, 0, 2)[:, None].copy())
    _, oracle = tinc.run_frames_fast_hybrid(
        tp, tinc.init_fast_hybrid_state(tc, 1), fresh, tc, 1)
    _, fh = tinc.run_frames_fast_hybrid(
        tp, tinc.init_fast_hybrid_state(tc, 1), fresh, tc, R)
    resync = [g for g in range(F) if (g + 1) % R == 0]
    for got, want in ((hyb, full), (fh, oracle)):
        np.testing.assert_allclose(got["p_now"][resync].numpy(),
                                   want["p_now"][resync].numpy(), atol=2e-5)
        assert (got["p_now"] - want["p_now"]).abs().max().item() < 0.05


@pytest.mark.parametrize("quant", ["row", "global"])
def test_int8_hybrid_matches_jax(quant):
    """hybrid_step with the int8 cache over 20 frames at resync_every=6
    (three resyncs: requantised rows, the global scales calibrated from
    the whole rebuilt ring for streams that first tick on a resync):
    outputs at 1e-4, codes within 1, scales at rtol 5e-5, count and
    stamp equal (the limits of tests/test_torch_quant.py); the LSTM state
    stays float."""
    jc, tc, jp = _params()
    B, F = 3, 20
    tp = params_to_torch(jp)
    js, ts, n = _states("hybrid", jc, tc, B, False, quant)
    jstep = jax.jit(functools.partial(jinc.hybrid_step, cfg=jc,
                                      resync_every=N))
    for f, fr in enumerate(_frames(F, B, n, 8)):
        # stream 2 first ticks on frame 5, a resync frame
        act = _active(f, B) & np.array([True, True, f >= 5])
        js, jo = jstep(jp, js, jnp.asarray(fr), active=jnp.asarray(act))
        ts, to = tinc.hybrid_step(tp, ts, torch.as_tensor(fr), tc,
                                  torch.as_tensor(act), resync_every=N)
        for k in OUT_KEYS:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        for name in ("count", "stamp"):
            np.testing.assert_array_equal(getattr(ts.kv, name).numpy(),
                                          np.asarray(getattr(js.kv, name)))
        d = np.abs(ts.kv.cache.numpy().astype(np.int32)
                   - np.asarray(js.kv.cache).astype(np.int32))
        assert d.max() <= 1, f"codes differ by {d.max()}, frame {f}"
        np.testing.assert_allclose(ts.kv.scale.numpy(),
                                   np.asarray(js.kv.scale), rtol=5e-5,
                                   err_msg=f"scale frame {f}")
    assert ts.kv.lstm_h.dtype == torch.float32
    assert ts.kv.lstm_h.abs().max().item() > 1e-3


def test_host_cadence_equals_per_tick():
    """run_frames_fast_hybrid with the resync-aligned blocked cadence
    gives the per-tick cadence's outputs bit for bit; it refuses partial
    blocks."""
    _, tc, jp = _params()
    tp = params_to_torch(jp)
    frames = torch.as_tensor(_frames(12, 2, tc.frame_shift, 9))
    outs = {}
    for host in (False, True):
        st = tinc.init_fast_hybrid_state(tc, 2, staged=True)
        _, outs[host] = tinc.run_frames_fast_hybrid(
            tp, st, frames, tc, N, attend_impl="kernel", host_cadence=host)
    for k in OUT_KEYS:
        assert torch.equal(outs[True][k], outs[False][k]), k
    with pytest.raises(ValueError, match="whole blocks"):
        tinc.run_frames_fast_hybrid(tp, tinc.init_fast_hybrid_state(tc, 2),
                                    frames[:7], tc, N, host_cadence=True)
