"""PyTorch port: the one-pass ChannelNorm+ReLU (`conv_impl="normk"`)
against the JAX package — the kernel's plain version against the TPU
kernel (`channel_norm_relu`, Pallas in interpret mode), the normk
streaming conv stack, and the fast staged step with conv_impl="normk"."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models import encoder as jenc
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.ops.pallas.channorm import (
    channel_norm_relu as jax_channel_norm_relu,
)
from vap_realtime_tpu.runtime import incremental as jinc
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.models import encoder as tenc
from vap_realtime_tpu_torch.ops.cuda.channorm import (
    channel_norm_relu, channel_norm_relu_plain,
)
from vap_realtime_tpu_torch.runtime import incremental as tinc
from vap_realtime_tpu_torch.weights.convert import params_to_torch

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)
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
                                      init(jax.random.PRNGKey(3), jc))


def _norm_inputs(seed=0):
    """A (6, 256, 40) activation with per-channel offsets and a few
    near-constant columns (the clamp's case), and a (256, 1) affine."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(6, 256, 40) * 2 + rs.randn(1, 256, 1)).astype(np.float32)
    x[2, :, 7] = 0.5                                   # zero variance
    w = (1 + 0.3 * rs.randn(256, 1)).astype(np.float32)
    b = (0.2 * rs.randn(256, 1)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype):
    """channel_norm_relu_plain against the TPU kernel in interpret mode on
    (6, 256, 40).  float32: atol 1e-5.  bf16: both normalise in float32
    and round the same ops to bf16, so the only differences come from
    float32 stats summed in another order moving a value across a bf16
    rounding boundary: at most one bf16 step, |d| <= 2^-7 |want| + 1e-6
    (measured: one element of 61,440 one step off)."""
    x, w, b = _norm_inputs()
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_channel_norm_relu(
        jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b)).astype(
            jnp.float32))
    td = getattr(torch, dtype)
    got = channel_norm_relu_plain(T_(x).to(td), T_(w), T_(b))
    assert got.dtype == td and (got >= 0).all()
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    np.testing.assert_array_equal(got[2, :, 7], want[2, :, 7])


def test_wrapper_cpu_dispatch_and_checks():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing; any other non-CUDA device raises instead of falling back."""
    x, w, b = map(T_, _norm_inputs(1))
    before = channel_norm_relu.launches
    assert torch.equal(channel_norm_relu(x, w, b),
                       channel_norm_relu_plain(x, w, b))
    assert channel_norm_relu.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        channel_norm_relu(x.to("meta"), w.to("meta"), b.to("meta"))


def test_normk_stack_matches_jax():
    """The normk streaming conv stack, 3 frames with carries, against
    JAX `cpc_conv_stack_streaming_normk`: features and every carry to
    atol 1e-5."""
    jc, jp = _params()
    enc_j = jp["encoder"]
    enc_t = params_to_torch(enc_j)
    n = 4
    st_j = jenc.init_conv_stream_state(n, jc.encoder_dim)
    st_t = tenc.init_conv_stream_state(n, jc.encoder_dim)
    rs = np.random.RandomState(2)
    for f in range(3):
        new = (0.1 * rs.randn(n, jc.frame_shift)).astype(np.float32)
        z_j, st_j = jenc.cpc_conv_stack_streaming_normk(
            enc_j, jnp.asarray(new), st_j)
        z_t, st_t = tenc.cpc_conv_stack_streaming_normk(enc_t, T_(new), st_t)
        np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5,
                                   err_msg=f"features frame {f}")
        for k in st_j:
            np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                       atol=1e-5, err_msg=f"{k} frame {f}")


def test_fast_step_normk_matches_jax():
    """fast_step(conv_impl="normk", slots="staged") against the JAX one
    (attend "pallas", both Pallas kernels in interpret mode), 12 frames
    past a merge with mixed activity: p_now / p_future / vad to atol
    1e-4, stamps equal, conv carries to atol 1e-5."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**NARROW)
    tp = params_to_torch(jp)
    Bs = 3
    jstep = jax.jit(functools.partial(jinc.fast_step, cfg=jc, slots="staged",
                                      attend_impl="pallas",
                                      conv_impl="normk"))
    js = jinc.init_fast_state(jc, Bs, staged=True, conv_impl="normk")
    ts = tinc.init_fast_state(tc, Bs, staged=True, conv_impl="normk")
    rs = np.random.RandomState(6)
    for f in range(12):
        new = (0.1 * rs.randn(Bs, 2, jc.frame_shift)).astype(np.float32)
        act = np.array([True, f % 2 == 0, f % 3 != 0])
        js, jo = jstep(jp, js, jnp.asarray(new), active=jnp.asarray(act))
        ts, to = tinc.fast_step(tp, ts, T_(new), tc, T_(act), slots="staged",
                                attend_impl="kernel", conv_impl="normk")
        for k in ("p_now", "p_future", "vad"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        np.testing.assert_array_equal(ts.kv.stamp.numpy(),
                                      np.asarray(js.kv.stamp))
        for k in js.conv:
            np.testing.assert_allclose(ts.conv[k].numpy(),
                                       np.asarray(js.conv[k]), atol=1e-5,
                                       err_msg=f"{k} frame {f}")


@pytest.mark.parametrize("conv_impl", ["fused", "blocked", "nope"])
def test_unported_conv_impl_raises(conv_impl, monkeypatch):
    """Every conv_impl of the JAX package is ported now: "fused" and
    "blocked" run their own stack and never the "conv" stack instead
    (which raises here), with the same conv state layout; an unknown
    name still raises."""
    tc = tcfg.VapConfig(**NARROW)
    _, jp = _params()
    tp = params_to_torch(jp)
    new = torch.zeros(1, 2, tc.frame_shift)
    if conv_impl == "nope":
        with pytest.raises(ValueError, match="not in"):
            tinc.init_fast_state(tc, 1, conv_impl=conv_impl)
        with pytest.raises(ValueError, match="not in"):
            tinc.fast_step(tp, tinc.init_fast_state(tc, 1), new, tc,
                           conv_impl=conv_impl)
        return
    calls = []

    def refuse(*args):
        raise AssertionError("the conv stack ran")

    def fused(params, x, state, fence=None):
        # the fused kernel is written for 256 channels: at this narrow
        # width the call is recorded and served by the blocked stack
        calls.append(tuple(x.shape))
        return tenc.cpc_conv_stack_streaming_blocked(params, x, state)

    monkeypatch.setattr(tenc, "cpc_conv_stack_streaming", refuse)
    monkeypatch.setattr(tenc, "cpc_conv_stack_streaming_fused", fused)
    st = tinc.init_fast_state(tc, 1, conv_impl=conv_impl)
    layout = lambda s: {k: tuple(v.shape) for k, v in s.conv.items()}
    assert layout(st) == layout(tinc.init_fast_state(tc, 1))
    st, out = tinc.fast_step(tp, st, new, tc, conv_impl=conv_impl)
    assert torch.isfinite(out["p_now"]).all()
    assert calls == ([(2, tc.frame_shift)] if conv_impl == "fused" else [])
