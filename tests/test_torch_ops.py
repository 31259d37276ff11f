"""PyTorch port: weights, ops and the streaming encoder against the JAX
package on the same numpy inputs (float32, CPU)."""

import jax
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models import encoder as jenc
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.ops import basic as jops
from vap_realtime_tpu.weights import synthetic as jsyn
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.models import encoder as tenc
from vap_realtime_tpu_torch.ops import basic as tops
from vap_realtime_tpu_torch.weights import synthetic as tsyn
from vap_realtime_tpu_torch.weights.convert import (
    load_pytree_npz, params_to_torch, save_pytree_npz,
)

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and timing-sensitive socket tests share the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def narrow():
    jc = jcfg.VapConfig(**NARROW)
    init = jax.jit(init_vap_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), jc))
    return tcfg.VapConfig(**NARROW), jp, params_to_torch(jp)


def test_params_to_torch_matches_jax_pytree(narrow):
    _, jp, tp = narrow
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys() and len(jl) > 50
    for path, a in jl.items():
        t = tl[path]
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a, err_msg=path)
    bf = params_to_torch(jp, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(bf))


def test_synthetic_weights_and_npz_roundtrip(tmp_path):
    jl = dict(_leaves(jsyn.synthetic_params(20, "nod")))
    tp = tsyn.synthetic_params(20, "nod")
    tl = dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for path in jl:
        np.testing.assert_array_equal(tl[path], np.asarray(jl[path]))
    np.testing.assert_array_equal(tsyn.synthetic_audio(800),
                                  jsyn.synthetic_audio(800))
    save_pytree_npz(str(tmp_path / "w.npz"), tp)
    back = dict(_leaves(load_pytree_npz(str(tmp_path / "w.npz"))))
    assert back.keys() == tl.keys()
    for path in tl:
        np.testing.assert_array_equal(back[path], tl[path])


@pytest.mark.parametrize("op", ["channel_norm", "layer_norm", "gelu",
                                "lstm"])
def test_basic_ops_match_jax(op):
    rs = np.random.RandomState(3)
    x = rs.randn(3, 16, 7).astype(np.float32)
    w = (1 + 0.1 * rs.randn(16, 1)).astype(np.float32)
    b = (0.1 * rs.randn(16, 1)).astype(np.float32)
    T = torch.as_tensor
    if op == "channel_norm":
        x = x + 3.0                            # exercise the single pass
        got = tops.channel_norm(T(x), T(w), T(b)).numpy()
        want = jops.channel_norm(x, w, b)
    elif op == "layer_norm":
        got = tops.layer_norm(T(x), T(w[:, 0][:7]), T(b[:, 0][:7])).numpy()
        want = jops.layer_norm(x, w[:, 0][:7], b[:, 0][:7])
    elif op == "gelu":
        got = tops.gelu(T(x)).numpy()
        want = jops.gelu(x)
    else:
        H = 7
        w_ih = (0.3 * rs.randn(4 * H, 16)).astype(np.float32)
        w_hh = (0.3 * rs.randn(4 * H, H)).astype(np.float32)
        b_ih = (0.1 * rs.randn(4 * H)).astype(np.float32)
        b_hh = (0.1 * rs.randn(4 * H)).astype(np.float32)
        h0 = rs.randn(3, H).astype(np.float32)
        c0 = rs.randn(3, H).astype(np.float32)
        xs = np.swapaxes(x, 1, 2)              # (B, T, in)
        got = [t.numpy() for t in tops.lstm(
            T(xs), T(h0), T(c0), T(w_ih), T(w_hh), T(b_ih), T(b_hh))]
        want = jops.lstm(xs, h0, c0, w_ih, w_hh, b_ih, b_hh)
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(wnt), atol=1e-5)
        return
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_streaming_encoder_matches_jax_and_oracle(narrow):
    """6 consecutive frames through encode_chunk_streaming: embeddings
    and every carry equal JAX's; the frame-by-frame stream equals the
    seamless oracle (the JAX one and the port's own)."""
    cfg, jp, tp = narrow
    enc_j, enc_t = jp["encoder"], tp["encoder"]
    B, F, L = 2, 6, cfg.frame_shift
    C = cfg.encoder_dim
    wav = (0.3 * np.random.RandomState(5).randn(B, F * L)).astype(np.float32)
    js = jenc.init_conv_stream_state(B, C)
    ts = tenc.init_conv_stream_state(B, C)
    jh = jc = np.zeros((B, C), np.float32)
    th = tc = torch.zeros((B, C))
    embs = []
    jstep = jax.jit(jenc.encode_chunk_streaming, static_argnums=5)
    for f in range(F):
        new = wav[:, f * L:(f + 1) * L]
        je, js, jh, jc = jstep(enc_j, new, js, jh, jc, cfg.downsample_kernel)
        te, ts, th, tc = tenc.encode_chunk_streaming(
            enc_t, torch.as_tensor(new), ts, th, tc, cfg.downsample_kernel)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       atol=1e-5, err_msg=f"{k} frame {f}")
        embs.append(te.numpy())
    stream = np.stack(embs, axis=1)                        # (B, F, C)
    oracle_j = np.asarray(jax.jit(
        jenc.encode_sequence_streaming_oracle, static_argnums=2)(
        enc_j, wav, cfg.downsample_kernel))
    oracle_t = tenc.encode_sequence_streaming_oracle(
        enc_t, torch.as_tensor(wav), cfg.downsample_kernel).numpy()
    np.testing.assert_allclose(stream, oracle_j, atol=1e-5)
    np.testing.assert_allclose(oracle_t, oracle_j, atol=1e-5)
