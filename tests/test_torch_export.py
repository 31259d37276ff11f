"""PyTorch port: the static stateless step (`runtime/static.py`) against
the JAX package's, and its `torch.export` round trip and export tool."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.runtime import static as jax_static
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.transformer import (
    _alibi_bias_cached, alibi_bias,
)
from vap_realtime_tpu_torch.runtime.static import make_static_fn, static_step
from vap_realtime_tpu_torch.tools import export_static
from vap_realtime_tpu_torch.weights.convert import (
    load_pytree_npz, params_to_torch,
)
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

CTX = 20                                 # context frames of these tests
# the export's context length: no step of another length runs in this
# file before the export, so the bias of this length is first built while
# the export traces
EXPORT_CTX = 13
NAMES = ("p_now", "p_future", "vad1", "vad2", "e1", "e2", "h", "c")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported():
    """The static step at EXPORT_CTX context frames, exported on the CPU,
    with its params and example inputs."""
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    ep, p, example = export_static.export_artifact(synthetic_params(20), cfg,
                                                   EXPORT_CTX, device="cpu")
    return cfg, ep, p, example


def _inputs(cfg, seed, T=EXPORT_CTX):
    """Random (x1, x2, e1_context, e2_context, h, c) CPU tensors."""
    rs = np.random.RandomState(seed)
    x = (0.1 * rs.randn(2, 1, cfg.frame_samples)).astype(np.float32)
    ctx = (0.5 * rs.randn(2, 1, T, cfg.dim)).astype(np.float32)
    hc = (0.1 * rs.randn(2, 2, cfg.dim)).astype(np.float32)
    return tuple(torch.from_numpy(a)
                 for a in (x[0], x[1], ctx[0], ctx[1], hc[0], hc[1]))


def test_static_step_matches_jax_over_carried_frames():
    """static_step (device="cpu" tensors) against JAX static_step over 10
    frames, each package carrying its own contexts and (h, c) from its
    previous outputs: all eight outputs at atol 1e-5 every frame."""
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    jc = JaxConfig(frame_hz=20, context_len_sec=2.5)
    p = params_to_torch(synthetic_params(20))
    jstep = jax.jit(jax_static.static_step, static_argnums=7)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(20))
    rs = np.random.RandomState(6)
    t_ctx = [torch.zeros(1, CTX, cfg.dim) for _ in range(2)]
    t_hc = [torch.zeros(2, cfg.dim) for _ in range(2)]
    j_ctx = [jnp.zeros((1, CTX, cfg.dim)) for _ in range(2)]
    j_hc = [jnp.zeros((2, cfg.dim)) for _ in range(2)]
    for f in range(10):
        x1, x2 = (0.1 * rs.randn(2, 1, cfg.frame_samples)).astype(np.float32)
        got = static_step(p, torch.from_numpy(x1), torch.from_numpy(x2),
                          *t_ctx, *t_hc, cfg)
        want = jstep(jp, x1, x2, *j_ctx, *j_hc, jc)
        for name, a, b in zip(NAMES, got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       err_msg=f"{name} frame {f}")
        t_ctx = [torch.cat([c, e[None]], 1)[:, 1:]
                 for c, e in zip(t_ctx, got[4:6])]
        t_hc = list(got[6:])
        j_ctx = [jnp.concatenate([c, e[None]], 1)[:, 1:]
                 for c, e in zip(j_ctx, want[4:6])]
        j_hc = list(want[6:])


@pytest.mark.parametrize("ctx", [None, CTX])
def test_make_static_fn_shapes_match_jax(ctx):
    """make_static_fn binds the JAX package's example shapes (99 context
    frames by default), float32 zeros on the CPU when asked."""
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    fn, example = make_static_fn(cfg, ctx, device="cpu")
    _, want = jax_static.make_static_fn(JaxConfig(frame_hz=20,
                                                  context_len_sec=2.5), ctx)
    assert [tuple(e.shape) for e in example] == [w.shape for w in want]
    assert all(e.dtype == torch.float32 and e.device.type == "cpu"
               and not e.any() for e in example)
    assert example[2].shape[1] == (99 if ctx is None else ctx)
    assert fn.cfg is cfg


def test_export_round_trip_equals_eager(exported, tmp_path):
    """The exported program, saved and loaded again, equals the eager step
    on random inputs at atol 1e-6 (all eight outputs)."""
    cfg, ep, p, _ = exported
    path = str(tmp_path / "step.pt2")
    torch.export.save(ep, path)
    reloaded = torch.export.load(path).module()
    args = _inputs(cfg, 1)
    fn, _ = make_static_fn(cfg, EXPORT_CTX, device="cpu")
    with torch.no_grad():
        want = fn(p, *args)
        got = reloaded(p, *args)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   err_msg=name)


def test_export_leaves_the_bias_cache_real(exported):
    """Tracing the step for export builds its AliBi bias anew instead of
    caching the tracer's stand-in: the cached bias of the exported shape
    is a plain tensor afterwards, and the eager step still runs.  A
    dynamic export (a symbolic context length) adds no entry to the
    cache, and the eager step runs at a new length after it."""
    cfg, _, p, _ = exported
    b = alibi_bias(EXPORT_CTX, cfg.num_heads, cfg.context_limit,
                   torch.float32, torch.device("cpu"))
    assert type(b) is torch.Tensor
    out = static_step(p, *_inputs(cfg, 2), cfg)
    assert type(out[0]) is torch.Tensor and torch.isfinite(out[0]).all()
    cached = _alibi_bias_cached.cache_info().currsize
    export_static.export_artifact(synthetic_params(20), cfg, EXPORT_CTX,
                                  device="cpu", dynamic=True)
    assert _alibi_bias_cached.cache_info().currsize == cached
    out = static_step(p, *_inputs(cfg, 3, T=EXPORT_CTX + 4), cfg)
    assert type(out[2]) is torch.Tensor and out[2].shape == (EXPORT_CTX + 4,)
    b = alibi_bias(EXPORT_CTX + 4, cfg.num_heads, cfg.context_limit,
                   torch.float32, torch.device("cpu"))
    assert type(b) is torch.Tensor and torch.isfinite(out[0]).all()


def test_export_tool_writes_and_reloads(tmp_path, capsys):
    """tools/export_static.py writes <out>.pt2 and <out>.npz; the npz holds
    the synthetic params, the reloaded program gives the eager step's
    outputs, and --benchmark times the reloaded program."""
    out = str(tmp_path / "vap")
    export_static.main(["--synthetic_weights", "--out", out,
                        "--context_frames", str(CTX), "--device", "cpu",
                        "--benchmark", "--bench_runs", "2"])
    log = capsys.readouterr().out
    assert "vap.pt2" in log and "ms/inference (2 runs" in log
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    p = params_to_torch(load_pytree_npz(out + ".npz"))
    args = _inputs(cfg, 3, CTX)
    with torch.no_grad():
        got = torch.export.load(out + ".pt2").module()(p, *args)
    want = static_step(params_to_torch(synthetic_params(20)), *args, cfg)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   err_msg=name)
