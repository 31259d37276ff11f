"""PyTorch port: `VapEngine` (paths "fast", "kv" and "full") against the
JAX package's engine on the same params, its chunk contract, and the
paths that wait for later slices."""

import jax
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.runtime.engine import VapEngine as JaxEngine
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime.engine import VapEngine
from vap_realtime_tpu_torch.weights.convert import save_pytree_npz

# the fused conv stack is written for the encoder's 256 channels
SMALL = dict(dim=256, encoder_dim=256, num_heads=4, frame_hz=20,
             context_len_sec=1.0, cross_layers=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and timing-sensitive socket tests share the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    jc = jcfg.VapConfig(**SMALL)
    init = jax.jit(init_vap_params, static_argnums=1)
    return jc, jax.tree_util.tree_map(np.asarray,
                                      init(jax.random.PRNGKey(6), jc))


def test_fast_engine_matches_jax_engine(tmp_path):
    """VapEngine(path="fast", conv_impl="fused", device="cpu"), built
    from a pytree .npz, against the JAX engine (attend "pallas",
    conv_impl "fused", interpret mode) built from the same params: 6
    frames through process_batch (after warmup, which leaves the state
    as it was) and 2 through process, every output to atol 1e-4."""
    jc, jp = _params()
    path = str(tmp_path / "params.npz")
    save_pytree_npz(path, jp)
    kw = dict(path="fast", batch=2, conv_impl="fused")
    je = JaxEngine(jc, params=jp, attend_impl="pallas", **kw)
    te = VapEngine(VapConfig(**SMALL), checkpoint_npz=path,
                   attend_impl="kernel", device="cpu", **kw)
    assert te.chunk_samples == je.chunk_samples == jc.frame_shift
    assert te.frame_contxt_padding == je.frame_contxt_padding == 0
    je.warmup()
    te.warmup()
    assert te.state.kv.step == 0 and int(te.state.kv.count.sum()) == 0
    rs = np.random.RandomState(3)
    for f in range(6):
        chunk = (0.1 * rs.randn(2, 2, jc.frame_shift)).astype(np.float32)
        want, got = je.process_batch(chunk), te.process_batch(chunk)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        assert te.result is got and te.result_last_time > 0
    one = VapEngine(VapConfig(**SMALL), params=jp, conv_impl="fused",
                    device="cpu")
    one_j = JaxEngine(jc, params=jp, path="fast", attend_impl="pallas",
                      conv_impl="fused")
    for f in range(2):
        x1, x2 = (0.1 * rs.randn(2, jc.frame_shift)).astype(np.float32)
        want, got = one_j.process(x1, x2), one.process(x1, x2)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")


@pytest.mark.parametrize("path", ["kv", "full"])
def test_kv_and_full_engines_match_jax(path):
    """VapEngine(path="kv" | "full", device="cpu") against the JAX engine
    on the same params, 6 frames of overlapped chunks through
    process_batch at atol 1e-4 (kv: the attend kernel's plain version
    against the TPU kernel in interpret mode, staged slots)."""
    jc, jp = _params()
    je = JaxEngine(jc, params=jp, path=path, batch=2, attend_impl="pallas")
    te = VapEngine(VapConfig(**SMALL), params=jp, path=path, batch=2,
                   device="cpu")
    assert te.chunk_samples == je.chunk_samples == jc.frame_samples
    assert te.frame_contxt_padding == je.frame_contxt_padding == 320
    je.warmup()
    te.warmup()
    rs = np.random.RandomState(4)
    for f in range(6):
        chunk = (0.1 * rs.randn(2, 2, jc.frame_samples)).astype(np.float32)
        want, got = je.process_batch(chunk), te.process_batch(chunk)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")


def test_chunk_shape_is_checked():
    """process_batch takes (batch, 2, chunk_samples) and raises on any
    other shape; process needs batch 1."""
    _, jp = _params()
    eng = VapEngine(VapConfig(**SMALL), params=jp, batch=2, device="cpu")
    assert eng.chunk_samples == eng.audio_frame_size == 800
    with pytest.raises(ValueError, match="expected chunk shape"):
        eng.process_batch(np.zeros((2, 2, 1120), np.float32))
    with pytest.raises(ValueError, match="process_batch"):
        eng.process(np.zeros(800), np.zeros(800))


@pytest.mark.parametrize("path", ["hybrid", "fast_hybrid", "nope"])
def test_unported_paths_raise(path):
    """The JAX engine's hybrid paths name the ROADMAP item they wait in;
    an unknown path raises too; neither runs another path instead."""
    _, jp = _params()
    with pytest.raises(ValueError, match="ROADMAP" if path != "nope"
                       else "unknown path"):
        VapEngine(VapConfig(**SMALL), params=jp, path=path, device="cpu")


def test_engine_defaults_to_cuda():
    """The engine runs on the card unless asked for the CPU; without CUDA
    it raises instead of falling back; without params or a checkpoint it
    raises."""
    _, jp = _params()
    with pytest.raises(ValueError, match="params or checkpoint_npz"):
        VapEngine(VapConfig(**SMALL), device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VapEngine(VapConfig(**SMALL), params=jp)
