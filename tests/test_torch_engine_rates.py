"""PyTorch port: `VapEngine` on the incremental paths (kv, fast, hybrid)
against the JAX engine at other frame rates than 20 Hz and with the bc
and nod heads, on the same params and chunks."""

import jax
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.runtime.engine import VapEngine as JaxEngine
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime.engine import VapEngine

FRAMES, BATCH = 12, 2
# (frame_hz, head mode); one stereo layer at full width, 1 s of context
# (10 / 50 / 20 frames: at 10 Hz the hybrid path resyncs inside the 12)
VARIANTS = {"10hz": (10, "vap"), "50hz": (50, "vap"), "bc": (20, "bc"),
            "nod": (20, "nod"), "5hz": (5, "nod")}
# the context where 1 s is too short: staged slots need a ring of at
# least 8 rows, so 5 Hz takes 2 s (10 rows: the ring wraps and the hybrid
# path resyncs inside the 12 frames; a frame is 3,200 fresh samples, the
# length K7 takes in pieces on the card)
CONTEXT_SEC = {5: 2.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("path", ["kv", "fast", "hybrid"])
def test_engine_matches_jax_at_other_rates_and_heads(path, variant):
    """VapEngine(path, device="cpu") against the JAX engine (its default
    einsum attend; the port's kernel attend runs its plain version here)
    over 12 frames at batch 2 through process_batch, every output at atol
    1e-4, at 10 and 50 Hz (vap heads), at 20 Hz with the bc and nod
    heads and at 5 Hz with the nod heads."""
    hz, mode = VARIANTS[variant]
    kw = dict(dim=256, encoder_dim=256, num_heads=4, frame_hz=hz,
              context_len_sec=CONTEXT_SEC.get(hz, 1.0), cross_layers=1,
              mode=mode)
    jc = jcfg.VapConfig(**kw)
    init = jax.jit(init_vap_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(8), jc))
    je = JaxEngine(jc, params=jp, path=path, batch=BATCH)
    te = VapEngine(VapConfig(**kw), params=jp, path=path, batch=BATCH,
                   device="cpu")
    assert te.chunk_samples == je.chunk_samples
    rs = np.random.RandomState(hz)
    for f in range(FRAMES):
        chunk = (0.1 * rs.randn(BATCH, 2, je.chunk_samples)).astype(
            np.float32)
        want, got = je.process_batch(chunk), te.process_batch(chunk)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
