"""PyTorch port against the original PyTorch reference's goldens
(tests/golden/*.npz, produced by tools/generate_golden.py from the
reference code with the synthetic weights), atol 1e-4 as in
tests/test_parity.py, with the port's own `synthetic_params`: the
chunked encoder, the whole-sequence model core and the full-recompute
stream, frame by frame."""

import functools

import numpy as np
import pytest
import torch

from tests.conftest import load_golden_stream
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.encoder import cpc_conv_stack, encode_chunk
from vap_realtime_tpu_torch.models.vap import (
    forward_context, probs_from_outputs, trunk_forward,
)
from vap_realtime_tpu_torch.runtime.streaming import (
    frame_audio, init_stream_state, run_frames,
)
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(frame_hz=20, mode="vap"):
    return params_to_torch(synthetic_params(frame_hz, mode=mode))


def _chunk(golden_unit):
    return torch.as_tensor(golden_unit["chunk"])[None]      # (1, 1120)


def test_conv_stack_golden(golden_unit):
    out = cpc_conv_stack(_params()["encoder"], _chunk(golden_unit))
    assert out.shape == (1, 7, 256)
    np.testing.assert_allclose(out[0].numpy(), golden_unit["conv_out"].T,
                               atol=ATOL)


def test_encode_chunk_golden(golden_unit):
    z = torch.zeros(1, 256)
    emb, h, c = encode_chunk(_params()["encoder"], _chunk(golden_unit), z, z,
                             5)
    assert h.shape == c.shape == (1, 256)
    np.testing.assert_allclose(emb[0].numpy(), golden_unit["emb"],
                               atol=ATOL)


def test_forward_context_golden(golden_unit):
    """The whole-sequence trunk and heads on the golden embeddings:
    logits and probabilities, and the trunk's streams o1 / o2 / x, which
    the JAX package's parity test does not check."""
    cfg = VapConfig(frame_hz=20)
    p = _params()
    e1, e2 = (torch.as_tensor(golden_unit[k]) for k in ("e1", "e2"))
    trunk = trunk_forward(p, e1, e2, cfg)
    for key, ref in (("o1", "o1"), ("o2", "o2"), ("x", "trunk_x")):
        np.testing.assert_allclose(trunk[key].numpy(), golden_unit[ref],
                                   atol=ATOL, err_msg=key)
    outs = forward_context(p, e1, e2, cfg)
    np.testing.assert_allclose(outs["logits"].numpy(), golden_unit["logits"],
                               atol=ATOL)
    probs = probs_from_outputs(outs, cfg)
    for key in ("p_now", "p_future"):
        np.testing.assert_allclose(probs[key].numpy(), golden_unit[key],
                                   atol=ATOL, err_msg=key)


def _run_stream(golden, cfg, mode="vap"):
    frames = torch.as_tensor(frame_audio(golden["audio"], cfg)[:, None])
    _, outs = run_frames(_params(cfg.frame_hz, mode),
                         init_stream_state(cfg, 1), frames, cfg)
    return {k: v[:, 0].numpy() for k, v in outs.items()}


@pytest.mark.parametrize("name,hz,ctx,mode,keys", [
    ("stream_vap_20hz", 20, 2.5, "vap", ("p_now", "p_future", "vad")),
    ("stream_vap_10hz", 10, 5.0, "vap", ("p_now", "p_future", "vad")),
    ("stream_vap_50hz", 50, 1.0, "vap", ("p_now", "p_future", "vad")),
    ("stream_bc_10hz", 10, 5.0, "bc", ("p_bc_react", "p_bc_emo")),
    ("stream_nod_10hz", 10, 5.0, "nod",
     ("p_bc", "p_nod_short", "p_nod_long", "p_nod_long_p")),
])
def test_stream_golden(name, hz, ctx, mode, keys):
    """run_frames (full recompute) over the golden audio, frame by frame,
    every key tests/test_parity.py checks for the file."""
    golden = load_golden_stream(f"{name}.npz")
    cfg = VapConfig(frame_hz=hz, context_len_sec=ctx, mode=mode)
    outs = _run_stream(golden, cfg, mode)
    assert outs["p_now"].shape[0] == golden["p_now"].shape[0]
    for key in keys:
        np.testing.assert_allclose(outs[key], golden[key], atol=ATOL,
                                   err_msg=key)
