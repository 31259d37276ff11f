"""PyTorch port: the two-port realtime `VapServer` over loopback on the
CPU against the JAX package's streaming functions, its reconnect
contract, the result wire bytes and its command line."""

import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden_stream
from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.io import wire as jax_wire
from vap_realtime_tpu.runtime.incremental import (
    init_fast_state, run_frames_fast,
)
from vap_realtime_tpu.runtime.streaming import (
    frame_audio, init_stream_state, run_frames,
)
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.runtime import server
from vap_realtime_tpu_torch.runtime.engine import VapEngine
from vap_realtime_tpu_torch.runtime.server import VapServer
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_params,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and the socket tests share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(engine, n_results, send):
    """Start a VapServer on free ports, read `n_results` results on one
    consumer while `send(port_in)` produces, stop; returns the results.
    Every socket and join has a timeout."""
    srv = VapServer(engine, mode="vap", port_in=0, port_out=0)
    srv.start_background()
    results = []

    def consume():
        with socket.create_connection(("127.0.0.1", srv.port_out),
                                      timeout=30) as c:
            while len(results) < n_results:
                results.append(wire.deserialize_result(
                    wire.read_framed(c), "vap"))

    t = threading.Thread(target=consume, daemon=True)
    try:
        t.start()
        deadline = time.time() + 10
        while not srv.clients and time.time() < deadline:
            time.sleep(0.01)
        send(srv.port_in)
        t.join(timeout=30)
    finally:
        srv.stop()
    assert not t.is_alive() and all(not th.is_alive() for th in srv._threads)
    return results


def _producer(audio, n_hops, pause=0.002):
    """A producer that streams `n_hops` 10 ms float64 hops of (2, N)
    audio, paced as the JAX serving test paces them."""
    def send(port):
        with socket.create_connection(("127.0.0.1", port), timeout=10) as p:
            for h in range(n_hops):
                p.sendall(wire.conv_2floatarray_2_bytearray(
                    audio[0, h * 160:(h + 1) * 160],
                    audio[1, h * 160:(h + 1) * 160]))
                time.sleep(pause)
            time.sleep(0.5)          # the last frames' results go out
    return send


@pytest.mark.parametrize("path", ["full", "kv"])
def test_server_overlapped_frames_match_jax(path):
    """VapServer on VapEngine(path="full" | "kv", device="cpu") over the
    20 Hz stream golden's audio: the server prepends 320 zero samples, so
    its first 10 results equal JAX run_frames over the zero-padded audio
    (p_now, p_future, vad at atol 1e-4; kv is exact until the window
    slides), and each result echoes its frame's 800 fresh samples."""
    golden = load_golden_stream("stream_vap_20hz.npz")
    audio = golden["audio"].astype(np.float64)
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    engine = VapEngine(cfg, params=synthetic_params(20), path=path,
                       device="cpu")
    engine.warmup()
    results = _serve(engine, 10, _producer(audio, 14 * 800 // 160))
    assert len(results) == 10

    jc = JaxConfig(frame_hz=20, context_len_sec=2.5)
    padded = np.concatenate([np.zeros((2, 320)), audio[:, :800 * 12]], 1)
    frames = jnp.asarray(frame_audio(padded, jc)[:, None])
    _, want = jax.jit(run_frames, static_argnums=3)(
        jax_params(20), init_stream_state(jc, 1), frames, jc)
    for k in ("p_now", "p_future", "vad"):
        got = np.array([r[k] for r in results])
        np.testing.assert_allclose(got, np.asarray(want[k][:10, 0]),
                                   atol=1e-4, err_msg=k)
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r["x1"],
                                      audio[0, i * 800:(i + 1) * 800])


def test_server_fast_path_matches_jax():
    """VapServer on VapEngine(path="fast", device="cpu"): disjoint
    fresh-sample chunks from sample 0 (no zero prepend); its first 8
    results equal JAX run_frames_fast over the same chunks at atol
    1e-4, and each echoes its whole chunk."""
    golden = load_golden_stream("stream_vap_20hz.npz")
    audio = golden["audio"].astype(np.float64)
    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    engine = VapEngine(cfg, params=synthetic_params(20), path="fast",
                       device="cpu")
    assert engine.chunk_samples == 800 and engine.frame_contxt_padding == 0
    engine.warmup()
    results = _serve(engine, 8, _producer(audio, 10 * 800 // 160))
    assert len(results) == 8

    jc = JaxConfig(frame_hz=20, context_len_sec=1.0)
    fresh = np.stack([audio[:, i * 800:(i + 1) * 800]
                      for i in range(8)])[:, None]
    _, want = jax.jit(run_frames_fast, static_argnums=3)(
        jax_params(20), init_fast_state(jc, 1), jnp.asarray(fresh), jc)
    got = np.array([r["p_now"] for r in results])
    np.testing.assert_allclose(got, np.asarray(want["p_now"][:8, 0]),
                               atol=1e-4)
    np.testing.assert_array_equal(results[3]["x1"], audio[0, 2400:3200])


def test_server_input_reconnect():
    """The producer disconnects after 2 frames; the server listens again
    on the same port and a new producer's frames are served (reference
    vap_main.py:411-414): 4 results in all, the engine's state carried
    across (the JAX server keeps it too)."""
    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    engine = VapEngine(cfg, params=synthetic_params(20), path="full",
                       device="cpu")
    engine.warmup()
    audio = synthetic_audio(16000).astype(np.float64)
    send = _producer(audio, 12, pause=0.005)

    def twice(port):
        send(port)                   # ~2 frames, then disconnect
        time.sleep(0.3)
        send(port)                   # a new producer, 2 more frames

    results = _serve(engine, 4, twice)
    assert len(results) == 4
    assert all(np.isfinite(r["p_now"]).all() for r in results)


@pytest.mark.parametrize("mode", ["vap", "bc", "nod"])
def test_result_wire_bytes_match_jax(mode):
    """One result dict through serialize_result + frame_result gives
    identical bytes in both packages, and the port's reader gets the
    values back."""
    rs = np.random.RandomState(2)
    result = {"t": 1234.5678, "x1": rs.randn(800), "x2": rs.randn(800)}
    for key in server.RESULT_KEYS[mode]:
        result[key] = rs.rand(2) if mode == "vap" else rs.rand(1)
    got = wire.frame_result(wire.serialize_result(result, mode))
    want = jax_wire.frame_result(jax_wire.serialize_result(result, mode))
    assert got == want
    back = wire.deserialize_result(got[4:], mode)
    assert back["t"] == result["t"]
    for key in server.RESULT_KEYS[mode]:
        np.testing.assert_array_equal(back[key], result[key])


@pytest.mark.parametrize("argv,want", [([], False), (["--quant_cache"], "row"),
                                       (["--quant_cache", "row"], "row"),
                                       (["--quant_cache", "global"],
                                        "global")])
def test_server_cli(argv, want):
    """The server's options take the port's form: a bare --quant_cache
    means "row" and every listed value parses as typed (the JAX server's
    choices [True, "row", "global"] reject a typed True); the attend is
    the hand-written kernel by default, the path kv, the device CUDA."""
    args = server.parse_args(["--synthetic_weights"] + argv)
    assert args.quant_cache == want
    assert (args.attend_impl, args.engine_path, args.slots, args.device,
            args.bf16) == ("kernel", "kv", "staged", "cuda", False)
    with pytest.raises(SystemExit):
        server.parse_args(["--synthetic_weights", "--quant_cache", "True"])
    with pytest.raises(SystemExit):
        server.parse_args([])
