"""PyTorch port: `BatchedVapServer` (one connection = one stream, one
arena step per tick) over loopback on the CPU, against the JAX
package's `StreamArena` stepped on the same chunks."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.runtime.arena import StreamArena as JaxArena
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.runtime import server_batched
from vap_realtime_tpu_torch.runtime.arena import StreamArena
from vap_realtime_tpu_torch.runtime.server_batched import BatchedVapServer
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_params,
)

N_CONN, N_RESULTS = 3, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and the socket tests share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lockstep_client(port, audio, n_results, out):
    """One stream: 5 hops (one frame of fresh samples), then wait for its
    result, `n_results` times, so the server steps every frame of it."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.settimeout(30)
        hop = 0
        while len(out) < n_results:
            s.sendall(wire.conv_2floatarray_2_bytearray(
                audio[0, hop * 160:(hop + 1) * 160],
                audio[1, hop * 160:(hop + 1) * 160]))
            hop += 1
            if hop % 5 == 0:
                out.append(wire.deserialize_result(wire.read_framed(s),
                                                   "vap"))


def server_frames(audio, path, cfg, n):
    """The chunks the server cuts from one stream: overlapped frames after
    320 zero samples (kv), or disjoint fresh-sample chunks (fast)."""
    shift = cfg.frame_shift
    if path == "fast":
        return [audio[:, f * shift:(f + 1) * shift] for f in range(n)]
    padded = np.concatenate([np.zeros((2, 320)), audio], axis=1)
    return [padded[:, f * shift:f * shift + cfg.frame_samples]
            for f in range(n)]


@pytest.mark.parametrize("path", ["kv", "fast"])
def test_batched_server_matches_jax_arena(path):
    """Three connections with different audio on a capacity-4 arena
    (device="cpu"): each receives its own results in order, equal to a
    JAX StreamArena stepped on the same chunks (p_now, p_future, vad at
    atol 1e-4), and each result echoes its frame's fresh samples."""
    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    arena = StreamArena(cfg, synthetic_params(20), capacity=4, path=path,
                        device="cpu")
    arena.warmup()
    srv = BatchedVapServer(arena, port=0)
    srv.start_background()
    audios = [synthetic_audio(16000, seed=30 + i).astype(np.float64)
              for i in range(N_CONN)]
    results = [[] for _ in range(N_CONN)]
    clients = [threading.Thread(target=lockstep_client, daemon=True,
                                args=(srv.bound_port, audios[i], N_RESULTS,
                                      results[i]))
               for i in range(N_CONN)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
    finally:
        srv.stop()
    assert not any(c.is_alive() for c in clients)
    assert [len(r) for r in results] == [N_RESULTS] * N_CONN

    jc = JaxConfig(frame_hz=20, context_len_sec=1.0)
    ref = JaxArena(jc, jax_params(20), capacity=4, path=path)
    ref.warmup()
    slots = [ref.add_stream() for _ in range(N_CONN)]
    frames = [server_frames(a, path, cfg, N_RESULTS) for a in audios]
    for f in range(N_RESULTS):
        want = ref.step({s: frames[i][f].astype(np.float32)
                         for i, s in enumerate(slots)})
        for i, s in enumerate(slots):
            for k in ("p_now", "p_future", "vad"):
                np.testing.assert_allclose(
                    results[i][f][k], np.asarray(want[s][k]), atol=1e-4,
                    err_msg=f"{path} connection {i} frame {f} {k}")
            np.testing.assert_array_equal(
                results[i][f]["x1"],
                audios[i][0, f * cfg.frame_shift:(f + 1) * cfg.frame_shift])


def test_batched_server_rejects_when_full():
    """On a full arena a new connection is closed at once (the client
    reads EOF); after a stream leaves, its slot serves a new one."""
    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    arena = StreamArena(cfg, synthetic_params(20), capacity=1, path="fast",
                        device="cpu")
    arena.warmup()
    srv = BatchedVapServer(arena, port=0)
    srv.start_background()
    audio = synthetic_audio(8000, seed=3).astype(np.float64)
    try:
        first = socket.create_connection(("127.0.0.1", srv.bound_port),
                                         timeout=10)
        out = []
        with first:
            first.settimeout(10)
            first.sendall(wire.conv_2floatarray_2_bytearray(
                audio[0, :160], audio[1, :160]))   # admitted: a reader runs
            with socket.create_connection(("127.0.0.1", srv.bound_port),
                                          timeout=10) as extra:
                extra.settimeout(10)
                assert extra.recv(1) == b""        # rejected: closed
            assert arena.n_active == 1
        deadline = time.time() + 10
        while arena.n_active and time.time() < deadline:
            time.sleep(0.01)
        # the first stream left; a new one takes its slot and is served
        lockstep_client(srv.bound_port, audio, 2, out)
    finally:
        srv.stop()
    assert len(out) == 2 and np.isfinite(out[1]["p_now"]).all()


def test_batched_server_cli():
    """The batched server's options: the port's step options (kernel
    attend, kv path, staged slots, bare --quant_cache = "row", CUDA),
    its port and capacity, and a source of weights."""
    args = server_batched.parse_args(["--synthetic_weights",
                                      "--quant_cache", "--capacity", "8"])
    assert (args.quant_cache, args.capacity, args.port, args.engine_path,
            args.attend_impl, args.device) == ("row", 8, 50010, "kv",
                                               "kernel", "cuda")
    with pytest.raises(SystemExit):
        server_batched.parse_args(["--capacity", "8"])
