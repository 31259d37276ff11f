"""PyTorch port: the serving arena (every path) against the JAX
package's arena, and the native server over loopback (CPU)."""

import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.runtime.arena import StreamArena as JaxArena
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.runtime.arena import StreamArena, resolve_device
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_params,
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


def test_arena_matches_jax_arena_with_lifecycle():
    """Same slot lifecycle on both arenas — add, partial ticks, remove,
    re-add (slot reuse), reset_slots mid-run — past two merges and the
    ring wrap: every served output agrees."""
    jc = jcfg.VapConfig(**NARROW)
    init = jax.jit(init_vap_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(2), jc))
    ja = JaxArena(jc, jp, capacity=4, path="fast", attend_impl="pallas")
    ta = StreamArena(VapConfig(**NARROW), jp, capacity=4, path="fast",
                     device="cpu")
    ja.warmup()
    ta.warmup()
    slots = [ja.add_stream() for _ in range(3)]
    assert [ta.add_stream() for _ in range(3)] == slots
    rs = np.random.RandomState(0)
    for tick in range(26):
        if tick == 9:
            ja.remove_stream(slots[1])
            ta.remove_stream(slots[1])
        if tick == 12:
            s_j, s_t = ja.add_stream(), ta.add_stream()
            assert s_j == s_t == slots[1]
        if tick == 17:
            ja.reset_slots([slots[2]])
            ta.reset_slots([slots[2]])
        live = [s for s in slots if s in ta._active]
        feed = [s for i, s in enumerate(live) if (tick + i) % 3 != 1]
        chunks = {s: (0.1 * rs.randn(2, ta.chunk_samples))
                  .astype(np.float32) for s in feed}
        out_j, out_t = ja.step(chunks), ta.step(chunks)
        assert out_t.keys() == out_j.keys()
        for s in feed:
            for k in ("p_now", "p_future", "vad", "H"):
                np.testing.assert_allclose(out_t[s][k], out_j[s][k],
                                           atol=1e-4,
                                           err_msg=f"{k} slot {s} tick {tick}")
    assert ta.n_active == 3 and ta.add_stream() is not None
    assert ta.add_stream() is None                      # full


@pytest.mark.parametrize("path", ["kv", "full"])
def test_kv_and_full_arenas_match_jax_arena(path):
    """StreamArena(path="kv" | "full") against the JAX arena through an
    add / partial ticks / remove / re-add / reset lifecycle, past a staged
    merge and the ring wrap (T = 20 at 1 s, 22 ticks): every served output
    at atol 1e-4.  The JAX kv arena runs the einsum attend; the port's
    passes attend_impl through (here the kernel's plain version)."""
    jc = jcfg.VapConfig(**NARROW)
    init = jax.jit(init_vap_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3), jc))
    ja = JaxArena(jc, jp, capacity=3, path=path)
    ta = StreamArena(VapConfig(**NARROW), jp, capacity=3, path=path,
                     device="cpu")
    assert ta.chunk_samples == ja.chunk_samples == jc.frame_samples
    ja.warmup()
    ta.warmup()
    slots = [ja.add_stream() for _ in range(2)]
    assert [ta.add_stream() for _ in range(2)] == slots
    rs = np.random.RandomState(1)
    for tick in range(22):
        if tick == 6:
            ja.remove_stream(slots[1])
            ta.remove_stream(slots[1])
        if tick == 9:
            s_j, s_t = ja.add_stream(), ta.add_stream()
            assert s_j == s_t == slots[1]
        if tick == 14:
            ja.reset_slots([slots[0]])
            ta.reset_slots([slots[0]])
        live = [s for s in slots if s in ta._active]
        feed = [s for i, s in enumerate(live) if (tick + i) % 4 != 1]
        chunks = {s: (0.1 * rs.randn(2, ta.chunk_samples))
                  .astype(np.float32) for s in feed}
        out_j, out_t = ja.step(chunks), ta.step(chunks)
        for s in feed:
            for k in ("p_now", "p_future", "vad", "H"):
                np.testing.assert_allclose(out_t[s][k], out_j[s][k],
                                           atol=1e-4,
                                           err_msg=f"{k} slot {s} tick {tick}")


@pytest.mark.parametrize("path", ["hybrid", "fast_hybrid"])
def test_hybrid_arenas_match_jax_arena(path):
    """StreamArena(path="hybrid" | "fast_hybrid", resync_every=5) against
    the JAX arena through an add / partial ticks / remove / re-add / reset
    lifecycle: the warm-up ticks count in the cadence, resync ticks fall
    on merge ticks and on others (staged slots, merge every 8), the ring
    wraps (T = 20, 23 ticks); every served output at atol 1e-4.  The JAX
    hybrid arena runs the einsum attend; the port's passes attend_impl
    through (here the kernel's plain version)."""
    jc = jcfg.VapConfig(**NARROW)
    init = jax.jit(init_vap_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(4), jc))
    kw = dict(capacity=3, path=path, resync_every=5)
    ja = JaxArena(jc, jp, attend_impl="pallas", **kw)
    ta = StreamArena(VapConfig(**NARROW), jp, device="cpu", **kw)
    assert ta.chunk_samples == ja.chunk_samples
    ja.warmup()
    ta.warmup()
    assert ta.state.kv.step == ja._tick == 3
    slots = [ja.add_stream() for _ in range(2)]
    assert [ta.add_stream() for _ in range(2)] == slots
    rs = np.random.RandomState(2)
    for tick in range(23):
        if tick == 6:
            ja.remove_stream(slots[1])
            ta.remove_stream(slots[1])
        if tick == 8:
            s_j, s_t = ja.add_stream(), ta.add_stream()
            assert s_j == s_t == slots[1]
        if tick == 15:
            ja.reset_slots([slots[0]])
            ta.reset_slots([slots[0]])
        live = [s for s in slots if s in ta._active]
        feed = [s for i, s in enumerate(live) if (tick + i) % 4 != 1]
        chunks = {s: (0.1 * rs.randn(2, ta.chunk_samples))
                  .astype(np.float32) for s in feed}
        out_j, out_t = ja.step(chunks), ta.step(chunks)
        for s in feed:
            for k in ("p_now", "p_future", "vad", "H"):
                np.testing.assert_allclose(out_t[s][k], out_j[s][k],
                                           atol=1e-4,
                                           err_msg=f"{k} slot {s} tick {tick}")


def test_arena_defaults_to_cuda():
    """Entry points run on the card unless asked for the CPU; without
    CUDA they raise instead of falling back; an unknown path raises."""
    with pytest.raises(ValueError, match="unknown path"):
        StreamArena(VapConfig(**NARROW), synthetic_params(20),
                    path="hybrid2", device="cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamArena(VapConfig(**NARROW), synthetic_params(20), capacity=2)


def _send_hops(sock, pcm, hops):
    for h in hops:
        pair = np.empty((160, 2), "<i2")
        pair[:, 0] = pcm[0, h * 160:(h + 1) * 160]
        pair[:, 1] = pcm[1, h * 160:(h + 1) * 160]
        sock.sendall(pair.tobytes())
        time.sleep(0.01)


def _read_results(sock, buf, results, want, timeout=10.0):
    deadline = time.time() + timeout
    while len(results) < want and time.time() < deadline:
        try:
            buf += sock.recv(65536)
        except socket.timeout:
            break
        while len(buf) >= 4:
            ln = int.from_bytes(buf[:4], "little")
            if len(buf) < 4 + ln:
                break
            results.append(wire.deserialize_result(buf[4:4 + ln], "vap"))
            buf = buf[4 + ln:]
    return buf


def test_native_server_int16_matches_arena():
    """The port's native server with the int16 wire at capacity 2: four
    requests over loopback; the echoed x1 is the sent audio and p_now is
    the port arena's own output for the same frames."""
    from vap_realtime_tpu_torch.runtime.server_native import NativeVapServer

    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    params = synthetic_params(20)
    arena = StreamArena(cfg, params, capacity=2, path="fast",
                        wire_dtype=np.int16, device="cpu")
    arena.warmup()
    srv = NativeVapServer(arena, port=0, wire_int16=True)
    assert srv.ingest.frame_samples == cfg.frame_shift
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    audio = synthetic_audio(16000)
    pcm = np.clip(audio * 32768, -32768, 32767).astype("<i2")
    results, buf = [], b""
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=15) as s:
            s.settimeout(15)
            for i in range(4):
                _send_hops(s, pcm, range(5 * i, 5 * i + 5))
                buf = _read_results(s, buf, results, i + 1)
    finally:
        srv.stop()
    th.join(timeout=5)
    assert not th.is_alive()
    assert len(results) == 4

    ref = StreamArena(cfg, params, capacity=2, path="fast",
                      wire_dtype=np.int16, device="cpu")
    ref.warmup()
    slot = ref.add_stream()
    shift = cfg.frame_shift
    for i, res in enumerate(results):
        np.testing.assert_allclose(np.asarray(res["x1"]),
                                   audio[0, i * shift:(i + 1) * shift],
                                   atol=1.5 / 32768)
        want = ref.step({slot: pcm[:, i * shift:(i + 1) * shift]})[slot]
        np.testing.assert_allclose(np.asarray(res["p_now"]), want["p_now"],
                                   atol=1e-5, err_msg=f"result {i}")
        np.testing.assert_allclose(np.asarray(res["vad"]), want["vad"],
                                   atol=1e-5)


def test_native_server_kv_matches_arena():
    """The native server on the kv path (int16 wire, capacity 2): the
    ingest engine emits frames that overlap the previous one by 320
    samples (zeros before the first); four requests over loopback, each
    result's echo is the frame's fresh audio and its p_now the kv arena's
    own output for the same overlapped frames."""
    from vap_realtime_tpu_torch.runtime.server_native import NativeVapServer

    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    params = synthetic_params(20)
    kw = dict(capacity=2, path="kv", wire_dtype=np.int16, device="cpu")
    arena = StreamArena(cfg, params, **kw)
    arena.warmup()
    srv = NativeVapServer(arena, port=0, wire_int16=True)
    assert srv.ingest.frame_samples == cfg.frame_samples
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    audio = synthetic_audio(16000)
    pcm = np.clip(audio * 32768, -32768, 32767).astype("<i2")
    results, buf = [], b""
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=15) as s:
            s.settimeout(15)
            for i in range(4):
                _send_hops(s, pcm, range(5 * i, 5 * i + 5))
                buf = _read_results(s, buf, results, i + 1)
    finally:
        srv.stop()
    th.join(timeout=5)
    assert not th.is_alive()
    assert len(results) == 4

    ref = StreamArena(cfg, params, **kw)
    ref.warmup()
    slot = ref.add_stream()
    shift, pad = cfg.frame_shift, cfg.frame_samples - cfg.frame_shift
    padded = np.concatenate([np.zeros((2, pad), "<i2"), pcm], axis=1)
    for i, res in enumerate(results):
        np.testing.assert_allclose(np.asarray(res["x1"]),
                                   audio[0, i * shift:(i + 1) * shift],
                                   atol=1.5 / 32768)
        frame = padded[:, i * shift:i * shift + cfg.frame_samples]
        want = ref.step({slot: frame})[slot]
        np.testing.assert_allclose(np.asarray(res["p_now"]), want["p_now"],
                                   atol=1e-5, err_msg=f"result {i}")
