"""Batched multi-stream TCP server — many dialogues, one card.

Each TCP connection IS one stream: the client sends the reference's
2560-byte float64 hop packets (wire-compatible with the reference input
clients) and receives length-prefixed result packets back on the SAME
socket after every model frame.  A ticker thread steps the whole
`StreamArena` once per frame period; streams without a fresh frame are
frozen for that tick.  When the arena is full, a new connection is
closed at once.  Port of `vap_realtime_tpu/runtime/server_batched.py`.

Run (on the card):
    python -m vap_realtime_tpu_torch.runtime.server_batched \\
        --synthetic_weights --port 50010 --capacity 256 --mode vap \\
        [--engine_path kv|fast|full|hybrid|fast_hybrid] [--bf16]
(or --vap_model vap.pt --cpc_model cpc.pt, the reference's checkpoints,
or --checkpoint_npz w.npz, in place of --synthetic_weights).
"""

from __future__ import annotations

import argparse
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import FRAME_CONTEXT_PADDING, VapConfig
from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.runtime import cli
from vap_realtime_tpu_torch.runtime.arena import FRESH_PATHS, StreamArena
from vap_realtime_tpu_torch.runtime.server import (
    HOP_BYTES, RESULT_KEYS, _close, _listener,
)


class _Conn:
    def __init__(self, sock: socket.socket, slot: int, pad: int):
        self.sock = sock
        self.slot = slot
        self.x1 = np.zeros(pad)
        self.x2 = np.zeros(pad)
        self.pending: Optional[np.ndarray] = None  # next ready frame
        self.last_audio: Optional[tuple] = None
        self.lock = threading.Lock()


class BatchedVapServer:
    def __init__(self, arena: StreamArena, mode: str = "vap",
                 host: str = "127.0.0.1", port: int = 50010):
        """port: 0 binds a free port; the bound port is in `bound_port`
        once `start_background` returns."""
        self.arena = arena
        self.mode = mode
        self.host = host
        self.port = port
        self.conns: Dict[int, _Conn] = {}
        # the fresh-sample paths take disjoint frame_shift chunks; the
        # others overlap the previous frame by 320 samples, the first
        # frame starting after 320 zeros
        self._pad = 0 if arena.path in FRESH_PATHS else FRAME_CONTEXT_PADDING
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._serve_thread: Optional[threading.Thread] = None
        self.bound_port: Optional[int] = None

    # --- per-connection reader ---------------------------------------------

    def _reader(self, conn: _Conn):
        frame = self.arena.chunk_samples
        pad = self._pad
        try:
            while not self._stop.is_set():
                data = wire._read_exact(conn.sock, HOP_BYTES)
                a1, a2 = wire.conv_bytearray_2_2floatarray(data)
                with conn.lock:
                    conn.x1 = np.concatenate([conn.x1, a1])
                    conn.x2 = np.concatenate([conn.x2, a2])
                    if len(conn.x1) >= frame:
                        conn.pending = np.stack([conn.x1[:frame],
                                                 conn.x2[:frame]])
                        conn.last_audio = (conn.x1[pad:frame],
                                           conn.x2[pad:frame])
                        conn.x1 = conn.x1[frame - pad:]
                        conn.x2 = conn.x2[frame - pad:]
        except OSError:            # ConnectionError included
            pass
        finally:
            self._drop(conn)

    def _drop(self, conn: _Conn):
        with self._lock:
            if self.conns.pop(conn.slot, None) is not None:
                self.arena.remove_stream(conn.slot)
                print(f"[ARENA] stream {conn.slot} closed "
                      f"({self.arena.n_active} active)")
        _close(conn.sock)

    # --- ticker: one arena step per frame period ---------------------------

    def _tick(self) -> None:
        chunks = {}
        with self._lock:
            conns = list(self.conns.values())
        for c in conns:
            with c.lock:
                if c.pending is not None:
                    chunks[c.slot] = (c.pending, c.last_audio)
                    c.pending = None
        if not chunks:
            return
        results = self.arena.step({s: v[0] for s, v in chunks.items()})
        t = time.time()
        for c in conns:
            if c.slot not in results:
                continue
            r = results[c.slot]
            x1, x2 = chunks[c.slot][1]
            payload = {"t": t, "x1": x1, "x2": x2}
            for key in RESULT_KEYS[self.mode]:
                payload[key] = np.atleast_1d(r[key])
            try:
                c.sock.sendall(wire.frame_result(
                    wire.serialize_result(payload, self.mode)))
            except OSError:
                self._drop(c)

    def _ticker(self):
        period = 1.0 / self.arena.cfg.frame_hz
        next_t = time.time()
        while not self._stop.is_set():
            now = time.time()
            if now < next_t:
                time.sleep(min(next_t - now, 0.005))
                continue
            next_t += period
            self._tick()

    # --- accept loop --------------------------------------------------------

    def _accept(self, s: socket.socket) -> None:
        try:
            sock, addr = s.accept()
        except socket.timeout:
            return
        slot = self.arena.add_stream()
        if slot is None:
            print("[ARENA] full, rejecting", addr)
            _close(sock)
            return
        conn = _Conn(sock, slot, self._pad)
        with self._lock:
            self.conns[slot] = conn
        print(f"[ARENA] stream {slot} from {addr} "
              f"({self.arena.n_active} active)")
        t = threading.Thread(target=self._reader, args=(conn,), daemon=True)
        t.start()
        self._threads.append(t)

    def serve_forever(self):
        ticker = threading.Thread(target=self._ticker, daemon=True)
        ticker.start()
        self._threads.append(ticker)
        with _listener(self.host, self.port, 64) as s:
            self.bound_port = s.getsockname()[1]
            print(f"[ARENA] capacity {self.arena.capacity} at "
                  f"{self.host}:{self.bound_port}", flush=True)
            while not self._stop.is_set():
                self._accept(s)

    def start_background(self, timeout: float = 10.0):
        """Serve from a thread; returns it once `bound_port` is set."""
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        deadline = time.time() + timeout
        while self.bound_port is None and t.is_alive():
            if time.time() > deadline:
                raise RuntimeError("the server's port did not open")
            time.sleep(0.01)
        self._serve_thread = t
        return t

    def stop(self, timeout: float = 5.0):
        """Stop serving: closes every stream's socket (its reader returns)
        and joins the threads this server started."""
        self._stop.set()
        with self._lock:
            conns = list(self.conns.values())
        for c in conns:
            _close(c.sock)
        if self._serve_thread is not None:
            self._serve_thread.join(timeout)
        for t in list(self._threads):
            t.join(timeout)


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    cli.add_weight_args(ap)
    ap.add_argument("--port", type=int, default=50010)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--vap_process_rate", type=int, default=20)
    ap.add_argument("--context_len_sec", type=float, default=2.5)
    ap.add_argument("--mode", choices=["vap", "bc", "nod"], default="vap")
    cli.add_step_args(ap)
    args = ap.parse_args(argv)
    cli.check_weight_args(ap, args)
    return args


def main(argv: Optional[list] = None):
    args = parse_args(argv)
    cfg = VapConfig(frame_hz=args.vap_process_rate,
                    context_len_sec=args.context_len_sec, mode=args.mode)
    arena = StreamArena(cfg, cli.load_weights(args, cfg),
                        capacity=args.capacity, path=args.engine_path,
                        dtype=torch.bfloat16 if args.bf16 else torch.float32,
                        slots=args.slots, attend_impl=args.attend_impl,
                        quant_cache=args.quant_cache, device=args.device)
    arena.warmup()
    BatchedVapServer(arena, mode=args.mode, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
