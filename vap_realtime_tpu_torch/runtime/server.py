"""Realtime TCP server — wire-compatible with the reference servers.

One audio producer connects to `port_in` and streams 2560-byte packets
(160 interleaved float64 pairs = 10 ms); many consumers connect to
`port_out` and receive length-prefixed result packets after every model
frame (reference rvap/vap_main/vap_main.py:338-527).  The reference's
input and output client scripts work against this server unchanged.
Port of `vap_realtime_tpu/runtime/server.py` on the port's `VapEngine`:
- one engine step per frame; the result hand-off to the distributing
  thread is a Condition (the reference busy-polls every 10 us);
- the first frame starts after 320 zero samples on the paths that take
  overlapped frames, and the fast paths take fresh-sample chunks
  (`engine.frame_contxt_padding` == 0);
- after the producer disconnects the server listens for the next one;
- every result is shipped, in order (the JAX server keeps only the
  latest result for its distributing thread).

Run (on the card):
    python -m vap_realtime_tpu_torch.runtime.server --synthetic_weights \\
        --port_num_in 50007 --port_num_out 50008 --mode vap \\
        [--engine_path kv|fast|full|hybrid|fast_hybrid] [--bf16]
(or --vap_model vap.pt --cpc_model cpc.pt, the reference's checkpoints,
or --checkpoint_npz w.npz, in place of --synthetic_weights).
"""

from __future__ import annotations

import argparse
import collections
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.runtime import cli
from vap_realtime_tpu_torch.runtime.engine import VapEngine

HOP_BYTES = 8 * 2 * 160  # float64 x 2 ch x 160 samples (vap_main.py:374)

# result fields each serving mode ships after the x1/x2 audio echo (wire
# order, reference README.md:160-219)
RESULT_KEYS = {
    "vap": ("p_now", "p_future", "vad"),
    "bc": ("p_bc_react", "p_bc_emo"),
    "nod": ("p_bc", "p_nod_short", "p_nod_long", "p_nod_long_p"),
}


def _close(sock: Optional[socket.socket]) -> None:
    """Shut down and close a socket, ignoring one already closed (a
    blocked recv on it returns)."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    sock.close()


def _listener(host: str, port: int, backlog: int) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(backlog)
    s.settimeout(0.5)
    return s


class VapServer:
    def __init__(self, engine: VapEngine, mode: str = "vap",
                 host: str = "127.0.0.1", port_in: int = 50007,
                 port_out: int = 50008, audio_gain: float = 1.0):
        """engine: a `VapEngine` of batch 1.  port_in / port_out: 0 binds
        a free port; the bound ports are in `port_in` / `port_out` once
        `start_background` returns."""
        self.engine = engine
        self.mode = mode
        self.host = host
        self.port_in = port_in
        self.port_out = port_out
        self.audio_gain = audio_gain
        self.clients: List[socket.socket] = []
        self._clients_lock = threading.Lock()
        self._cond = threading.Condition()
        self._results: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._in_ready = threading.Event()
        self._out_ready = threading.Event()
        self._producer: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []

    # --- output side -------------------------------------------------------

    def _accept_out(self):
        with _listener(self.host, self.port_out, 8) as s:
            self.port_out = s.getsockname()[1]
            self._out_ready.set()
            while not self._stop.is_set():
                try:
                    conn, addr = s.accept()
                except socket.timeout:
                    continue
                print("[OUT] Connected by", addr)
                with self._clients_lock:
                    self.clients.append(conn)
                    print(f"[OUT] Current client num = {len(self.clients)}")

    def _distribute(self):
        while not self._stop.is_set():
            with self._cond:
                if not self._results and not self._cond.wait(timeout=0.5):
                    continue
                results = list(self._results)
                self._results.clear()
            for result in results:
                payload = wire.frame_result(
                    wire.serialize_result(result, self.mode))
                with self._clients_lock:
                    clients = list(self.clients)
                for conn in clients:
                    try:
                        conn.sendall(payload)
                    except OSError:
                        print("[OUT] Disconnected")
                        with self._clients_lock:
                            self.clients.remove(conn)
                        conn.close()

    def _publish(self, t: float, x1: np.ndarray, x2: np.ndarray,
                 outs: Dict[str, np.ndarray]):
        result = {"t": t, "x1": x1, "x2": x2}
        for key in RESULT_KEYS[self.mode]:
            result[key] = np.atleast_1d(outs[key][0])
        with self._cond:
            self._results.append(result)
            self._cond.notify_all()

    # --- input side (main loop) --------------------------------------------

    def _serve_producer(self, conn: socket.socket) -> None:
        """Steps the engine on one producer's hops until it disconnects
        (ConnectionError) or the server stops.  Overlapped-frame paths:
        the first frame starts after `pad` zero samples and each next
        frame re-reads the last `pad` samples; the fast paths (pad == 0,
        chunk == frame_shift) take disjoint fresh-sample chunks."""
        pad = self.engine.frame_contxt_padding
        frame = self.engine.chunk_samples
        x1 = np.zeros(pad)
        x2 = np.zeros(pad)
        while not self._stop.is_set():
            data = wire._read_exact(conn, HOP_BYTES)
            a1, a2 = wire.conv_bytearray_2_2floatarray(data)
            if self.audio_gain != 1.0:
                a1 = a1 * self.audio_gain
                a2 = a2 * self.audio_gain
            x1 = np.concatenate([x1, a1])
            x2 = np.concatenate([x2, a2])
            if len(x1) < frame:
                continue
            outs = self.engine.process_batch(
                np.stack([x1[:frame], x2[:frame]])[None])
            self._publish(time.time(), x1[pad:frame], x2[pad:frame], outs)
            x1 = x1[frame - pad:]
            x2 = x2[frame - pad:]

    def _serve_in(self):
        while not self._stop.is_set():
            try:
                with _listener(self.host, self.port_in, 1) as s:
                    self.port_in = s.getsockname()[1]  # re-listen on it
                    self._in_ready.set()
                    print("[IN] Waiting for connection of audio input...")
                    conn = None
                    while conn is None and not self._stop.is_set():
                        try:
                            conn, addr = s.accept()
                        except socket.timeout:
                            continue
                    if conn is None:
                        return
                    print("[IN] Connected by", addr)
                    self._producer = conn
                    with conn:
                        self._serve_producer(conn)
            except ConnectionError:
                print("[IN] Disconnected")
            except OSError as e:
                if self._stop.is_set():
                    return
                print("[IN] socket error:", e)
                time.sleep(0.2)
            finally:
                self._producer = None

    def _start(self, serve_in: bool) -> None:
        targets = [self._accept_out, self._distribute]
        if serve_in:
            targets.append(self._serve_in)
        for target in targets:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def serve_forever(self):
        self._start(serve_in=False)
        self._serve_in()

    def start_background(self, timeout: float = 10.0):
        """Start every thread; returns once both ports listen."""
        self._start(serve_in=True)
        if not (self._in_ready.wait(timeout)
                and self._out_ready.wait(timeout)):
            raise RuntimeError("the server's ports did not open")
        return self._threads[-1]

    def stop(self, timeout: float = 5.0):
        """Stop serving: unblocks the producer's read, closes the result
        connections and joins the threads `start_background` started."""
        self._stop.set()
        _close(self._producer)
        for t in self._threads:
            t.join(timeout)
        with self._clients_lock:
            for conn in self.clients:
                _close(conn)
            self.clients.clear()


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    cli.add_weight_args(ap)
    ap.add_argument("--port_num_in", type=int, default=50007)
    ap.add_argument("--port_num_out", type=int, default=50008)
    ap.add_argument("--vap_process_rate", type=int, default=20)
    ap.add_argument("--context_len_sec", type=float, default=2.5)
    ap.add_argument("--audio_gain", type=float, default=1.0)
    ap.add_argument("--mode", choices=["vap", "bc", "nod"], default="vap")
    cli.add_step_args(ap)
    args = ap.parse_args(argv)
    cli.check_weight_args(ap, args)
    return args


def main(argv: Optional[list] = None):
    args = parse_args(argv)
    cfg = VapConfig(frame_hz=args.vap_process_rate,
                    context_len_sec=args.context_len_sec, mode=args.mode)
    engine = VapEngine(cfg, params=cli.load_weights(args, cfg),
                       path=args.engine_path, slots=args.slots,
                       attend_impl=args.attend_impl,
                       quant_cache=args.quant_cache,
                       dtype=torch.bfloat16 if args.bf16 else torch.float32,
                       device=args.device)
    engine.warmup()
    server = VapServer(engine, mode=args.mode, port_in=args.port_num_in,
                       port_out=args.port_num_out,
                       audio_gain=args.audio_gain)
    print(f"[VAP] serving mode={args.mode} at {cfg.frame_hz} Hz, "
          f"in={args.port_num_in} out={args.port_num_out}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
