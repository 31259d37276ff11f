"""Native-ingest batched server — C++ epoll IO + one arena step per tick.

Connection == stream: hop packets in, length-prefixed results back on
the same socket.  All socket work happens in native/ingest.cpp; Python
does one ctypes poll per tick and one arena step.  Slot lifecycle is
driven by the engine's per-slot generation counters (reuse -> arena
state reset).  Port of `vap_realtime_tpu/runtime/server_native.py` for
every engine path (kv, the default, fast, full, hybrid, fast_hybrid).

Run (on the card):
    python -m vap_realtime_tpu_torch.runtime.server_native \
        --synthetic_weights --capacity 4096 --bf16 --wire_int16 \
        [--engine_path kv|fast|full|hybrid|fast_hybrid] [--quant_cache global]
(or --vap_model vap.pt --cpc_model cpc.pt, the reference's checkpoints,
or --checkpoint_npz w.npz, in place of --synthetic_weights).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import FRAME_CONTEXT_PADDING, VapConfig
from vap_realtime_tpu_torch.io.native_ingest import NativeIngest
from vap_realtime_tpu_torch.runtime import cli
from vap_realtime_tpu_torch.runtime.arena import FRESH_PATHS, StreamArena
from vap_realtime_tpu_torch.runtime.server import RESULT_KEYS
from vap_realtime_tpu_torch.utils.spans import span


class NativeVapServer:
    def __init__(self, arena: StreamArena, mode: str = "vap",
                 port: int = 50011, wire_int16: bool = False):
        self.arena = arena
        self.mode = mode
        # the fast paths' native assembler emits disjoint fresh-sample
        # chunks (frame_shift samples, no overlap); the other paths take
        # frames that overlap the previous one by the reference's
        # 320-sample left context
        self._pad = (0 if arena.path in FRESH_PATHS
                     else FRAME_CONTEXT_PADDING)
        # int16 wire + int16-capable arena: frames stay int16 to the
        # device (normalized there; a quarter of the transfer)
        self._i16 = bool(wire_int16) and np.dtype(arena.wire_dtype) == np.int16
        self.ingest = NativeIngest(port, arena.capacity,
                                   arena.chunk_samples, wire_int16,
                                   overlap=self._pad, emit_i16=self._i16)
        self.port = self.ingest.port
        self._gens = np.zeros((arena.capacity,), np.int64)
        self._stop = False
        self._stopped = False
        self.frames_served = 0
        # one-tick pipeline: (slots, audio echo, outputs in flight to the
        # host, gens) of the previous dispatch, shipped after the current
        # dispatch
        self._pending = None

    def tick(self) -> int:
        """One serving tick: drain ready frames, detect slot reuse,
        dispatch one arena step, ship the PREVIOUS step's results.
        Returns #streams dispatched this tick.  poll() double-buffers its
        frame array, so the previous tick's audio is intact when its
        results ship one tick later.  The three parts are spans
        (`utils/spans.py`): vap.serve.dispatch (n: streams dispatched),
        vap.serve.fetch and vap.serve.send (n: results shipped)."""
        slots, frames = self.ingest.poll()
        with span("vap.serve.dispatch", n=len(slots)):
            gens_now = self.ingest.generations()
            if slots:
                sarr = np.asarray(slots)
                fresh = sarr[gens_now[sarr] != self._gens[sarr]]
                if len(fresh):
                    self.arena.reset_slots(fresh.tolist())
                    self._gens[fresh] = gens_now[fresh]
                out_dev = self.arena.step_device_batch(frames, sarr)
                # the generation each result was computed FOR: the native
                # sender drops a result whose slot was reused since
                prev, self._pending = self._pending, (
                    sarr, frames, self._readback(out_dev),
                    gens_now[sarr].copy())
            else:
                prev, self._pending = self._pending, None
        if prev is None:
            return len(slots)
        p_slots, p_frames, (host, copied), p_gens = prev
        n = len(p_slots)
        with span("vap.serve.fetch", n=n):
            if copied is not None:
                copied.synchronize()   # this tick's step may still be running
            mats = [host[key].numpy()[p_slots].reshape(n, -1)
                    for key in RESULT_KEYS[self.mode]]
        with span("vap.serve.send", n=n):
            probs = np.concatenate(mats, axis=1)
            self.ingest.send_results(p_slots, p_gens, time.time(), p_frames,
                                     self._pad, probs,
                                     [m.shape[1] for m in mats])
        self.frames_served += n
        return len(slots)

    def _readback(self, out):
        """Start the device->host copy of one tick's result fields into
        pinned memory; returns (host tensors, CUDA event that marks the
        copy done, or None on the CPU).  Waiting on the event at ship
        time does not wait for the step dispatched after it."""
        fields = {k: out[k].float() for k in RESULT_KEYS[self.mode]}
        if self.arena.device.type != "cuda":
            return fields, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in fields.items()}
        for k, v in fields.items():
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def serve_forever(self):
        period = 1.0 / self.arena.cfg.frame_hz
        next_t = time.time()
        try:
            while not self._stop:
                now = time.time()
                if now < next_t:
                    time.sleep(min(next_t - now, 0.005))
                    continue
                next_t += period
                self.tick()
        finally:
            # the engine must be destroyed by the loop that uses it
            self.ingest.close()
            self._stopped = True

    def stop(self, timeout: float = 5.0):
        self._stop = True
        deadline = time.time() + timeout
        while not self._stopped and time.time() < deadline:
            time.sleep(0.01)


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    cli.add_weight_args(ap)
    ap.add_argument("--port", type=int, default=50011)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--vap_process_rate", type=int, default=20)
    ap.add_argument("--context_len_sec", type=float, default=2.5)
    ap.add_argument("--mode", choices=["vap", "bc", "nod"], default="vap")
    cli.add_step_args(ap)
    ap.add_argument("--conv_chunks", type=int, default=1,
                    help="run the encoder over k sequential sub-batches "
                         "(smaller transient memory; identical numerics)")
    ap.add_argument("--wire_int16", action="store_true",
                    help="accept int16 hop packets (4x lower bandwidth)")
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
                        quant_cache=args.quant_cache,
                        conv_chunks=args.conv_chunks,
                        wire_dtype=np.int16 if args.wire_int16
                        else np.float32, device=args.device)
    arena.warmup()
    server = NativeVapServer(arena, mode=args.mode, port=args.port,
                             wire_int16=args.wire_int16)
    print(f"[NATIVE] capacity {args.capacity} at 127.0.0.1:{server.port}",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
