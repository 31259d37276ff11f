"""End-to-end serving benchmark through the socket path.

Port of `tools/serving_bench.py`.  For each stream count n, starts the
native-ingest batched server (`runtime/server_native.py`
`NativeVapServer`) in this process over a `StreamArena` of capacity n on
the card, drives it with n loopback streams from the native load
generator (`native/loadgen.cpp`: epoll, paced 10 ms hops, the reference
wire format) in a subprocess, and records sustained results per second
and end-to-end frame latency percentiles, socket ingest, host-to-device
transfer, the step, readback and result serialisation included.  The
server's own split of a tick (dispatch / fetch / send ms) comes from
its spans (`utils/spans.py`, recorded over each run); each run also
records the CPU seconds of the server's process and of the load
generator over its wall seconds.

A run is `realtime` when it delivered at least 97% of n * hz results per
second; `sustained_streams` is the largest n of a realtime run whose p99
frame latency is under two frame periods.

The load generator is built with g++ into `build/vaploadgen` (written
under a temporary name and renamed).  `--stub_device` replaces the arena
with an instant host stub: the host leg of serving alone (ingest, slot
bookkeeping, serialisation, send), with no CUDA touched.  The report's
`config` records the host's CPU count (the server and the load generator
share it) and, on the card, its name and power limit.

Run (on the card; --device cpu for a small CPU run):
    python -m vap_realtime_tpu_torch.tools.serving_bench \
        --streams 1024,4096 --seconds 30 --engine_path fast \
        --attend_impl kernel [--quant_cache global] [--out serving.json]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from vap_realtime_tpu_torch.runtime.cli import add_quant_arg

RAMP_MS = 3000                     # the load generator's connection ramp
# whose CPU seconds a run records: this process, its ended children
_RUSAGE = (resource.RUSAGE_SELF, resource.RUSAGE_CHILDREN)


def build_loadgen() -> str:
    """Build the load generator into build/vaploadgen if it is missing or
    older than its source; returns its path."""
    from vap_realtime_tpu_torch.io.native_ingest import build_native

    return build_native("loadgen.cpp", "vaploadgen", [])


class StubArena:
    """Instant device stub: the serving tick without the device.

    `step_device_batch` returns preallocated CPU tensors at once, so a
    tick is native epoll ingest + slot bookkeeping + the audio-echo
    gather + result serialisation + the native batched send: the host's
    leg of serving."""

    def __init__(self, cfg, capacity: int, path: str, wire_dtype):
        from vap_realtime_tpu_torch.runtime.arena import FRESH_PATHS
        from vap_realtime_tpu_torch.runtime.server import RESULT_KEYS

        self.cfg = cfg
        self.capacity = capacity
        self.path = path
        self.wire_dtype = np.dtype(wire_dtype)
        self.device = torch.device("cpu")
        self.chunk_samples = (cfg.frame_shift if path in FRESH_PATHS
                              else cfg.frame_samples)
        self._out = {k: torch.zeros((capacity, 2))
                     for k in RESULT_KEYS[cfg.mode]}

    def warmup(self):
        pass

    def reset_slots(self, slots):
        pass

    def step_device_batch(self, frames, slots):
        return self._out


def _cpu_s(who: int) -> float:
    """User + system CPU seconds of this process or its ended children."""
    ru = resource.getrusage(who)
    return ru.ru_utime + ru.ru_stime


def host_to_device_bytes_per_s(device: torch.device) -> float:
    """Host-to-device copy rate of a (1024, 2, 800) float32 batch from
    pageable memory, each copy synchronised."""
    probe = torch.from_numpy(np.random.RandomState(0).randn(
        1024, 2, 800).astype(np.float32))
    probe.to(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(3):
        probe.to(device)
        torch.cuda.synchronize(device)
    return probe.nbytes * 3 / (time.perf_counter() - t0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", default="1024,4096",
                    help="comma list of concurrent-stream counts")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--engine_path", default="fast")
    ap.add_argument("--attend_impl", default="kernel")
    ap.add_argument("--slots", default="staged")
    ap.add_argument("--mode", default="vap")
    ap.add_argument("--hz", type=int, default=20)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--int16", action="store_true", default=True,
                    help="int16 wire format (4x lower socket bandwidth)")
    ap.add_argument("--f64-wire", dest="int16", action="store_false")
    add_quant_arg(ap)
    ap.add_argument("--stub_device", action="store_true",
                    help="replace the arena with an instant host stub: "
                         "the host leg of the serving tick alone, no CUDA")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def serve_run(arena, n: int, args, loadgen: str) -> dict:
    """One load-generator run of n streams against a NativeVapServer
    over `arena`; returns the generator's report with the server's."""
    from vap_realtime_tpu_torch.config import FRAME_CONTEXT_PADDING
    from vap_realtime_tpu_torch.runtime.arena import FRESH_PATHS
    from vap_realtime_tpu_torch.runtime.server_native import NativeVapServer
    from vap_realtime_tpu_torch.utils import spans

    overlap = (0 if args.engine_path in FRESH_PATHS
               else FRAME_CONTEXT_PADDING)
    server = NativeVapServer(arena, mode=args.mode, port=0,
                             wire_int16=args.int16)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    cpu0 = [_cpu_s(who) for who in _RUSAGE]
    t0 = time.perf_counter()
    recording = spans.enabled()
    spans.enable(True)
    th.start()
    try:
        cmd = [loadgen, "--port", str(server.port), "--streams", str(n),
               "--seconds", str(args.seconds), "--hz", str(args.hz),
               "--overlap", str(overlap), "--ramp_ms", str(RAMP_MS)]
        if args.int16:
            cmd.append("--int16")
        print(f"[serving_bench] {n} streams ...", file=sys.stderr,
              flush=True)
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=args.seconds + 60)
        if r.returncode != 0 or not r.stdout.strip():
            raise RuntimeError(f"vaploadgen exit {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        run = json.loads(r.stdout.strip().splitlines()[-1])
        run["result_ticks_dropped"] = server.ingest.send_dropped()
    finally:
        server.stop()
        th.join(timeout=10)
        spans.enable(recording)
        records = spans.take()
    # CPU seconds over the run's wall seconds: this process (the server's
    # threads) and the load generator, which share the host's cores
    cpu1 = [_cpu_s(who) for who in _RUSAGE]
    run["cpu_s"] = {"wall": round(time.perf_counter() - t0, 2),
                    "server": round(cpu1[0] - cpu0[0], 2),
                    "loadgen": round(cpu1[1] - cpu0[1], 2)}
    run["realtime"] = run["results_per_sec"] >= 0.97 * n * args.hz
    # ticks that dispatched streams; each part's host ms over them
    ticks = sum(1 for r in records
                if r.name == "vap.serve.dispatch" and r.n)
    if ticks:
        ms = spans.self_times(records)
        run["server_ms_per_tick"] = {
            k: round(ms.get(f"vap.serve.{k}", {"ms": 0.0})["ms"] / ticks, 3)
            for k in ("dispatch", "fetch", "send")}
        run["ticks"] = ticks
    return run


def main(argv=None) -> dict:
    args = parse_args(argv)
    from vap_realtime_tpu_torch.config import VapConfig
    from vap_realtime_tpu_torch.runtime.arena import (
        StreamArena, resolve_device,
    )
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    device = None if args.stub_device else resolve_device(args.device)
    loadgen = build_loadgen()
    stream_counts = [int(s) for s in args.streams.split(",")]
    cfg = VapConfig(frame_hz=args.hz, context_len_sec=2.5, mode=args.mode)
    wire_dtype = np.int16 if args.int16 else np.float32

    config = {
        "engine_path": args.engine_path, "attend_impl": args.attend_impl,
        "slots": args.slots, "mode": args.mode, "hz": args.hz,
        "bf16": args.bf16, "wire": "int16" if args.int16 else "float64",
        "quant_cache": args.quant_cache, "capacity": max(stream_counts),
        "seconds": args.seconds, "stub_device": args.stub_device,
        "device": "stub" if device is None else str(device),
        "cpu_count": os.cpu_count()}
    if device is not None and device.type == "cuda":
        from vap_realtime_tpu_torch.profile_step import gpu_line

        config["card"] = gpu_line()
        config["host_to_device_MBps"] = round(
            host_to_device_bytes_per_s(device) / 1e6, 1)
    report = {"config": config, "runs": []}

    params = None if device is None else synthetic_params(cfg.frame_hz,
                                                          mode=args.mode)
    for n in stream_counts:
        # capacity == n: every tick moves exactly n streams' bytes
        if device is None:
            arena = StubArena(cfg, n, args.engine_path, wire_dtype)
        else:
            arena = StreamArena(cfg, params, capacity=n,
                                path=args.engine_path,
                                dtype=(torch.bfloat16 if args.bf16
                                       else torch.float32),
                                attend_impl=args.attend_impl,
                                slots=args.slots,
                                quant_cache=args.quant_cache,
                                wire_dtype=wire_dtype, device=device)
        t0 = time.time()
        arena.warmup()
        print(f"[serving_bench] capacity {n} warm in {time.time() - t0:.1f} "
              f"s", file=sys.stderr, flush=True)
        run = serve_run(arena, n, args, loadgen)
        report["runs"].append(run)
        print(json.dumps(run), flush=True)
        del arena
        time.sleep(2.0)              # let the sockets drain between runs

    ok = [r for r in report["runs"]
          if r["realtime"]
          and 0 < r["latency_ms"]["p99"] < 2 * 1000.0 / args.hz]
    report["sustained_streams"] = max((r["streams"] for r in ok), default=0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[serving_bench] wrote {args.out}", file=sys.stderr)
    print(json.dumps({"sustained_streams": report["sustained_streams"]}),
          flush=True)
    return report


if __name__ == "__main__":
    main()
