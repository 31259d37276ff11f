"""Serving-capacity probe: does a StreamArena of B streams fit and run?

Port of `tools/capacity_probe.py`.  Builds the real arena at --batch
streams (state, params and the step's transient memory on the device),
warms it (an all-frozen tick and, on staged slots, the merge tick), then
times all-active ticks on a chunk batch already on the device, with
`torch.cuda.synchronize()` around each tick.  The port's steps update
their state in place, so no tick holds a second copy of the cache (the
JAX tool relied on donating the state into each step for that).

One batch per process: a probe that runs out of device memory prints
`"ok": false` with the error, which is the probe's answer (the batch does
not fit), and exits 0.

Reports ms per step (the median tick), the streams that step could serve
in real time at --hz (batch / (ms per step * hz / 1000)), the peak
device memory allocated, and the card's name and power limit.

Run (on the card; --device cpu for a tiny CPU run):
    python -m vap_realtime_tpu_torch.tools.capacity_probe --batch 16384 \
        --q8g --conv_chunks 4 [--out probe.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(args) -> dict:
    from vap_realtime_tpu_torch.config import VapConfig
    from vap_realtime_tpu_torch.runtime.arena import (
        StreamArena, resolve_device,
    )
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    device = resolve_device(args.device)
    cfg = VapConfig(frame_hz=args.hz, context_len_sec=2.5)
    quant = "global" if args.q8g else args.q8
    res = {"batch": args.batch, "path": args.path, "slots": args.slots,
           "attend_impl": args.attend_impl, "quant_cache": quant,
           "conv_chunks": args.conv_chunks, "hz": args.hz,
           "device": str(device)}
    if device.type == "cuda":
        from vap_realtime_tpu_torch.profile_step import gpu_line

        res["card"] = gpu_line()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    try:
        arena = StreamArena(cfg, synthetic_params(cfg.frame_hz),
                            capacity=args.batch, path=args.path,
                            dtype=torch.bfloat16, slots=args.slots,
                            attend_impl=args.attend_impl, quant_cache=quant,
                            wire_dtype=np.int16,
                            conv_chunks=args.conv_chunks, device=device)
        arena.warmup()
        sync(device)
        res["warmup_s"] = round(time.time() - t0, 1)
        chunk = torch.zeros((args.batch, 2, arena.chunk_samples),
                            dtype=torch.int16, device=device)
        act = torch.ones((args.batch,), dtype=torch.bool, device=device)

        def tick() -> float:
            sync(device)
            t = time.perf_counter()
            arena.step_tensors(chunk, act)
            sync(device)
            return time.perf_counter() - t

        for _ in range(4):                    # warm the call path
            tick()
        times = sorted(tick() * 1e3 for _ in range(args.ticks))
    except torch.cuda.OutOfMemoryError as e:
        res.update(ok=False, error=f"{type(e).__name__}: {str(e)[:400]}")
        return res
    ms = times[len(times) // 2]
    res.update(ok=True, ms_per_step=round(ms, 3),
               streams_if_realtime=int(args.batch / (ms * args.hz / 1e3)))
    if device.type == "cuda":
        res["max_memory_allocated_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 1024**3, 2)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--path", default="fast")
    ap.add_argument("--slots", default="staged")
    ap.add_argument("--attend_impl", default="kernel")
    ap.add_argument("--q8", action="store_true",
                    help="int8 cache with per-row scales")
    ap.add_argument("--q8g", action="store_true",
                    help="int8 cache with frozen per-stream scales "
                         "(quant='global')")
    ap.add_argument("--conv_chunks", type=int, default=1,
                    help="run the encoder over k sequential sub-batches "
                         "(smaller transient memory; identical numerics)")
    ap.add_argument("--hz", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = probe(args)
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
