"""Where a serving step's time goes on the card.

    python -m vap_realtime_tpu_torch.profile_step [--batch 4096] [--steps 16]
        [--engine_path fast|kv|full|hybrid|fast_hybrid]
        [--quant_cache row|global] [--conv_impl conv|normk|fused|blocked]
        [--attend_impl kernel|kernel3 --slots staged|stream|global]

Full-width model (vap, 20 Hz, 2.5 s context, synthetic weights), bf16,
all streams active.  --engine_path: "fast" (the default; the streaming
encoder over fresh samples + the KV step), "kv" (the chunked encoder
over overlapped frames + the KV step), "full" (the chunked encoder +
the full-recompute trunk over the 50-frame buffer, no attend kernel), or
"hybrid" / "fast_hybrid" (kv / fast with a full-trunk resync: their
incremental tick and their resync tick are timed apart, with the mean
over a cadence of resync_every = context_frames ticks).
The KV steps use staged slots and the kernel attend unless asked
otherwise (`--attend_impl kernel3 --slots stream`: the compact attend
kernel); the cache is bf16 or, with --quant_cache, int8 (per-row or
frozen per-stream scales); the fast step's encoder runs its ChannelNorm
as PyTorch ops (conv) or through the one-pass kernel (normk), or the
whole conv stack in one kernel (fused).  Prints, each beside the card's
name and power limit:

- ms/step of the whole step (host clock around synchronized steps), of
  the encoder alone (CUDA events) and of the 7 attend launches of a KV
  step (CUDA events); the trunk is the rest;
- the top CUDA kernels by device time over the steps (torch.profiler),
  and the device's busy share of that window (the union of the kernels'
  intervals over the wall time: kernels that overlap count once);
- each layer span's host self ms a step (`utils/spans.py`: the span's
  host time less its child spans'), over as many steps again with the
  span recorder on and the profiler off.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.encoder import (
    CONV_IMPLS, encode_chunk, encode_chunk_streaming,
)
from vap_realtime_tpu_torch.runtime import incremental as inc
from vap_realtime_tpu_torch.runtime.arena import (
    FRESH_PATHS, HYBRID_PATHS, init_path_state, path_step,
)
from vap_realtime_tpu_torch.runtime.cli import add_quant_arg
from vap_realtime_tpu_torch.utils import spans
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call of `fn` on the card (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--engine_path", default="fast",
                    choices=["fast", "kv", "full", "hybrid", "fast_hybrid"])
    add_quant_arg(ap)
    ap.add_argument("--conv_impl", choices=list(CONV_IMPLS), default="conv")
    ap.add_argument("--attend_impl", choices=["kernel", "kernel3"],
                    default="kernel")
    ap.add_argument("--slots", choices=list(inc.SLOTS), default="staged")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    B, n, dt = args.batch, args.steps, torch.bfloat16
    path = args.engine_path
    quant, conv_impl = args.quant_cache, args.conv_impl
    slots, attend_impl = args.slots, args.attend_impl
    staged = slots == "staged"
    impl = "compact" if attend_impl == "kernel3" else "bcast"
    gpu = gpu_line()
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    p = params_to_torch(synthetic_params(cfg.frame_hz), "cuda", dt)
    g = torch.Generator(device="cuda").manual_seed(0)
    chunk = cfg.frame_shift if path in FRESH_PATHS else cfg.frame_samples
    frames = (0.1 * torch.randn(8, B, 2, chunk, generator=g,
                                device="cuda")).to(dt)
    st = init_path_state(path, cfg, B, dt, "cuda", staged=staged,
                         quant=quant, conv_impl=conv_impl)

    def step(i, resync_mode="never"):
        nonlocal st
        st, out = path_step(path, p, st, frames[i % 8], cfg, slots=slots,
                            attend_impl=attend_impl, conv_impl=conv_impl,
                            resync_mode=resync_mode)
        return out

    def tick_ms(resync_mode, reps):
        """ms per tick (host clock around synchronized ticks)."""
        torch.cuda.synchronize()
        t = time.time()
        for i in range(reps):
            step(i, resync_mode)
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3 / reps

    for i in range(4):
        step(i)
    step_ms = tick_ms("never", n)
    if path in HYBRID_PATHS:
        # the resync tick apart (warmed once), and the mean over one
        # cadence of R ticks
        step(0, "force")
        resync_ms = tick_ms("force", max(2, n // 4))
        R = cfg.context_frames
        mean_ms = ((R - 1) * step_ms + resync_ms) / R
        period = 1e3 / cfg.frame_hz
        print(f"[profile] B={B} bf16 {path} ticks: incremental "
              f"{step_ms:.3f} ms, resync {resync_ms:.3f} ms, mean over "
              f"resync_every={R} {mean_ms:.3f} ms -> {B * period / mean_ms:.0f}"
              f" realtime streams per card at {cfg.frame_hz} Hz amortised, "
              f"{B * period / resync_ms:.0f} if every tick must fit the "
              f"{period:.0f} ms period; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {gpu}",
              flush=True)

    h0 = torch.zeros(2 * B, cfg.dim, device="cuda", dtype=dt)
    if path in FRESH_PATHS:
        conv = inc.init_fast_state(cfg, B, dt, device="cuda",
                                   conv_impl=conv_impl).conv
        enc_ms = cuda_ms(lambda: encode_chunk_streaming(
            p["encoder"], frames[0].reshape(2 * B, -1), conv, h0, h0,
            cfg.downsample_kernel, conv_impl), n)
    else:
        enc_ms = cuda_ms(lambda: encode_chunk(
            p["encoder"], frames[0].reshape(2 * B, -1), h0, h0,
            cfg.downsample_kernel), n)
    what = ("full recompute" if path == "full" else
            f"cache {f'int8 {quant}' if quant else 'bf16'}, "
            f"{conv_impl if path in FRESH_PATHS else 'chunked encoder'}, "
            f"{attend_impl}")
    name = "full" if path == "full" else f"{path} {slots}"
    if path in HYBRID_PATHS:
        name += " incremental tick"
    if path == "full":
        print(f"[profile] B={B} bf16 {name} step ({what}): {step_ms:.3f} "
              f"ms/step; encoder {enc_ms:.3f} ms; trunk and heads "
              f"{step_ms - enc_ms:.3f} ms | {gpu}", flush=True)
    else:
        att_ms = attend_ms(getattr(st, "kv", st), cfg, B, dt, staged, impl,
                           g, n)
        print(f"[profile] B={B} bf16 {name} step ({what}): "
              f"{step_ms:.3f} ms/step; encoder {enc_ms:.3f} ms; 7 attend "
              f"launches {att_ms:.3f} ms; trunk rest "
              f"{step_ms - enc_ms - att_ms:.3f} ms | {gpu}", flush=True)
    device_profile(step, n, gpu)


def attend_ms(kv, cfg, B, dt, staged, impl, g, n) -> float:
    """ms of the 7 attend launches of one KV step over the state's
    cache (CUDA events)."""
    T = cfg.context_frames
    q2 = torch.randn(B, 2, cfg.dim, device="cuda", generator=g).to(dt)
    age = torch.randint(1, T, (B, T), device="cuda", generator=g).float()
    sage = torch.randint(1, T, (inc.STAGE_S, B), device="cuda",
                         generator=g).float()
    row = kv.quant == "row"
    return cuda_ms(lambda: [inc.attend_pair(
        kv.cache, q2, q2, q2, age, kv.stage if staged else None,
        sage if staged else None, scale=kv.scale[:, ph] if row else None,
        stage_scale=kv.stage_scale[:, :, ph] if row and staged else None,
        pair_base=2 * ph, num_heads=cfg.num_heads, impl=impl)
        for ph in range(7)], n)


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_profile(step, n: int, gpu: str) -> None:
    """torch.profiler over n steps: the device's busy share of the wall
    time (the union of the kernels' intervals, inside the synchronised
    window) and the top CUDA kernels by device time; then n steps with
    the span recorder on: each span's host self ms a step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.time()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.time() - t) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    busy_us = union_length(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == cuda
        and not getattr(e, "is_user_annotation", False))
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {n} steps in {wall_us / 1e3:.3f} ms wall; device "
          f"busy {busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f}% "
          f"(summed kernel time {dev_us / 1e3:.3f} ms) | {gpu}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile]   {e.self_device_time_total / n / 1e3:8.3f} "
              f"ms/step  x{e.count // n:<4d} {e.key[:90]}", flush=True)
    spans.take()
    spans.enable(True)
    try:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    finally:
        spans.enable(False)
    table = spans.self_times(spans.take())
    for name, d in sorted(table.items(), key=lambda kv: -kv[1]["self_ms"]):
        print(f"[profile]   span {name:<12s} x{d['count'] / n:<4g} host self "
              f"{d['self_ms'] / n:8.3f} ms/step (with children "
              f"{d['ms'] / n:.3f})", flush=True)


if __name__ == "__main__":
    main()
