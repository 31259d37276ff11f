"""Drive the PyTorch/CUDA port of VAP on one NVIDIA card (H100) and check it.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

  build  nvcc builds every kernel under vap_realtime_tpu_torch/csrc/ (one
         process per source, all started together) while g++ builds the
         native ingest engine.
  (a)    Each kernel against its plain PyTorch version on the card at the
         serving shapes:
         - attend_pair, float caches (K1 ring-only, K2 staged): B=4096
           streams and the server run's 64, T=50, S=8, all 7 phases,
           float32 at atol 1e-4 (TF32 off), bfloat16 at atol/rtol 2e-2
           (the plain version rounds (k - kc) * q and w * v to bf16, the
           kernel keeps them in float32), a mixed live/DEAD case and an
           all-DEAD case (output == v_cur);
         - attend_pair on int8 codes (K3: the frozen scales folded into
           q / k_cur / v_cur as the step does, compared in float units;
           K4: per-row scales > 0 on the ring and the stage), bf16 q, the
           same shapes, cases and tolerance;
         - channel_norm_relu (K6) at every conv layer's serving shape
           (8192, 256, T), T = 160, 40, 20, 10, 5: float32 at atol 1e-5;
           bf16 within one bf16 rounding step at each of its three
           rounding points, |d| <= 2^-6 |w y| + 2^-7 |out| + 1e-6 (y the
           float32 normalised value);
         - conv_stack_fused (K7) on 8192 channel-streams x 800 samples,
           three frames, each carrying its own state: float32 at atol 1e-4
           (TF32 off); bf16 within four bf16 steps, |d| <= 2^-6 (1 +
           |plain|) (both accumulate in float32 in other orders, and a
           value moved across a rounding boundary travels on through the
           later layers); the new carries too (c0 bit-equal);
         - the compact attend (K10) at B=4096 and 64, all 7 phases, ring
           rows: float32 (atol 1e-4), bf16, int8 with row scales and
           int8 codes under the frozen-scale fold (atol/rtol 2e-2 in float
           units), mixed live/DEAD and all-DEAD (output == v_cur);
         - lstm_scan (K5) at (8192, 5, 256): float32 at atol 1e-5, bf16
           outputs within one bf16 step (rtol 2^-7, atol 1e-5);
         - fused_attend (K8, one k/v slot pair) at B=4096 and 64, T=50,
           all 14 slot pairs, float32 (atol 1e-4) and bf16 (atol/rtol
           2e-2), mixed live/DEAD and all-DEAD (output == v_cur), against
           its v4 plain form and the einsum reference; an int8 cache
           raises;
         - cpc_conv_tail (K9) at 8192 channel-streams x L0 = 224 (20 Hz),
           float32 (atol 1e-4, TF32 off) and bf16 x0 (one bf16 step of the
           output, |d| <= 2^-7 (1 + |plain|)), and 64 x L0 = 384 and 128;
         - attend_lab (K11) in every ablated mode at 1 and 2 streams per
           block, B=4096 and 64, T=50: float32 caches at atol = rtol 1e-4,
           bf16 caches and int8 codes (dma, q8glb) with bf16 q at 2e-2
           (bf16exp at 2e-2 in any dtype: it rounds to bf16 by design);
         - cache_read (K12) over the whole cache at B=4096 and 64, float32
           / bf16 / int8: |d| <= 1e-5 x the column's sum |x|, and two
           launches bit-equal (no atomics).
  (b)    The full-width fast step (vap, 20 Hz, 2.5 s context, synthetic
         weights) in six configurations: staged slots with the bf16
         cache, the int8 cache with frozen scales (quant="global") and
         with row scales (quant="row"), conv_impl="normk" and
         conv_impl="fused"; and "compact": slots="stream" with
         attend_impl="kernel3".  Each on a small input in float32 on the
         card equals the CPU path (which the CPU tests hold against the
         JAX package) at atol 1e-4; each at B=4096 bf16 over 17 frames
         with the kernels equals the same step with the plain versions
         (p_now atol 2e-2), and the launch counters rise by exactly 7
         attend launches per step (K1-K4, or K10 for compact), 5
         channel_norm_relu launches per normk step and 1 conv_stack_fused
         launch per fused step.
         The slice-4 paths at full width: the kv step (chunked encoder,
         staged slots, the attend kernel: 7 K2 launches per step) and the
         full-recompute step, each in float32 on a small input equal to
         the CPU path (atol 1e-4); at B=4096 bf16 the kv step with the
         kernels equals the plain attend (p_now atol 2e-2) and the full
         step gives finite probabilities; and run_frames over the 20 Hz
         stream golden (tests/golden/stream_vap_20hz.npz) in float32 on the
         card, within 1e-4 of the original reference's outputs.
         The slice-5 hybrid paths (hybrid_step, fast_hybrid_step; staged
         slots, K2, resync every 6 ticks): float32 card vs CPU path (atol
         1e-4), resync frames on the card vs the full-trunk oracles (the
         full recompute; fast_hybrid at resync_every=1) at 2e-5, and at
         B=4096 bf16 kernels vs plain (p_now atol 2e-2) with 7 K2 launches
         per incremental tick and none on a resync tick.
  (d)    Times with CUDA events after warm-up, each beside the card's name
         and power limit: each kernel body's ms per launch and its bound,
         its plain version, one PyTorch call over the same problem as a
         yardstick where one exists (scaled_dot_product_attention on the
         dequantised bf16 rows, torch.nn.LSTM on cuDNN; the port never
         calls them; K7 has none, so the `conv` and `normk` stacks' times
         stand beside it; K8 against scaled_dot_product_attention; K9 against
         the cuDNN conv1-4 + ChannelNorm tail of cpc_conv_stack), and the
         ms/step at B=4096 of the fast step in six configurations and of
         the kv and full steps; the hybrid paths' incremental and resync
         ticks at B=4096; and the lab tools (the slice-5 path): the attend
         lab (vap_realtime_tpu_torch.tools.attend_lab) over every ablated
         mode at 1 and 2 streams per block and the production variants,
         and the component bench over every stage, with the launch
         counters zeroed just before and read just after; K11's and K12's
         ms per launch beside their bounds, plain versions and (K12)
         torch.sum.
  (c)    The main paths through their user entry points: the native server
         (capacity 64, bf16, int16 wire) answers 8 loopback connections
         streaming 1 s of synthetic audio each (>= 15 results on each),
         five times: the bf16 cache; StreamArena(quant_cache="global",
         conv_impl="normk"); StreamArena(conv_impl="fused",
         slots="stream", attend_impl="kernel3"); and
         StreamArena(path="kv") (overlapped frames, 7 K2 launches per
         tick); and StreamArena(path="fast_hybrid", resync_every=6), with
         resync ticks inside the run (counted; 7 K2 launches per
         incremental tick).  The launch counters are zeroed just before
         each run and read just after.  Then VapEngine(path="fast",
         conv_impl="fused"), VapEngine(path="full") and
         VapEngine(path="fast_hybrid") take a few process_batch calls on the
         card, and run_offline(path="full" and "hybrid") on synthetic audio
         equals the CPU.

The last lines: the card's name and power limit, one JSON line listing
each kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import socket
import sys
import threading
import time

import numpy as np
import torch

B, T, S, P, D, H = 4096, 50, 8, 7, 256, 4
C, NORM_T = 256, (160, 40, 20, 10, 5)   # conv output channels and lengths
L0_TAIL = 224                      # chunked conv0 output rows at 20 Hz (K9)
SERVER_CAPACITY = 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
BF16_TOL = 2e-2                    # attend, bf16: atol and rtol
CODE_SCALE = 3.0 / 127             # int8 scale of rows with max-abs ~3
L_NEW = 800                        # fresh samples per frame at 20 Hz
# the step's configurations: quant / conv_impl for init_fast_state and
# fast_step; slots (default "staged") and attend_impl (default "kernel")
CONFIGS = {"bf16": {}, "q8g": dict(quant="global"), "q8": dict(quant="row"),
           "normk": dict(conv_impl="normk"), "fused": dict(conv_impl="fused"),
           "compact": dict(slots="stream", attend_impl="kernel3")}
STEP_CONFIGS = tuple(CONFIGS)      # phases (b) and (d)
HYBRID_R = 6                       # resync cadence of the hybrid checks
# the server runs' arenas (phase (c)) add two combinations
CONFIGS.update(q8g_normk=dict(quant="global", conv_impl="normk"),
               fused_compact=dict(conv_impl="fused", slots="stream",
                                  attend_impl="kernel3"),
               kv=dict(path="kv"),
               fast_hybrid=dict(path="fast_hybrid", resync_every=HYBRID_R))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def kernel_device_ms(fn, name: str, reps: int) -> float:
    """Mean device time per call of `fn` spent in the CUDA kernels whose
    name contains `name` (torch.profiler), without the host's wrapper
    time between launches."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.key)
    check(us > 0, f"the profiler saw no {name} kernel")
    return us / 1e3 / reps


def bound(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S):
    """The least time on the card: (ms, "bytes" or "operations")."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def config_kw(config: str, plain: bool = False):
    """(init_fast_state keywords, fast_step keywords) of a configuration;
    plain=True swaps the kernels for their plain versions: the attend's
    ("plain" / "plain3"), the conv path's ChannelNorm + ReLU for normk
    (channel_norm_relu_plain's ops), and, for fused, the plain stack
    (through `plain_fused`)."""
    kw = CONFIGS[config]
    slots = kw.get("slots", "staged")
    conv = kw.get("conv_impl", "conv")
    impl = kw.get("attend_impl", "kernel")
    if plain:
        impl = {"kernel": "plain", "kernel3": "plain3"}[impl]
        conv = "conv" if conv == "normk" else conv
    return (dict(staged=slots == "staged", quant=kw.get("quant", False),
                 conv_impl=conv),
            dict(slots=slots, attend_impl=impl, conv_impl=conv))


@contextlib.contextmanager
def plain_fused(on: bool = True):
    """While on, conv_impl="fused" runs conv_stack_fused_plain instead of
    the kernel (the comparisons on the card only; the port has no such
    switch)."""
    from vap_realtime_tpu_torch.ops.cuda import encoder as enc

    kernel = enc.conv_stack_fused
    if on:
        enc.conv_stack_fused = enc.conv_stack_fused_plain
    try:
        yield
    finally:
        enc.conv_stack_fused = kernel


def _counters():
    """{key: (wrapper, counter attribute)} of every kernel."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, fused_attend,
    )
    from vap_realtime_tpu_torch.ops.cuda.attend_lab import attend_lab
    from vap_realtime_tpu_torch.ops.cuda.channorm import channel_norm_relu
    from vap_realtime_tpu_torch.ops.cuda.cpc_conv import cpc_conv_tail
    from vap_realtime_tpu_torch.ops.cuda.encoder import conv_stack_fused
    from vap_realtime_tpu_torch.ops.cuda.lab import cache_read_all
    from vap_realtime_tpu_torch.ops.cuda.lstm import lstm_scan

    return {"attend": (attend_pair, "launches"),
            "compact": (attend_pair, "compact_launches"),
            "norm": (channel_norm_relu, "launches"),
            "fused": (conv_stack_fused, "launches"),
            "lstm": (lstm_scan, "launches"),
            "single": (fused_attend, "launches"),
            "tail": (cpc_conv_tail, "launches"),
            "lab": (attend_lab, "launches"),
            "read": (cache_read_all, "launches")}


def zero_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def counts() -> dict:
    """Every kernel's launch counter."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def per_step(config: str) -> dict:
    """Kernel launches one step of a configuration makes (fast steps, the
    kv step of "kv", the incremental tick of "fast_hybrid"; K5, K8, K9,
    K11 and K12 are off every serving path)."""
    kw = CONFIGS[config]
    compact = kw.get("attend_impl") == "kernel3"
    conv = kw.get("conv_impl", "conv")
    return {"attend": 0 if compact else 7, "compact": 7 if compact else 0,
            "norm": 5 if conv == "normk" else 0,
            "fused": 1 if conv == "fused" else 0, "lstm": 0, "single": 0,
            "tail": 0, "lab": 0, "read": 0}


def build() -> None:
    """nvcc for every kernel source and g++ for the ingest engine, all
    started together."""
    from vap_realtime_tpu_torch.io.native_ingest import build_lib
    from vap_realtime_tpu_torch.ops.cuda.build import build_all

    t = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(build_lib)
        reports = build_all()
        gxx.result()
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(regs), flush=True)
    print(f"[build] kernels + native ingest built in {time.time() - t:.1f} s",
          flush=True)


def _ages(g, case: str, nb: int):
    """Ring (nb, T) and stage (S, nb) ages: live in [1, T+S), about a
    third DEAD ("mixed") or all DEAD ("dead")."""
    from vap_realtime_tpu_torch.ops.cuda.attend import DEAD

    dev = "cuda"
    age = torch.randint(1, T + S, (nb, T), generator=g, device=dev).float()
    sage = torch.randint(1, T + S, (S, nb), generator=g, device=dev).float()
    if case == "dead":
        age.fill_(DEAD)
        sage.fill_(DEAD)
    else:
        age[torch.rand(nb, T, generator=g, device=dev) < 0.35] = DEAD
        sage[torch.rand(S, nb, generator=g, device=dev) < 0.35] = DEAD
    return age, sage


def attend_inputs(dtype, case: str, seed: int, nb: int = B):
    """Serving-shaped float attend inputs for nb streams, made on the card
    from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    cache, stage = rn(nb, P, T, 4 * D), rn(S, nb, P * 4 * D)
    q2, kc2, vc2 = rn(nb, 2, D), rn(nb, 2, D), rn(nb, 2, D)
    return (cache, q2, kc2, vc2, *_ages(g, case, nb), stage)


def attend_inputs_int8(case: str, seed: int, nb: int = B):
    """Serving-shaped int8 attend inputs made on the card from a seed:
    int8 codes, bf16 q / k_cur / v_cur in float units, row scales
    CODE_SCALE x [0.5, 1.5) of the ring (nb, P, T) and the stage
    (S, nb, P)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    codes = lambda *s: torch.randint(-127, 128, s, generator=g,
                                     device=dev).to(torch.int8)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    cache, stage = codes(nb, P, T, 4 * D), codes(S, nb, P * 4 * D)
    q2, kc2, vc2 = rn(nb, 2, D), rn(nb, 2, D), rn(nb, 2, D)
    sc = CODE_SCALE * (0.5 + torch.rand(nb, P, T, generator=g, device=dev))
    ssc = CODE_SCALE * (0.5 + torch.rand(S, nb, P, generator=g, device=dev))
    age, sage = _ages(g, case, nb)
    return cache, q2, kc2, vc2, age, sage, stage, sc, ssc


def fold_global(q2, kc2, vc2):
    """The quant="global" fold of `_kv_core` with one frozen scale
    CODE_SCALE for k and v: q * c_k, k_cur / c_k, v_cur / c_v; the
    kernel's output times c_v is in float units."""
    f = lambda x, c: (x.float() * c).to(x.dtype).contiguous()
    return f(q2, CODE_SCALE), f(kc2, 1 / CODE_SCALE), f(vc2, 1 / CODE_SCALE)


def _compare(got, want, unit: float, what: str) -> float:
    """bf16 kernel vs plain at atol/rtol BF16_TOL in float units (output
    x unit); returns max |d|."""
    torch.cuda.synchronize()
    g, w = got.float() * unit, want.float() * unit
    d = (g - w).abs()
    check(torch.isfinite(got).all().item(), f"non-finite output ({what})")
    check(not (d > BF16_TOL + BF16_TOL * w.abs()).any().item(),
          f"kernel vs plain {what}: max |d| {d.max().item():.3e}")
    return d.max().item()


def phase_a() -> float:
    """Float-cache attend (K1, K2) vs plain at the serving shapes (B=4096,
    and the server run's capacity); returns the max abs error of the
    bf16 staged body (the bf16 main path's)."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )

    worst_main = 0.0
    for dtype, atol, rtol in ((torch.float32, 1e-4, 0.0),
                              (torch.bfloat16, BF16_TOL, BF16_TOL)):
        for nb, case in ((B, "mixed"), (B, "dead"),
                         (SERVER_CAPACITY, "mixed")):
            cache, q2, kc2, vc2, age, sage, stage = attend_inputs(
                dtype, case, seed=1 if case == "mixed" else 2, nb=nb)
            for staged in (True, False):
                st = (stage, sage) if staged else (None, None)
                err = 0.0
                for ph in range(P):
                    kw = dict(pair_base=2 * ph, num_heads=H)
                    got = attend_pair(cache, q2, kc2, vc2, age, *st, **kw)
                    want = attend_pair_plain(cache, q2, kc2, vc2, age, *st,
                                             **kw)
                    torch.cuda.synchronize()
                    d = (got.float() - want.float()).abs()
                    bad = d > atol + rtol * want.float().abs()
                    check(torch.isfinite(got).all().item(),
                          f"non-finite kernel output ({dtype}, {case})")
                    check(not bad.any().item(),
                          f"kernel vs plain {dtype} {case} staged={staged} "
                          f"phase {ph}: max |d| {d.max().item():.3e}")
                    if case == "dead":
                        check(torch.equal(got, vc2),
                              "all-DEAD rows: output must equal v_cur")
                    err = max(err, d.max().item())
                print(f"[a] attend_pair {str(dtype)[6:]} B={nb} {case:5s} "
                      f"{'staged' if staged else 'ring  '} 7 phases: "
                      f"max |kernel - plain| {err:.3e} (atol {atol:g}, "
                      f"rtol {rtol:g})", flush=True)
                if dtype == torch.bfloat16 and staged:
                    worst_main = max(worst_main, err)
            del cache, stage
    torch.cuda.empty_cache()
    return worst_main


def phase_a_int8() -> float:
    """int8-cache attend (K3 frozen-scale fold, K4 row scales) vs plain
    at the serving shapes; returns the max abs error of their staged
    bodies (float units)."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )

    worst = 0.0
    for nb, case in ((B, "mixed"), (B, "dead"), (SERVER_CAPACITY, "mixed")):
        cache, q2, kc2, vc2, age, sage, stage, sc, ssc = attend_inputs_int8(
            case, seed=3 if case == "mixed" else 4, nb=nb)
        folded = fold_global(q2, kc2, vc2)
        for body in ("K3", "K4"):
            for staged in (True, False):
                st = (stage, sage) if staged else (None, None)
                err = 0.0
                for ph in range(P):
                    kw = dict(pair_base=2 * ph, num_heads=H)
                    if body == "K3":
                        args, unit = (cache, *folded, age, *st), CODE_SCALE
                    else:
                        args, unit = (cache, q2, kc2, vc2, age, *st), 1.0
                        kw.update(scale=sc[:, ph], stage_scale=(
                            ssc[:, :, ph] if staged else None))
                    got = attend_pair(*args, **kw)
                    want = attend_pair_plain(*args, **kw)
                    err = max(err, _compare(
                        got, want, unit, f"{body} B={nb} {case} "
                        f"staged={staged} phase {ph}"))
                    if case == "dead":
                        check(torch.equal(got, args[3]),
                              f"{body} all-DEAD rows: output must equal "
                              f"v_cur")
                print(f"[a] attend_pair int8 {body} bf16 B={nb} {case:5s} "
                      f"{'staged' if staged else 'ring  '} 7 phases: "
                      f"max |kernel - plain| {err:.3e} (float units; atol "
                      f"{BF16_TOL:g}, rtol {BF16_TOL:g})", flush=True)
                if staged:
                    worst = max(worst, err)
        del cache, stage
    torch.cuda.empty_cache()
    return worst


def norm_inputs(seed: int, Tn: int):
    """A conv output of the serving shape (2B, C, Tn) with per-channel
    offsets, and a (C, 1) affine, made on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = rn(2 * B, C, Tn) * 2 + rn(1, C, 1)
    return x, 1 + 0.3 * rn(C, 1), 0.2 * rn(C, 1)


def phase_a_norm() -> float:
    """channel_norm_relu (K6) vs plain at every layer's serving shape;
    returns the max abs error in bf16."""
    from vap_realtime_tpu_torch.ops.basic import channel_norm
    from vap_realtime_tpu_torch.ops.cuda.channorm import (
        channel_norm_relu, channel_norm_relu_plain,
    )

    worst = 0.0
    for Tn in NORM_T:
        x32, w, b = norm_inputs(5, Tn)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got = channel_norm_relu(x, w, b)
            want = channel_norm_relu_plain(x, w, b).float()
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == x.shape
                  and torch.isfinite(got).all().item(),
                  f"channel_norm_relu output {dtype} T={Tn}")
            d = (got.float() - want).abs()
            if dtype == torch.float32:
                tol = 1e-5
            else:
                y = channel_norm(x.float(), torch.ones_like(w),
                                 torch.zeros_like(b))
                tol = 2 ** -6 * (w.abs() * y.abs()) + 2 ** -7 * want.abs() \
                    + 1e-6
                worst = max(worst, d.max().item())
                del y
            check(bool((d <= tol).all()),
                  f"channel_norm_relu vs plain {dtype} T={Tn}: max |d| "
                  f"{d.max().item():.3e}")
            print(f"[a] channel_norm_relu {str(dtype)[6:]} "
                  f"({2 * B}, {C}, {Tn}): max |kernel - plain| "
                  f"{d.max().item():.3e} ("
                  + ("atol 1e-5" if dtype == torch.float32 else
                     "one bf16 step per rounding point") + ")", flush=True)
            del got, want, d
        del x32
    torch.cuda.empty_cache()
    return worst


def fused_inputs(seed: int, dtype):
    """Serving-shaped K7 inputs on the card: 2B channel-streams, three
    frames of fresh samples, random carries (post-ReLU-like rows), and
    the synthetic encoder's packed weights in `dtype`."""
    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        TAIL_KS, pack_fused_params,
    )
    from vap_realtime_tpu_torch.weights.convert import params_to_torch
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    N = 2 * B
    enc = params_to_torch(synthetic_params(20)["encoder"], "cuda", dtype)
    carries = tuple(rn(N, k - s, C).abs().to(dtype) for k, s in TAIL_KS)
    news = [(0.1 * rn(N, L_NEW)).to(dtype) for _ in range(3)]
    return (0.1 * rn(N, 5)).to(dtype), news, carries, \
        pack_fused_params(enc, dtype), enc


def phase_a_fused() -> float:
    """conv_stack_fused (K7) vs plain at the serving shape, three frames
    each carrying its own state; returns the max abs error in bf16."""
    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        conv_stack_fused, conv_stack_fused_plain,
    )

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        c0, news, carries, packed, _ = fused_inputs(8, dtype)
        st_k = st_p = (c0, *carries)
        err = 0.0
        for f, new in enumerate(news):
            zk, st_k = conv_stack_fused(st_k[0], new, st_k[1:], *packed)
            zp, st_p = conv_stack_fused_plain(st_p[0], new, st_p[1:],
                                              *packed)
            torch.cuda.synchronize()
            check(zk.dtype == dtype and zk.shape == (2 * B, 5, C)
                  and torch.isfinite(zk).all().item(),
                  f"conv_stack_fused output {dtype} frame {f}")
            check(torch.equal(st_k[0], st_p[0]),
                  f"conv_stack_fused carry c0 {dtype} frame {f}")
            for name, got, want in [("z", zk, zp)] + [
                    (f"c{i}", a, b) for i, (a, b) in
                    enumerate(zip(st_k[1:], st_p[1:]), start=1)]:
                d = (got.float() - want.float()).abs()
                tol = (1e-4 if dtype == torch.float32
                       else 2 ** -6 * (1 + want.float().abs()))
                check(bool((d <= tol).all()),
                      f"conv_stack_fused vs plain {dtype} frame {f} {name}: "
                      f"max |d| {d.max().item():.3e}")
                err = max(err, d.max().item())
        print(f"[a] conv_stack_fused {str(dtype)[6:]} ({2 * B} x {L_NEW}), 3 "
              f"frames: max |kernel - plain| over z and carries {err:.3e} ("
              + ("atol 1e-4" if dtype == torch.float32 else
                 "|d| <= 2^-6 (1 + |plain|)") + ")", flush=True)
        if dtype == torch.bfloat16:
            worst = err
        del news, carries
    torch.cuda.empty_cache()
    return worst


def phase_a_compact() -> float:
    """The compact attend (K10) vs plain at the serving shapes, ring rows:
    float32, bf16, int8 row scales, int8 under the frozen-scale fold;
    returns the max abs error of the bf16 and int8 bodies (float
    units)."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )

    worst = 0.0
    for nb, case in ((B, "mixed"), (B, "dead"), (SERVER_CAPACITY, "mixed")):
        seed = 9 if case == "mixed" else 10
        for body in ("float32", "bf16", "int8 row", "int8 global"):
            if body.startswith("int8"):
                cache, q2, kc2, vc2, age, _, _, sc, _ = attend_inputs_int8(
                    case, seed, nb)
            else:
                dt = torch.float32 if body == "float32" else torch.bfloat16
                cache, q2, kc2, vc2, age, _, _ = attend_inputs(dt, case,
                                                               seed, nb)
            err = 0.0
            for ph in range(P):
                kw = dict(pair_base=2 * ph, num_heads=H, impl="compact")
                args, unit = (cache, q2, kc2, vc2, age), 1.0
                if body == "int8 row":
                    kw["scale"] = sc[:, ph]
                elif body == "int8 global":
                    args, unit = (cache, *fold_global(q2, kc2, vc2),
                                  age), CODE_SCALE
                got = attend_pair(*args, **kw)
                want = attend_pair_plain(*args, **kw)
                if body == "float32":
                    torch.cuda.synchronize()
                    d = (got - want).abs().max().item()
                    check(d <= 1e-4 and torch.isfinite(got).all().item(),
                          f"compact float32 {case} phase {ph}: max |d| "
                          f"{d:.3e}")
                else:
                    d = _compare(got, want, unit, f"compact {body} B={nb} "
                                 f"{case} phase {ph}")
                if case == "dead":
                    check(torch.equal(got, args[3]),
                          f"compact {body} all-DEAD rows: output must equal "
                          f"v_cur")
                err = max(err, d)
            print(f"[a] attend_pair compact (K10) {body} B={nb} {case:5s} "
                  f"ring 7 phases: max |kernel - plain| {err:.3e} ("
                  + ("atol 1e-4" if body == "float32" else
                     f"float units; atol {BF16_TOL:g}, rtol {BF16_TOL:g}")
                  + ")", flush=True)
            if body != "float32":
                worst = max(worst, err)
            del cache
    torch.cuda.empty_cache()
    return worst


def lstm_inputs(seed: int, dtype):
    """(8192, 5, 256) LSTM scan inputs on the card: gates, h0, c0 in
    `dtype`; W_hh^T (256, 1024) and b_hh in float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    N, Hh = 2 * B, C
    return ((0.5 * rn(N, 5, 4 * Hh)).to(dtype), (0.1 * rn(N, Hh)).to(dtype),
            (0.1 * rn(N, Hh)).to(dtype), rn(Hh, 4 * Hh) / Hh ** 0.5,
            0.06 * rn(4 * Hh))


def phase_a_lstm() -> float:
    """lstm_scan (K5) vs plain at (8192, 5, 256); returns the max abs
    error in bf16."""
    from vap_realtime_tpu_torch.ops.cuda.lstm import (
        lstm_scan, lstm_scan_plain,
    )

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = lstm_inputs(11, dtype)
        got = lstm_scan(*args)
        want = lstm_scan_plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, b in zip(("ys", "h_T", "c_T"), got, want):
            check(a.dtype == dtype and a.shape == b.shape
                  and torch.isfinite(a).all().item(),
                  f"lstm_scan {name} {dtype}")
            d = (a.float() - b.float()).abs()
            tol = (1e-5 if dtype == torch.float32
                   else 2 ** -7 * b.float().abs() + 1e-5)
            check(bool((d <= tol).all()), f"lstm_scan vs plain {dtype} "
                  f"{name}: max |d| {d.max().item():.3e}")
            err = max(err, d.max().item())
        print(f"[a] lstm_scan {str(dtype)[6:]} ({2 * B}, 5, {C}): max "
              f"|kernel - plain| {err:.3e} ("
              + ("atol 1e-5" if dtype == torch.float32 else
                 "rtol 2^-7, atol 1e-5") + ")", flush=True)
        if dtype == torch.bfloat16:
            worst = err
    return worst


def single_inputs(dtype, case: str, seed: int, nb: int = B):
    """Serving-shaped K8 inputs for nb streams on the card from a seed: a
    float cache (nb, P, T, 4D), q / k_cur / v_cur (nb, D), ring ages
    (mixed live / DEAD, or all DEAD)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    cache, q, kc, vc = rn(nb, P, T, 4 * D), rn(nb, D), rn(nb, D), rn(nb, D)
    return cache, q, kc, vc, _ages(g, case, nb)[0]


def phase_a_single() -> float:
    """fused_attend (K8) vs its v4 plain form and the einsum reference at
    the serving shapes, all 14 slot pairs; returns the max abs error of
    the bf16 kernel against the v4 plain form."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_reference, fused_attend, fused_attend_plain,
    )

    worst = 0.0
    for dtype, atol, rtol in ((torch.float32, 1e-4, 0.0),
                              (torch.bfloat16, BF16_TOL, BF16_TOL)):
        for nb, case in ((B, "mixed"), (B, "dead"),
                         (SERVER_CAPACITY, "mixed")):
            cache, q, kc, vc, age = single_inputs(
                dtype, case, 14 if case == "mixed" else 15, nb)
            err = {"v4 plain": 0.0, "reference": 0.0}
            for sk in range(0, 4 * P, 2):
                kw = dict(slot_k=sk, slot_v=sk + 1, num_heads=H)
                got = fused_attend(cache, q, kc, vc, age, **kw)
                torch.cuda.synchronize()
                check(torch.isfinite(got).all().item(),
                      f"fused_attend non-finite ({dtype}, {case})")
                for name, fn in (("v4 plain", fused_attend_plain),
                                 ("reference", attend_reference)):
                    want = fn(cache, q, kc, vc, age, **kw).float()
                    d = (got.float() - want).abs()
                    check(not (d > atol + rtol * want.abs()).any().item(),
                          f"fused_attend vs {name} {dtype} B={nb} {case} "
                          f"slots ({sk}, {sk + 1}): max |d| "
                          f"{d.max().item():.3e}")
                    err[name] = max(err[name], d.max().item())
                if case == "dead":
                    check(torch.equal(got, vc),
                          "fused_attend all-DEAD rows: output must equal "
                          "v_cur")
            print(f"[a] fused_attend (K8) {str(dtype)[6:]} B={nb} {case:5s} "
                  f"14 slot pairs: max |kernel - v4 plain| "
                  f"{err['v4 plain']:.3e}, |kernel - reference| "
                  f"{err['reference']:.3e} (atol {atol:g}, rtol {rtol:g})",
                  flush=True)
            if dtype == torch.bfloat16:
                worst = max(worst, err["v4 plain"])
            del cache
    try:
        fused_attend(torch.zeros(4, P, T, 4 * D, dtype=torch.int8,
                                 device="cuda"), q[:4], kc[:4], vc[:4],
                     age[:4], slot_k=0, slot_v=1)
    except ValueError:
        pass
    else:
        check(False, "fused_attend accepted an int8 cache")
    torch.cuda.empty_cache()
    return worst


def tail_inputs(seed: int, nb: int, L0: int, dtype):
    """K9 inputs on the card: a post-ReLU-like x0 (nb, L0, C) in dtype
    and the synthetic encoder's packed tail weights (float32)."""
    from vap_realtime_tpu_torch.ops.cuda.cpc_conv import pack_tail_params
    from vap_realtime_tpu_torch.weights.convert import params_to_torch
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    g = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.relu(torch.randn(nb, L0, C, generator=g, device="cuda"))
    enc = params_to_torch(synthetic_params(20)["encoder"], "cuda")
    return x0.to(dtype), pack_tail_params(enc)


def phase_a_tail() -> float:
    """cpc_conv_tail (K9) vs plain at 8192 channel-streams x 224 (20 Hz)
    and 64 x 384 / 128 (10 / 50 Hz); returns the max abs error with a
    bf16 x0 at the 20 Hz shape."""
    from vap_realtime_tpu_torch.ops.cuda.cpc_conv import (
        cpc_conv_tail, cpc_conv_tail_plain, tail_out_len,
    )

    worst = 0.0
    for nb, L0 in ((2 * B, L0_TAIL), (SERVER_CAPACITY, 384),
                   (SERVER_CAPACITY, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            x0, packed = tail_inputs(16, nb, L0, dtype)
            got = cpc_conv_tail(x0, packed)
            want = cpc_conv_tail_plain(x0, packed).float()
            torch.cuda.synchronize()
            check(got.dtype == dtype
                  and got.shape == (nb, tail_out_len(L0)[-1], C)
                  and torch.isfinite(got).all().item(),
                  f"cpc_conv_tail output {dtype} ({nb}, {L0})")
            d = (got.float() - want).abs()
            tol = (1e-4 if dtype == torch.float32
                   else 2 ** -7 * (1 + want.abs()))
            check(bool((d <= tol).all()), f"cpc_conv_tail vs plain {dtype} "
                  f"({nb}, {L0}): max |d| {d.max().item():.3e}")
            print(f"[a] cpc_conv_tail (K9) {str(dtype)[6:]} ({nb}, {L0}, "
                  f"{C}): max |kernel - plain| {d.max().item():.3e} ("
                  + ("atol 1e-4" if dtype == torch.float32 else
                     "|d| <= 2^-7 (1 + |plain|)") + ")", flush=True)
            if dtype == torch.bfloat16 and L0 == L0_TAIL:
                worst = d.max().item()
            del x0, got, want, d
    torch.cuda.empty_cache()
    return worst


def fast_inputs(cfg, n_streams, frames, seed, device, dtype, n=None):
    """(frames, n_streams, 2, n) audio from a seed; n defaults to the fast
    path's frame_shift."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = 0.1 * torch.randn(frames, n_streams, 2, n or cfg.frame_shift,
                          generator=g, device=device)
    return x.to(dtype)


def run_steps(p, cfg, nb, frames, dtype, device, config, plain=False,
              active=None):
    """fast_step over `frames` with a fresh state of `config` (CONFIGS),
    through the kernels or (plain=True) their plain versions; returns the
    (F, nb, ...) stacked p_now, p_future, vad."""
    from vap_realtime_tpu_torch.runtime import incremental as inc

    init_kw, step_kw = config_kw(config, plain)
    st = inc.init_fast_state(cfg, nb, dtype, device=device, **init_kw)
    res = []
    with plain_fused(plain and step_kw["conv_impl"] == "fused"):
        for f in range(frames.shape[0]):
            act = None if active is None else active(f)
            st, o = inc.fast_step(p, st, frames[f], cfg, act, **step_kw)
            res.append(torch.stack([o["p_now"], o["p_future"], o["vad"]])
                       .float())
    return torch.stack(res)


def phase_b(cfg, params_np):
    """The full-width fast step on the card, in every configuration."""
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    # small input, float32: the card (kernels) equals the CPU path
    nb, nf = 3, 12
    p32 = {dev: params_to_torch(params_np, dev) for dev in ("cpu", "cuda")}
    frames = fast_inputs(cfg, nb, nf, 5, "cpu", torch.float32)
    for config in STEP_CONFIGS:
        outs = {}
        for dev in ("cpu", "cuda"):
            act = lambda f: torch.tensor([True, f % 2 == 0, f % 3 != 0],
                                         device=dev)
            outs[dev] = run_steps(p32[dev], cfg, nb, frames.to(dev),
                                  torch.float32, dev, config,
                                  active=act).cpu()
        d = (outs["cuda"] - outs["cpu"]).abs().max().item()
        check(d <= 1e-4, f"f32 {config} card vs CPU path: max |d| {d:.3e}")
        print(f"[b] full width f32 {config}, B={nb}, {nf} frames, card vs "
              f"CPU path: max |d| {d:.3e} (atol 1e-4)", flush=True)
    del p32

    # serving size, bf16: kernels vs plain versions, launches per step
    p = params_to_torch(params_np, "cuda", torch.bfloat16)
    nf = 17
    frames = fast_inputs(cfg, B, nf, 6, "cuda", torch.bfloat16)
    idx = torch.arange(B, device="cuda")
    act = lambda f: (idx + f) % 7 != 0
    for config in STEP_CONFIGS:
        zero_counts()
        pk = run_steps(p, cfg, B, frames, torch.bfloat16, "cuda", config,
                       active=act)[:, 0]
        torch.cuda.synchronize()
        want = {k: v * nf for k, v in per_step(config).items()}
        got = counts()
        check(got == want, f"{config}: launches {got}, expected {want}")
        pp = run_steps(p, cfg, B, frames, torch.bfloat16, "cuda", config,
                       plain=True, active=act)[:, 0]
        check(counts() == want, f"{config}: the plain run launched a "
                                f"kernel")
        check(pk.shape == (nf, B, 2) and torch.isfinite(pk).all().item(),
              f"{config}: p_now shape / finiteness")
        check(((pk >= 0) & (pk <= 1.0 + 1e-2)).all().item(),
              f"{config}: p_now in [0, 1]")
        d = (pk - pp).abs().max().item()
        check(d <= 2e-2, f"bf16 {config} kernels vs plain step: max |d "
                         f"p_now| {d:.3e}")
        print(f"[b] full width bf16 {config}, B={B}, {nf} frames: kernels "
              f"vs plain max |d p_now| {d:.3e} (atol 2e-2); launches "
              f"{got} = {per_step(config)} per step", flush=True)
        del pk, pp
        torch.cuda.empty_cache()
    return p, frames


def slice4_steps(p, cfg, nb, frames, dtype, device, path, plain=False,
                 active=None):
    """The kv step (staged slots; the attend kernel or, plain=True, its
    plain version) or the full-recompute step over overlapped `frames`
    (F, nb, 2, frame_samples) from a fresh state; returns the (F, 3, nb,
    2) stacked p_now, p_future, vad."""
    from vap_realtime_tpu_torch.runtime.arena import (
        init_path_state, path_step,
    )

    st = init_path_state(path, cfg, nb, dtype, device, staged=True)
    res = []
    for f in range(frames.shape[0]):
        act = None if active is None else active(f)
        st, o = path_step(path, p, st, frames[f], cfg, act, slots="staged",
                          attend_impl="plain" if plain else "kernel")
        res.append(torch.stack([o["p_now"], o["p_future"], o["vad"]])
                   .float())
    return torch.stack(res)


def phase_b_slice4(cfg, params_np):
    """The kv and full paths at full width: float32 card vs CPU path, bf16
    B=4096 kv kernels vs plain with the launch counts, the full step's
    outputs, and the 20 Hz stream golden on the card.  Returns the bf16
    params and the B=4096 overlapped frames for phase (d)."""
    from vap_realtime_tpu_torch.runtime import streaming
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    n = cfg.frame_samples
    nb, nf = 3, 12
    p32 = {dev: params_to_torch(params_np, dev) for dev in ("cpu", "cuda")}
    frames = fast_inputs(cfg, nb, nf, 17, "cpu", torch.float32, n)
    for path in ("kv", "full"):
        outs = {}
        for dev in ("cpu", "cuda"):
            act = lambda f: torch.tensor([True, f % 2 == 0, f % 3 != 0],
                                         device=dev)
            outs[dev] = slice4_steps(p32[dev], cfg, nb, frames.to(dev),
                                     torch.float32, dev, path,
                                     active=act).cpu()
        d = (outs["cuda"] - outs["cpu"]).abs().max().item()
        check(d <= 1e-4, f"f32 {path} card vs CPU path: max |d| {d:.3e}")
        print(f"[b] full width f32 {path} step, B={nb}, {nf} frames, card "
              f"vs CPU path: max |d| {d:.3e} (atol 1e-4)", flush=True)

    # the original reference's 20 Hz stream golden, float32 on the card
    golden = np.load("tests/golden/stream_vap_20hz.npz")
    fr = torch.as_tensor(streaming.frame_audio(golden["audio"], cfg)[:, None],
                         device="cuda")
    _, outs = streaming.run_frames(p32["cuda"], streaming.init_stream_state(
        cfg, 1, device="cuda"), fr, cfg)
    err = max(np.abs(outs[k][:, 0].cpu().numpy() - golden[k]).max()
              for k in ("p_now", "p_future", "vad"))
    check(err <= 1e-4, f"stream golden on the card: max |d| {err:.3e}")
    print(f"[b] run_frames (full recompute) over the 20 Hz stream golden, "
          f"{fr.shape[0]} frames, float32 on the card: max |d| vs the "
          f"original reference {err:.3e} (atol 1e-4)", flush=True)
    del p32

    p = params_to_torch(params_np, "cuda", torch.bfloat16)
    nf = 10                                          # one staged merge
    frames = fast_inputs(cfg, B, nf, 18, "cuda", torch.bfloat16, n)
    idx = torch.arange(B, device="cuda")
    act = lambda f: (idx + f) % 7 != 0
    zero_counts()
    kv = slice4_steps(p, cfg, B, frames, torch.bfloat16, "cuda", "kv",
                      active=act)
    torch.cuda.synchronize()
    want = {k: v * nf for k, v in per_step("kv").items()}
    got = counts()
    check(got == want, f"kv: launches {got}, expected {want}")
    kv_plain = slice4_steps(p, cfg, B, frames, torch.bfloat16, "cuda", "kv",
                            plain=True, active=act)
    check(counts() == want, "kv: the plain run launched a kernel")
    d = (kv[:, 0] - kv_plain[:, 0]).abs().max().item()
    check(torch.isfinite(kv).all().item() and d <= 2e-2,
          f"bf16 kv kernels vs plain step: max |d p_now| {d:.3e}")
    full = slice4_steps(p, cfg, B, frames, torch.bfloat16, "cuda", "full",
                        active=act)
    check(torch.isfinite(full).all().item()
          and ((full >= 0) & (full <= 1 + 1e-2)).all().item()
          and (full[:, 0].sum(-1) - 1).abs().max().item() < 2e-2,
          "bf16 full step: probabilities finite, in [0, 1], p_now summing "
          "to 1")
    d_kf = (kv[:, 0] - full[:, 0]).abs().max().item()
    print(f"[b] full width bf16 kv step (staged, K2), B={B}, {nf} frames: "
          f"kernels vs plain max |d p_now| {d:.3e} (atol 2e-2); launches "
          f"{got} = {per_step('kv')} per step; full step p_now finite, "
          f"summing to 1; kv vs full while the context grows: max |d "
          f"p_now| {d_kf:.3e}", flush=True)
    del kv, kv_plain, full
    torch.cuda.empty_cache()
    return p, frames


def attend_bound(es: int, staged: bool, row_scales: bool = False):
    """Bytes each input is read once / output written once, and float32
    operations, of one attend launch at B, T, S (cache element size
    es bytes, bf16 q / k_cur / v_cur / out)."""
    nbytes = B * T * 4 * D * es + 4 * B * 2 * D * 2 + B * T * 4
    rows = T
    if staged:
        nbytes += S * B * 4 * D * es + S * B * 4
        rows += S
    if row_scales:
        nbytes += B * T * 4 + (S * B * 4 if staged else 0)
    return bound(nbytes, B * 2 * rows * D * 5), nbytes


def sdpa_fn(plane, stage_ph, q2, kc2, vc2, age, sage):
    """One scaled_dot_product_attention call over the same (2B, H, 1, L)
    problem as one attend launch of a phase: plane (B, T, 4D) and
    stage_ph (S, B, 4D) or None, bf16 float-unit rows; the ring + staged
    + current k/v gathered into SDPA's layout, the AliBi/validity bias as
    an additive float mask.  The port never calls it."""
    from vap_realtime_tpu_torch.models.transformer import alibi_slopes

    nb, Dh = q2.shape[0], D // H
    kv = plane.reshape(nb, T, 2, 2, D)
    ages = [age]
    if stage_ph is not None:
        kv = torch.cat([kv, stage_ph.reshape(S, nb, 2, 2, D).transpose(0, 1)],
                       1)
        ages.append(sage.T)
    kv = kv.transpose(1, 2)                          # (B, 2, L-1, 2, D)
    L = kv.shape[2] + 1

    def heads(x):                                    # (B, 2, L, D) -> SDPA
        return x.reshape(nb, 2, L, H, Dh).permute(0, 1, 3, 2, 4).reshape(
            2 * nb, H, L, Dh).contiguous()

    k_all = heads(torch.cat([kv[:, :, :, 0], kc2[:, :, None]], 2))
    v_all = heads(torch.cat([kv[:, :, :, 1], vc2[:, :, None]], 2))
    slopes = torch.tensor(alibi_slopes(H), device="cuda")
    ages = torch.cat(ages + [torch.zeros(nb, 1, device="cuda")], 1)
    bias = torch.where(ages[:, None, :] < 1e8, -ages[:, None, :]
                       * slopes[None, :, None], float("-inf"))  # (B, H, L)
    mask = bias[:, None].expand(nb, 2, H, L).reshape(
        2 * nb, H, 1, L).to(q2.dtype)
    q_s = q2.reshape(2 * nb, H, 1, Dh).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q_s, k_all, v_all, attn_mask=mask,
                        scale=D ** -0.5).reshape(nb, 2, D)


def phase_d(cfg, p_bf16, frames, gpu):
    """Times on the card; returns the kernels' numbers for the JSON
    line."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )
    from vap_realtime_tpu_torch.ops.cuda.channorm import (
        channel_norm_relu, channel_norm_relu_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms
    from vap_realtime_tpu_torch.runtime import incremental as inc

    bodies, compact = {}, {}

    def time_body(name, call, plain, lib, staged, es, row_scales, unit,
                  into=bodies):
        """ms/launch (rotating over the 7 phases), plain ms, library ms
        into `into[name]`; `call(ph)` / `plain(ph)` run phase ph, `lib()`
        the yardstick and returns its output in float units, checked
        against the kernel."""
        ph = iter(range(10 ** 9))
        ms = cuda_ms(lambda: call(next(ph) % P), reps=70, warm=7)
        plain_ms = cuda_ms(lambda: plain(1), reps=7, warm=2)
        (bound_ms, bound_by), nbytes = attend_bound(es, staged, row_scales)
        library_ms = cuda_ms(lib, reps=20, warm=3)
        d_lib = (lib().float() - call(1).float() * unit).abs().max().item()
        into[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        print(f"[d] attend_pair {name}, B={B} T={T}"
              f"{f' S={S}' if staged else ''}: {ms:.4f} ms/launch, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB at "
              f"3.35 TB/s) = {100 * bound_ms / ms:.1f}% of bound; plain "
              f"{plain_ms:.4f} ms; scaled_dot_product_attention yardstick "
              f"{library_ms:.4f} ms (max |sdpa - kernel| {d_lib:.3e}) | "
              f"{gpu}", flush=True)

    # K1 / K2: the bf16 cache
    cache, q2, kc2, vc2, age, sage, stage = attend_inputs(
        torch.bfloat16, "mixed", 3)
    for name, staged in (("K2 bf16 staged", True), ("K1 bf16 ring", False)):
        st = (stage, sage) if staged else (None, None)
        run = lambda ph, fn=attend_pair, st=st: fn(
            cache, q2, kc2, vc2, age, *st, pair_base=2 * ph, num_heads=H)
        plain = lambda ph, st=st: attend_pair_plain(
            cache, q2, kc2, vc2, age, *st, pair_base=2 * ph, num_heads=H)
        lib = sdpa_fn(cache[:, 1], stage[:, :, 4 * D:8 * D] if staged
                      else None, q2, kc2, vc2, age, sage)
        time_body(name, run, plain, lib, staged, 2, False, 1.0)
        del lib
    # K10: the compact body on the same bf16 ring
    run = lambda ph, fn=attend_pair: fn(
        cache, q2, kc2, vc2, age, pair_base=2 * ph, num_heads=H,
        impl="compact")
    lib = sdpa_fn(cache[:, 1], None, q2, kc2, vc2, age, sage)
    time_body("K10 bf16 ring", run, lambda ph: run(ph, attend_pair_plain),
              lib, False, 2, False, 1.0, compact)
    del cache, stage, lib
    torch.cuda.empty_cache()

    # K3 / K4: the int8 cache; the yardstick runs on the dequantised rows
    cache, q2, kc2, vc2, age, sage, stage, sc, ssc = attend_inputs_int8(
        "mixed", 3)
    folded = fold_global(q2, kc2, vc2)
    bf = torch.bfloat16
    plane_g = (cache[:, 1].float() * CODE_SCALE).to(bf)
    stage_g = (stage[:, :, 4 * D:8 * D].float() * CODE_SCALE).to(bf)
    plane_r = (cache[:, 1].float() * sc[:, 1, :, None]).to(bf)
    stage_r = (stage[:, :, 4 * D:8 * D].float() * ssc[:, :, 1, None]).to(bf)
    for name, staged in (("K3 int8 global staged", True),
                         ("K3 int8 global ring", False),
                         ("K4 int8 row staged", True),
                         ("K4 int8 row ring", False)):
        st = (stage, sage) if staged else (None, None)
        if name.startswith("K3"):
            def run(ph, fn=attend_pair, st=st):
                return fn(cache, *folded, age, *st, pair_base=2 * ph,
                          num_heads=H)
            lib = sdpa_fn(plane_g, stage_g if staged else None, q2, kc2,
                          vc2, age, sage)
            unit, rows = CODE_SCALE, False
        else:
            def run(ph, fn=attend_pair, st=st, staged=staged):
                return fn(cache, q2, kc2, vc2, age, *st, scale=sc[:, ph],
                          stage_scale=ssc[:, :, ph] if staged else None,
                          pair_base=2 * ph, num_heads=H)
            lib = sdpa_fn(plane_r, stage_r if staged else None, q2, kc2,
                          vc2, age, sage)
            unit, rows = 1.0, True
        plain = lambda ph, run=run: run(ph, attend_pair_plain)
        time_body(name, run, plain, lib, staged, 1, rows, unit)
        del lib
    # K10 on the int8 ring: the frozen-scale fold and row scales
    for name, rows in (("K10 int8 global ring", False),
                       ("K10 int8 row ring", True)):
        if rows:
            def run(ph, fn=attend_pair):
                return fn(cache, q2, kc2, vc2, age, scale=sc[:, ph],
                          pair_base=2 * ph, num_heads=H, impl="compact")
            lib, unit = sdpa_fn(plane_r, None, q2, kc2, vc2, age,
                                sage), 1.0
        else:
            def run(ph, fn=attend_pair):
                return fn(cache, *folded, age, pair_base=2 * ph,
                          num_heads=H, impl="compact")
            lib, unit = sdpa_fn(plane_g, None, q2, kc2, vc2, age,
                                sage), CODE_SCALE
        time_body(name, run, lambda ph, run=run: run(ph, attend_pair_plain),
                  lib, False, 1, rows, unit, compact)
        del lib
    del cache, stage, plane_g, stage_g, plane_r, stage_r
    torch.cuda.empty_cache()

    # K6 at each conv layer's serving shape, bf16
    layers = {}
    for Tn in NORM_T:
        x32, w, b = norm_inputs(6, Tn)
        x, w, b = x32.to(bf), w.to(bf), b.to(bf)
        del x32
        ms = cuda_ms(lambda: channel_norm_relu(x, w, b), reps=50, warm=5)
        plain_ms = cuda_ms(lambda: channel_norm_relu_plain(x, w, b), reps=10)
        n = x.numel()
        bound_ms, bound_by = bound(2 * n * 2 + 2 * C * 2, 10 * n)
        layers[Tn] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        print(f"[d] channel_norm_relu bf16 ({2 * B}, {C}, {Tn}): {ms:.4f} "
              f"ms/launch, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{4 * n / 1e9:.3f} GB at 3.35 TB/s) = "
              f"{100 * bound_ms / ms:.1f}% of bound; plain {plain_ms:.4f} ms"
              f" | {gpu}", flush=True)
        del x
    torch.cuda.empty_cache()
    norm = {k: sum(v[k] for v in layers.values())
            for k in ("ms", "plain_ms", "bound_ms")}
    print(f"[d] channel_norm_relu, the 5 launches of a normk step: "
          f"{norm['ms']:.4f} ms, bound {norm['bound_ms']:.4f} ms, plain "
          f"{norm['plain_ms']:.4f} ms; no single PyTorch call computes it "
          f"(layer_norm and group_norm use the biased variance) | {gpu}",
          flush=True)

    fused = time_fused(p_bf16, frames, gpu)
    lstm = time_lstm(p_bf16, gpu)

    # the fast step at serving size (kernels), every configuration
    steps = 24
    for config in STEP_CONFIGS:
        init_kw, step_kw = config_kw(config)
        st = inc.init_fast_state(cfg, B, bf, device="cuda", **init_kw)
        for f in range(steps + 4):
            if f == 4:
                torch.cuda.synchronize()
                t0 = time.time()
            st, o = inc.fast_step(p_bf16, st, frames[f % frames.shape[0]],
                                  cfg, **step_kw)
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) * 1e3 / steps
        streams = B * (1e3 / cfg.frame_hz) / step_ms
        print(f"[d] fast {step_kw['slots']} step bf16 {config}, B={B}, "
              f"kernels: {step_ms:.3f} ms/step (host clock, {steps} steps"
              f"{' incl. 3 merges' if init_kw['staged'] else ''}) -> "
              f"{streams:.0f} realtime streams per card at {cfg.frame_hz} "
              f"Hz | {gpu}", flush=True)
        del st
        torch.cuda.empty_cache()
    return (bodies, dict(norm, bound_by="bytes", library_ms=None,
                         layers=layers), compact, fused, lstm)


def phase_d_slice4(cfg, p_bf16, frames, gpu):
    """Times of the slice-4 kernels (K8, K9) and of the kv and full steps
    at B=4096 bf16; returns the kernels' numbers for the JSON line."""
    from vap_realtime_tpu_torch.runtime.arena import (
        init_path_state, path_step,
    )

    single, tail = time_single(gpu), time_tail(p_bf16, gpu)
    steps = 12
    for path in ("kv", "full"):
        st = init_path_state(path, cfg, B, torch.bfloat16, "cuda",
                             staged=True)
        for f in range(steps + 3):
            if f == 3:
                torch.cuda.synchronize()
                t0 = time.time()
            st, o = path_step(path, p_bf16, st, frames[f % frames.shape[0]],
                              cfg, slots="staged", attend_impl="kernel")
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) * 1e3 / steps
        print(f"[d] {path} step bf16{' staged, K2' if path == 'kv' else ''}"
              f", B={B}: {step_ms:.3f} ms/step (host clock, {steps} steps) "
              f"-> {B * (1e3 / cfg.frame_hz) / step_ms:.0f} realtime "
              f"streams per card at {cfg.frame_hz} Hz | {gpu}", flush=True)
        del st
        torch.cuda.empty_cache()
    return single, tail


def time_single(gpu) -> dict:
    """K8 at B=4096, T=50 in bf16: ms per launch (rotating over the 14
    slot pairs), its bound, the v4 plain form, and SDPA with a float mask
    over the same (B, H, 1, T+1) problem (the yardstick; the port never
    calls it)."""
    from vap_realtime_tpu_torch.models.transformer import alibi_slopes
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        fused_attend, fused_attend_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    bf = torch.bfloat16
    cache, q, kc, vc, age = single_inputs(bf, "mixed", 19)
    it = iter(range(10 ** 9))

    def run(i, fn=fused_attend):
        return fn(cache, q, kc, vc, age, slot_k=2 * i, slot_v=2 * i + 1,
                  num_heads=H)

    ms = cuda_ms(lambda: run(next(it) % (2 * P)), reps=70, warm=14)
    dev_ms = kernel_device_ms(lambda: run(next(it) % (2 * P)),
                              "attend_pair_kernel", 28)
    plain_ms = cuda_ms(lambda: run(2, fused_attend_plain), reps=7, warm=2)
    Dh = D // H
    kv = cache[:, 1, :, 0:2 * D].reshape(B, T, 2, H, Dh)     # slots (4, 5)
    k_all = torch.cat([kv[:, :, 0], kc.reshape(B, 1, H, Dh)], 1)
    v_all = torch.cat([kv[:, :, 1], vc.reshape(B, 1, H, Dh)], 1)
    k_all, v_all = (x.transpose(1, 2).contiguous() for x in (k_all, v_all))
    slopes = torch.tensor(alibi_slopes(H), device="cuda")
    ages = torch.cat([age, torch.zeros(B, 1, device="cuda")], 1)
    mask = torch.where(ages[:, None, :] < 1e8, -ages[:, None, :]
                       * slopes[None, :, None], float("-inf"))
    mask = mask[:, :, None].to(bf)                            # (B, H, 1, L)
    q_s = q.reshape(B, H, 1, Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q_s, k_all, v_all, attn_mask=mask,
                       scale=D ** -0.5).reshape(B, D)
    library_ms = cuda_ms(lib, reps=20, warm=3)
    d_lib = (lib().float() - run(2).float()).abs().max().item()
    nbytes = B * T * 2 * D * 2 + 4 * B * D * 2 + B * T * 4
    bound_ms, bound_by = bound(nbytes, B * T * D * 5)
    print(f"[d] fused_attend (K8) bf16, B={B} T={T}: {ms:.4f} ms/launch "
          f"(kernel alone {dev_ms:.4f} ms, torch.profiler), "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB at "
          f"3.35 TB/s) = {100 * bound_ms / ms:.1f}% of bound; plain "
          f"{plain_ms:.4f} ms; scaled_dot_product_attention yardstick "
          f"{library_ms:.4f} ms (max |sdpa - kernel| {d_lib:.3e}) | {gpu}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                kernel_device_ms=dev_ms)


def time_tail(p_bf16, gpu) -> dict:
    """K9 at 8192 channel-streams x L0 = 224, with a bf16 x0 (the kv
    path's dtype) and a float32 one: ms per launch, the float32-CUDA-core
    bound, the plain version; and the cuDNN conv1-4 + ChannelNorm tail of
    cpc_conv_stack over the same x0 (the yardstick: no single PyTorch call
    computes the tail)."""
    from vap_realtime_tpu_torch.ops.basic import channel_norm, conv1d
    from vap_realtime_tpu_torch.ops.cuda.cpc_conv import (
        TAIL_SPECS, cpc_conv_tail, cpc_conv_tail_plain, tail_out_len,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    N, lens = 2 * B, tail_out_len(L0_TAIL)
    flops = 2 * N * C * C * sum(L * k for L, (k, _, _) in zip(lens,
                                                              TAIL_SPECS))
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        x0, packed = tail_inputs(20, N, L0_TAIL, dtype)
        enc = {k: {n: t.to(dtype) for n, t in v.items()}
               for k, v in p_bf16["encoder"].items()}

        def cudnn_tail():
            x = x0.transpose(1, 2)
            for li, (_, s, pad) in enumerate(TAIL_SPECS, start=1):
                c, n = enc[f"conv{li}"], enc[f"norm{li}"]
                x = torch.relu(channel_norm(conv1d(x, c["w"], c["b"], s, pad),
                                            n["w"], n["b"]))
            return x

        ms = cuda_ms(lambda: cpc_conv_tail(x0, packed), reps=5, warm=1)
        plain_ms = cuda_ms(lambda: cpc_conv_tail_plain(x0, packed), reps=3,
                           warm=1)
        tail_ms = cuda_ms(cudnn_tail, reps=5, warm=1)
        es = x0.element_size()
        nbytes = (N * (L0_TAIL + lens[-1]) * C * es
                  + sum(t.numel() for t in packed) * 4)
        bound_ms, bound_by = bound(nbytes, flops)
        name = str(dtype)[6:]
        print(f"[d] cpc_conv_tail (K9) {name} x0 ({N}, {L0_TAIL}, {C}): "
              f"{ms:.4f} ms/launch, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e12:.3f} TFLOP at 67 TFLOP/s float32; "
              f"{nbytes / 1e9:.3f} GB) = {100 * bound_ms / ms:.1f}% of bound;"
              f" plain {plain_ms:.4f} ms; no single PyTorch call: the cuDNN "
              f"conv1-4 + ChannelNorm tail {tail_ms:.4f} ms | {gpu}",
              flush=True)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         cudnn_tail_ms=tail_ms)
        del x0
    torch.cuda.empty_cache()
    return dict(res["bfloat16"], bodies=res)


def time_fused(p_bf16, frames, gpu) -> dict:
    """K7 at the serving shape in bf16: ms per launch, its bound, the
    plain version, and the `conv` and `normk` stacks over the same
    frame (no single PyTorch call computes the stack)."""
    from vap_realtime_tpu_torch.models.encoder import (
        cpc_conv_stack_streaming, cpc_conv_stack_streaming_normk,
    )
    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        TAIL_KS, conv_stack_fused, conv_stack_fused_plain,
        init_conv_stream_state_fused, pack_fused_params, tail_lens,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    bf = torch.bfloat16
    N = 2 * B
    enc = p_bf16["encoder"]
    st = init_conv_stream_state_fused(N, dtype=bf, device="cuda")
    new = frames[0].reshape(N, L_NEW)
    w0, wts, aux = pack_fused_params(enc, bf)
    args = (st["c0"][:, 0], new, tuple(st[f"c{i}"] for i in range(1, 5)),
            w0, wts, aux)
    ms = cuda_ms(lambda: conv_stack_fused(*args), reps=10, warm=2)
    plain_ms = cuda_ms(lambda: conv_stack_fused_plain(*args), reps=3)
    conv_ms = cuda_ms(lambda: cpc_conv_stack_streaming(enc, new, st), 10)
    normk_ms = cuda_ms(lambda: cpc_conv_stack_streaming_normk(enc, new, st),
                       10)
    T0 = L_NEW // 5
    flops = 2 * N * C * (T0 * 10 + sum(
        t_out * k * C for (k, _), (_, t_out) in zip(TAIL_KS,
                                                    tail_lens(T0))))
    carry = (5 + sum(k - s for k, s in TAIL_KS) * C) * 2
    nbytes = (N * (L_NEW * 2 + 2 * carry + 5 * C * 2)
              + (w0.numel() + sum(w.numel() for w in wts)) * 2
              + aux.numel() * 4)
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    print(f"[d] conv_stack_fused bf16 ({N} x {L_NEW}): {ms:.4f} ms/launch, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e12:.3f} TFLOP "
          f"at 989 TFLOP/s bf16; {nbytes / 1e9:.3f} GB) = "
          f"{100 * bound_ms / ms:.1f}% of bound; plain {plain_ms:.4f} ms; "
          f"no single PyTorch call: the conv stack (cuDNN convs + plain "
          f"ChannelNorm) {conv_ms:.4f} ms, the normk stack {normk_ms:.4f} "
          f"ms | {gpu}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, conv_stack_ms=conv_ms,
                normk_stack_ms=normk_ms)


def time_lstm(p_bf16, gpu) -> dict:
    """K5 at (8192, 5, 256), bf16 gates and state (the encoder's dtype):
    ms per launch, its bound, the plain version; lstm_fused (input
    projection + scan) against torch.nn.LSTM on cuDNN over the same
    problem (the yardstick; the port never calls it)."""
    from vap_realtime_tpu_torch.ops.cuda.lstm import (
        lstm_fused, lstm_scan, lstm_scan_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    bf = torch.bfloat16
    N, Hh, Tn = 2 * B, C, 5
    g = p_bf16["encoder"]["lstm"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(N, Tn, Hh, generator=gen, device="cuda").to(bf)
    h0 = (0.1 * torch.randn(N, Hh, generator=gen, device="cuda")).to(bf)
    c0 = (0.1 * torch.randn(N, Hh, generator=gen, device="cuda")).to(bf)
    gi = torch.matmul(x, g["w_ih"].T) + g["b_ih"]
    scan = (gi, h0, c0, g["w_hh"].T, g["b_hh"])
    ms = cuda_ms(lambda: lstm_scan(*scan), reps=20, warm=3)
    plain_ms = cuda_ms(lambda: lstm_scan_plain(*scan), reps=5)
    fused_ms = cuda_ms(lambda: lstm_fused(x, h0, c0, g["w_ih"], g["w_hh"],
                                          g["b_ih"], g["b_hh"]), reps=20)
    net = torch.nn.LSTM(Hh, Hh, batch_first=True).to("cuda", bf)
    with torch.no_grad():
        for name, attr in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                           ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
            getattr(net, attr).copy_(g[name])
        net.flatten_parameters()
        lib = lambda: net(x, (h0[None], c0[None]))
        library_ms = cuda_ms(lib, reps=20, warm=3)
        d = (lib()[0].float()
             - lstm_fused(x, h0, c0, g["w_ih"], g["w_hh"], g["b_ih"],
                          g["b_hh"])[0].float()).abs().max().item()
    flops = 2 * N * Tn * Hh * 4 * Hh
    nbytes = (gi.numel() * 2 + 4 * N * Hh * 2 + Hh * 4 * Hh * 4 + 4 * Hh * 4
              + N * Tn * Hh * 2)
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[d] lstm_scan bf16 ({N}, {Tn}, {Hh}): {ms:.4f} ms/launch, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP at 67 "
          f"TFLOP/s float32) = {100 * bound_ms / ms:.1f}% of bound; plain "
          f"{plain_ms:.4f} ms; lstm_fused (projection + scan) "
          f"{fused_ms:.4f} ms vs torch.nn.LSTM (cuDNN) {library_ms:.4f} ms "
          f"(max |nn.LSTM - lstm_fused| {d:.3e}) | {gpu}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                lstm_fused_ms=fused_ms)


# --- slice 5: the lab kernels (K11, K12) and the hybrid paths -------------

LAB_TOL = {torch.float32: 1e-4, torch.bfloat16: BF16_TOL}
FLOAT_LAB_MODES = ("dma", "mxu", "nomax", "noexp", "f32out", "nodenom",
                   "noout", "bf16exp", "v5")
INT8_LAB_MODES = ("dma", "q8glb")


def lab_inputs(dtype, seed: int, nb: int, int8: bool = False):
    """The lab's inputs at nb streams, made on the card from a seed: a
    (nb, P, T, 4D) cache (dtype, or int8 codes over the full range), q /
    kc / vc (nb, 2D) and live ages in [1, T)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda")
    if int8:
        cache = torch.randint(-127, 128, (nb, P, T, 4 * D), **kw).to(
            torch.int8)
    else:
        cache = (0.3 * torch.randn(nb, P, T, 4 * D, **kw)).to(dtype)
    q, kc, vc = (0.3 * torch.randn(3, nb, 2 * D, **kw)).to(dtype)
    age = torch.randint(1, T, (nb, T), **kw).float()
    return cache, q, kc, vc, age


def lab_tol(mode: str, dtype) -> float:
    """atol = rtol of one lab mode: float32 1e-4 (TF32 is off; the
    kernel sums in another order), bf16 2e-2 (both round the products to
    bf16 where the TPU body does, at the same points, and sum in other
    orders); bf16exp rounds to bf16 in any dtype, so 2e-2 there too."""
    return BF16_TOL if mode == "bf16exp" else LAB_TOL[dtype]


def phase_a_lab() -> float:
    """K11 in every mode, 1 and 2 streams per block, against its plain
    version: B=4096 (phases 0 and 6) and the server's 64 (all phases),
    T=50; float32 and bf16 caches, int8 codes with bf16 q.  noexp's q and
    kc are scaled down, so that its denominators (sums of the ages' bias)
    stay away from 0; this is checked.  Returns the max abs error."""
    from vap_realtime_tpu_torch.ops.cuda.attend_lab import (
        attend_lab, attend_lab_plain,
    )

    worst = 0.0
    cases = [(dt, False, FLOAT_LAB_MODES)
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((torch.bfloat16, True, INT8_LAB_MODES))
    for dtype, int8, modes in cases:
        for nb, phases in ((B, (0, P - 1)), (SERVER_CAPACITY, range(P))):
            cache, q, kc, vc, age = lab_inputs(dtype, 30, nb, int8)
            for mode in modes:
                qm, kcm = (0.1 * q, 0.1 * kc) if mode == "noexp" else (q, kc)
                tol = lab_tol(mode, dtype)
                err = 0.0
                for ph in phases:
                    want = attend_lab_plain(mode, cache, qm, kcm, vc, age, ph)
                    wf = want.float()
                    if mode == "noexp":
                        check(wf.isfinite().all().item(), "noexp plain")
                    for streams in (1, 2):
                        got = attend_lab(mode, cache, qm, kcm, vc, age, ph,
                                         streams=streams).float()
                        torch.cuda.synchronize()
                        d = (got - wf).abs()
                        check(torch.isfinite(got).all().item()
                              and not (d > tol + tol * wf.abs()).any().item(),
                              f"attend_lab {mode} {str(dtype)[6:]} int8="
                              f"{int8} B={nb} phase {ph} streams={streams}: "
                              f"max |d| {d.max().item():.3e}")
                        err = max(err, d.max().item())
                worst = max(worst, err)
                print(f"[a] attend_lab {mode:8s} {'int8' if int8 else ''}"
                      f"{str(dtype)[6:]} B={nb} T={T}, 1 and 2 streams per "
                      f"block: max |kernel - plain| {err:.3e} (atol = rtol "
                      f"{tol:g})", flush=True)
            del cache
    torch.cuda.empty_cache()
    return worst


def phase_a_read() -> float:
    """K12 against its plain version on the whole cache at B=4096 and 64,
    T=50, float32 / bf16 / int8: |d| <= 1e-5 * sum |x| per column (float32
    sums in another order), and two launches bit-equal (no atomics).
    Returns the max abs error."""
    from vap_realtime_tpu_torch.ops.cuda.lab import (
        cache_read_all, cache_read_all_plain,
    )

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for nb in (B, SERVER_CAPACITY):
            cache = lab_inputs(dtype, 31, nb, dtype == torch.int8)[0]
            got = cache_read_all(cache)
            again = cache_read_all(cache)
            want = cache_read_all_plain(cache)
            mag = cache.float().abs().sum((0, 1, 2))[None]
            torch.cuda.synchronize()
            d = (got - want).abs()
            check(got.shape == (1, 4 * D) and torch.equal(got, again)
                  and not (d > 1e-5 * mag).any().item(),
                  f"cache_read {dtype} B={nb}: max |d| {d.max().item():.3e}, "
                  f"repeat equal {torch.equal(got, again)}")
            worst = max(worst, d.max().item())
            print(f"[a] cache_read {str(dtype)[6:]} ({nb}, {P}, {T}, {4 * D}):"
                  f" max |kernel - plain| {d.max().item():.3e} (<= 1e-5 x "
                  f"column sum |x|), two launches bit-equal", flush=True)
            del cache, mag
    torch.cuda.empty_cache()
    return worst


def hybrid_steps(p, cfg, nb, frames, dtype, device, path, R, plain=False,
                 active=None):
    """hybrid_step / fast_hybrid_step over `frames` from a fresh staged
    state at resync_every R, the attend kernel (plain=True: its plain
    version); returns the (F, 3, nb, 2) stacked p_now, p_future, vad."""
    from vap_realtime_tpu_torch.runtime.arena import (
        init_path_state, path_step,
    )

    st = init_path_state(path, cfg, nb, dtype, device, staged=True)
    res = []
    for f in range(frames.shape[0]):
        act = None if active is None else active(f)
        st, o = path_step(path, p, st, frames[f], cfg, act, slots="staged",
                          attend_impl="plain" if plain else "kernel",
                          resync_every=R)
        res.append(torch.stack([o["p_now"], o["p_future"], o["vad"]])
                   .float())
    return torch.stack(res)


def phase_b_hybrid(cfg, params_np):
    """The hybrid paths at full width: float32 card vs CPU path (resync
    every 6 ticks, frozen ticks); resync frames on the card against the
    full-trunk oracles (hybrid: the full recompute; fast_hybrid: itself
    at resync_every=1); at B=4096 bf16 kernels vs plain versions with 7
    K2 launches per incremental tick and none on a resync tick."""
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    nb, nf = 3, 12
    p32 = {dev: params_to_torch(params_np, dev) for dev in ("cpu", "cuda")}
    resync = [f for f in range(nf) if (f + 1) % HYBRID_R == 0]
    for path, n, oracle in (("hybrid", cfg.frame_samples, "full"),
                            ("fast_hybrid", cfg.frame_shift, None)):
        frames = fast_inputs(cfg, nb, nf, 23, "cpu", torch.float32, n)
        outs = {}
        for dev in ("cpu", "cuda"):
            act = lambda f: torch.tensor([True, f % 2 == 0, f % 3 != 0],
                                         device=dev)
            outs[dev] = hybrid_steps(p32[dev], cfg, nb, frames.to(dev),
                                     torch.float32, dev, path, HYBRID_R,
                                     active=act).cpu()
        d = (outs["cuda"] - outs["cpu"]).abs().max().item()
        check(d <= 1e-4, f"f32 {path} card vs CPU path: max |d| {d:.3e}")
        if oracle:
            ref = slice4_steps(p32["cuda"], cfg, nb, frames.cuda(),
                               torch.float32, "cuda", oracle).cpu()
        else:
            ref = hybrid_steps(p32["cuda"], cfg, nb, frames.cuda(),
                               torch.float32, "cuda", path, 1).cpu()
        hyb = hybrid_steps(p32["cuda"], cfg, nb, frames.cuda(), torch.float32,
                           "cuda", path, HYBRID_R).cpu()
        d_or = (hyb[resync] - ref[resync]).abs().max().item()
        check(d_or <= 2e-5, f"{path} resync frames vs the oracle: {d_or:.3e}")
        print(f"[b] full width f32 {path}, B={nb}, {nf} frames, resync every "
              f"{HYBRID_R}: card vs CPU path max |d| {d:.3e} (atol 1e-4); "
              f"resync frames {resync} vs the "
              f"{'full recompute' if oracle else 'resync_every=1 oracle'} "
              f"on the card max |d| {d_or:.3e} (atol 2e-5)", flush=True)
    del p32

    p = params_to_torch(params_np, "cuda", torch.bfloat16)
    idx = torch.arange(B, device="cuda")
    act = lambda f: (idx + f) % 7 != 0
    for path, n in (("hybrid", cfg.frame_samples),
                    ("fast_hybrid", cfg.frame_shift)):
        frames = fast_inputs(cfg, B, nf, 24, "cuda", torch.bfloat16, n)
        zero_counts()
        got = hybrid_steps(p, cfg, B, frames, torch.bfloat16, "cuda", path,
                           HYBRID_R, active=act)
        torch.cuda.synchronize()
        launches = counts()
        want = dict(per_step("bf16"), attend=7 * (nf - len(resync)))
        check(launches == want, f"{path}: launches {launches}, expected "
                                f"{want}")
        plain = hybrid_steps(p, cfg, B, frames, torch.bfloat16, "cuda", path,
                             HYBRID_R, plain=True, active=act)
        check(counts() == want, f"{path}: the plain run launched a kernel")
        d = (got[:, 0] - plain[:, 0]).abs().max().item()
        check(torch.isfinite(got).all().item() and d <= 2e-2,
              f"bf16 {path} kernels vs plain: max |d p_now| {d:.3e}")
        print(f"[b] full width bf16 {path} (staged, K2), B={B}, {nf} frames, "
              f"resync every {HYBRID_R}: kernels vs plain max |d p_now| "
              f"{d:.3e} (atol 2e-2); {launches['attend']} K2 launches = 7 per "
              f"incremental tick, none on the {len(resync)} resync ticks",
              flush=True)
        del got, plain, frames
        torch.cuda.empty_cache()


def lab_bound(mode: str, es: int):
    """(ms, "bytes"/"operations"), bytes of one K11 launch at B, T: the
    phase plane (noout: its k halves) and q, kc, vc, age, out as the mode
    reads them, bf16 q (es: the cache element size)."""
    plane = B * T * 4 * D * es
    vec = B * 2 * D * 2
    nbytes = {"dma": plane + vec,
              "mxu": plane + 2 * vec,
              "noout": plane // 2 + 3 * vec + B * T * 4}.get(
                  mode, plane + 4 * vec + B * T * 4)
    return bound(nbytes, B * 2 * T * D * 5), nbytes


def phase_d_lab(gpu):
    """The lab tools on the card (their main paths): the attend lab over
    every ablated mode at 1 and 2 streams per block and the production
    variants, and the component bench over every stage, the launch
    counters zeroed just before and read just after; then K11's and
    K12's times beside their bounds, plain versions and (K12) torch.sum.
    Returns (K11's and K12's JSON fields, the tools' launches)."""
    from vap_realtime_tpu_torch.ops.cuda.attend_lab import attend_lab_plain
    from vap_realtime_tpu_torch.ops.cuda.lab import (
        cache_read_all, cache_read_all_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms
    from vap_realtime_tpu_torch.tools import attend_lab as lab_tool
    from vap_realtime_tpu_torch.tools import component_bench as bench_tool

    variants = [v + s for v in lab_tool.ABLATED for s in ("", "_s2")]
    variants += list(lab_tool.PRODUCTION) + ["bcast_b16", "bcast_b64"]
    zero_counts()                                    # main path: zero ...
    lab_ms = lab_tool.main(["--batch", str(B), "--T", str(T), "--variants",
                            ",".join(variants)])
    bench_ms = bench_tool.main(["--batch", str(B), "--stages", "all"])
    launches = counts()                              # ... and read
    check(launches["lab"] > 0 and launches["read"] > 0,
          f"the lab tools launched K11 {launches['lab']} and K12 "
          f"{launches['read']} times")
    print(f"[d] attend_lab tool, B={B} T={T}: {len(variants)} variants, "
          f"launches {launches['lab']} K11, {launches['attend']} K1/K4, "
          f"{launches['compact']} K10; component_bench, every stage: "
          f"{launches['read']} K12 | {gpu}", flush=True)

    modes = {}
    for base, mode in lab_tool.ABLATED.items():
        es = 1 if base.startswith("q8_") else 2
        (bound_ms, bound_by), nbytes = lab_bound(mode, es)
        ms1, ms2 = lab_ms[base] / P, lab_ms[base + "_s2"] / P
        modes[base] = dict(ms=ms1, ms_2_streams=ms2, bound_ms=bound_ms,
                           bound_by=bound_by)
        print(f"[d] attend_lab {base:14s} bf16{' int8 cache' if es == 1 else ''}"
              f", B={B} T={T}: {ms1:.4f} ms/launch (1 stream per block), "
              f"{ms2:.4f} (2 streams); bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e9:.3f} GB) = {100 * bound_ms / ms1:.1f}% / "
              f"{100 * bound_ms / ms2:.1f}% | {gpu}", flush=True)
    for name in list(lab_tool.PRODUCTION) + ["bcast_b16", "bcast_b64"]:
        print(f"[d] attend_lab {name:14s} (attend_pair): "
              f"{lab_ms[name] / P:.4f} ms/launch | {gpu}", flush=True)
    cache, cache_q8, q, age, _ = lab_tool.inputs(B, T, torch.device("cuda"))
    plain_ms = cuda_ms(lambda: attend_lab_plain("v5", cache, q, q, q, age, 1),
                       reps=5)
    head = dict(modes["v5"], plain_ms=plain_ms, library_ms=None,
                modes=modes)
    print(f"[d] attend_lab v5 plain {plain_ms:.4f} ms/launch; no single "
          f"PyTorch call computes an ablated body | {gpu}", flush=True)
    del cache_q8

    ms = cuda_ms(lambda: cache_read_all(cache), reps=20, warm=3)
    plain_ms = cuda_ms(lambda: cache_read_all_plain(cache), reps=5)
    library_ms = cuda_ms(lambda: torch.sum(cache, dim=(0, 1, 2),
                                           dtype=torch.float32), reps=20)
    nbytes = cache.numel() * 2 + 4 * D * 4
    bound_ms, bound_by = bound(nbytes, cache.numel())
    print(f"[d] cache_read (K12) bf16 ({B}, {P}, {T}, {4 * D}): {ms:.4f} "
          f"ms/launch = {nbytes / ms / 1e6:.0f} GB/s, bound {bound_ms:.4f} ms"
          f" ({bound_by}: {nbytes / 1e9:.3f} GB at 3.35 TB/s) = "
          f"{100 * bound_ms / ms:.1f}% of bound; plain {plain_ms:.4f} ms; "
          f"torch.sum(dtype=float32) {library_ms:.4f} ms; the component "
          f"bench's cacheread stage {bench_ms['cacheread']:.4f} ms, its hbm "
          f"r+w probe {bench_ms['hbm']:.4f} ms | {gpu}", flush=True)
    read = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
    del cache
    torch.cuda.empty_cache()
    return head, read, launches


def phase_d_hybrid(cfg, p_bf16, gpu) -> None:
    """The hybrid ticks at B=4096 bf16 (staged, K2): the incremental tick
    and the resync tick timed apart (host clock around synchronized
    ticks), the mean at resync_every=50, the realtime streams per card
    each allows, and the peak device memory of a resync."""
    from vap_realtime_tpu_torch.runtime.arena import (
        init_path_state, path_step,
    )

    period = 1e3 / cfg.frame_hz
    R = cfg.context_frames
    for path, n in (("hybrid", cfg.frame_samples),
                    ("fast_hybrid", cfg.frame_shift)):
        frames = fast_inputs(cfg, B, 4, 25, "cuda", torch.bfloat16, n)
        st = init_path_state(path, cfg, B, torch.bfloat16, "cuda",
                             staged=True)

        def ticks(mode, k):
            nonlocal st
            for f in range(k):
                st, _ = path_step(path, p_bf16, st, frames[f % 4], cfg,
                                  slots="staged", attend_impl="kernel",
                                  resync_mode=mode)

        ticks("never", 3)
        ticks("force", 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        ticks("force", 4)
        torch.cuda.synchronize()
        resync_ms = (time.time() - t) * 1e3 / 4
        peak = torch.cuda.max_memory_allocated() / 1e9
        t = time.time()
        ticks("never", 12)
        torch.cuda.synchronize()
        incr_ms = (time.time() - t) * 1e3 / 12
        mean_ms = ((R - 1) * incr_ms + resync_ms) / R
        print(f"[d] {path} bf16 staged K2, B={B}: incremental tick "
              f"{incr_ms:.3f} ms, resync tick {resync_ms:.3f} ms (peak device "
              f"memory {peak:.2f} GB), mean at resync_every={R} {mean_ms:.3f}"
              f" ms -> {B * period / mean_ms:.0f} realtime streams per card "
              f"amortised, {B * period / resync_ms:.0f} if the resync tick "
              f"must fit the {period:.0f} ms period | {gpu}", flush=True)
        del st, frames
        torch.cuda.empty_cache()


def phase_c(cfg, params_np, config="bf16"):
    """The native server on the card, with the arena of a configuration
    (CONFIGS): 8 loopback connections.  Returns the kernels' launches
    over the run."""
    from vap_realtime_tpu_torch.io import wire
    from vap_realtime_tpu_torch.runtime.arena import StreamArena
    from vap_realtime_tpu_torch.runtime.server_native import NativeVapServer
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    kw = CONFIGS[config]
    arena = StreamArena(cfg, params_np, capacity=SERVER_CAPACITY,
                        path=kw.get("path", "fast"), dtype=torch.bfloat16,
                        quant_cache=kw.get("quant", False),
                        conv_impl=kw.get("conv_impl", "conv"),
                        slots=kw.get("slots", "staged"),
                        attend_impl=kw.get("attend_impl", "kernel"),
                        resync_every=kw.get("resync_every"),
                        wire_dtype=np.int16, device="cuda")
    arena.warmup()
    step0 = arena.state.kv.step if hasattr(arena.state, "kv") else 0
    srv = NativeVapServer(arena, port=0, wire_int16=True)
    n_conn, hops = 8, 100                            # 1 s of audio each
    audios = [synthetic_audio(16000, seed=7 + i) for i in range(n_conn)]
    results = [[] for _ in range(n_conn)]

    def client(i):
        pcm = np.clip(audios[i] * 32768, -32768, 32767).astype("<i2")
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=20) as s:
            s.settimeout(20)

            def reader():
                buf = b""
                while len(results[i]) < hops // 5:
                    try:
                        part = s.recv(65536)
                    except socket.timeout:
                        return
                    if not part:
                        return
                    buf += part
                    while len(buf) >= 4:
                        ln = int.from_bytes(buf[:4], "little")
                        if len(buf) < 4 + ln:
                            break
                        results[i].append(
                            wire.deserialize_result(buf[4:4 + ln], "vap"))
                        buf = buf[4 + ln:]

            rd = threading.Thread(target=reader)
            rd.start()
            for h in range(hops):                    # realtime pacing
                pair = np.empty((160, 2), "<i2")
                pair[:, 0] = pcm[0, h * 160:(h + 1) * 160]
                pair[:, 1] = pcm[1, h * 160:(h + 1) * 160]
                s.sendall(pair.tobytes())
                time.sleep(0.01)
            rd.join(timeout=30)

    zero_counts()                                    # main path: zero ...
    ticker = threading.Thread(target=srv.serve_forever)
    ticker.start()
    clients = [threading.Thread(target=client, args=(i,))
               for i in range(n_conn)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
    finally:
        srv.stop()
        ticker.join(timeout=10)
    launches = counts()                              # ... and read
    check(not ticker.is_alive() and not any(c.is_alive() for c in clients),
          "server or client threads did not stop")
    ticks = srv.tick_stats["n"]
    # resync ticks of a hybrid arena: no attend launch
    R = kw.get("resync_every", 0)
    resyncs = sum(1 for g in range(step0, step0 + ticks)
                  if R and (g + 1) % R == 0)
    want = {k: v * ticks for k, v in per_step(config).items()}
    want["attend"] = per_step(config)["attend"] * (ticks - resyncs)
    check(launches == want and ticks > 0 and (resyncs > 0 or not R),
          f"{launches} launches over {ticks} server ticks, {resyncs} of "
          f"them resync ticks (expected {per_step(config)} per incremental "
          f"tick)")
    shift = cfg.frame_shift
    skipped = 0
    for i, res in enumerate(results):
        check(len(res) >= 15, f"connection {i}: {len(res)} results (< 15)")
        # each result echoes one of this connection's own frames, in
        # order (the ingest engine skips frames only when ticks fall
        # behind real time)
        frames_i = audios[i][0, :hops // 5 * shift].reshape(-1, shift)
        last = -1
        for j, r in enumerate(res):
            err = np.abs(frames_i - np.asarray(r["x1"])[None]).max(axis=1)
            f = int(err.argmin())
            check(err[f] <= 1.5 / 32768 and f > last,
                  f"connection {i} result {j}: echo matches frame {f} "
                  f"(|d| {err[f]:.2e}) after frame {last}")
            skipped += f - last - 1
            last = f
            pn = np.asarray(r["p_now"])
            check(pn.shape == (2,) and np.isfinite(pn).all()
                  and abs(pn.sum() - 1) < 2e-2,
                  f"connection {i} result {j}: p_now {pn}")
    print(f"[c] native server ({config}: {kw or 'bf16 cache'}), capacity "
          f"{SERVER_CAPACITY}, bf16, int16 wire: "
          f"{[len(r) for r in results]} results on {n_conn} connections "
          f"({skipped} frames skipped), {ticks} ticks"
          f"{f' ({resyncs} resync ticks)' if R else ''}, launches "
          f"{launches} = {per_step(config)} per "
          f"{'incremental ' if R else ''}tick", flush=True)
    return launches


def phase_e(cfg, params_np) -> None:
    """VapEngine(path="fast", conv_impl="fused") on the card: a few
    process_batch calls of 64 streams in bf16; each runs one K7 and 7 K2
    launches and gives finite probabilities."""
    from vap_realtime_tpu_torch.runtime.engine import VapEngine

    eng = VapEngine(cfg, params=params_np, path="fast", batch=64,
                    dtype=torch.bfloat16, conv_impl="fused", device="cuda")
    eng.warmup()
    rs = np.random.RandomState(13)
    zero_counts()
    n = 4
    for _ in range(n):
        out = eng.process_batch(
            (0.1 * rs.randn(64, 2, eng.chunk_samples)).astype(np.float32))
        pn = out["p_now"]
        check(pn.shape == (64, 2) and np.isfinite(pn).all()
              and (np.abs(pn.sum(-1) - 1) < 2e-2).all(),
              f"VapEngine p_now {pn[:2]}")
    got = counts()
    want = {k: v * n for k, v in per_step("fused").items()}
    check(got == want, f"VapEngine launches {got}, expected {want}")
    print(f"[c] VapEngine(path='fast', conv_impl='fused'), 64 streams, bf16: "
          f"{n} process_batch calls, launches {got}, p_now finite and "
          f"summing to 1", flush=True)


def phase_e_slice4(cfg, params_np) -> None:
    """VapEngine(path="full") on the card: a few process_batch calls of 64
    streams in bf16 (overlapped frames) with finite probabilities; and
    run_offline(path="full") on 2 s of synthetic audio, float32 on the
    card, equal to the CPU runner at atol 1e-4."""
    from vap_realtime_tpu_torch.runtime.engine import VapEngine
    from vap_realtime_tpu_torch.runtime.offline import run_offline
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    eng = VapEngine(cfg, params=params_np, path="full", batch=64,
                    dtype=torch.bfloat16, device="cuda")
    eng.warmup()
    check(eng.chunk_samples == cfg.frame_samples
          and eng.frame_contxt_padding == 320, "VapEngine(full) frame sizes")
    rs = np.random.RandomState(21)
    zero_counts()
    n = 4
    for _ in range(n):
        out = eng.process_batch(
            (0.1 * rs.randn(64, 2, eng.chunk_samples)).astype(np.float32))
        pn = out["p_now"]
        check(pn.shape == (64, 2) and np.isfinite(pn).all()
              and (np.abs(pn.sum(-1) - 1) < 2e-2).all(),
              f"VapEngine(full) p_now {pn[:2]}")
    got = counts()
    check(not any(got.values()), f"VapEngine(full) launched {got}: the full "
                                 f"path runs no kernel of the port")
    audio = synthetic_audio(16000 * 2, seed=22)
    outs = {dev: run_offline(params_np, audio, cfg, "full", device=dev)
            for dev in ("cuda", "cpu")}
    d = max(np.abs(outs["cuda"][k] - outs["cpu"][k]).max()
            for k in ("p_now", "p_future", "vad"))
    check(d <= 1e-4 and outs["cuda"]["p_now"].shape == (39, 2),
          f"run_offline(full) card vs CPU: max |d| {d:.3e}")
    print(f"[c] VapEngine(path='full'), 64 streams, bf16: {n} process_batch "
          f"calls, p_now finite and summing to 1; run_offline(path='full') "
          f"on 2 s of audio ({outs['cuda']['p_now'].shape[0]} frames), "
          f"float32 card vs CPU: max |d| {d:.3e} (atol 1e-4)", flush=True)


def phase_e_hybrid(cfg, params_np) -> None:
    """VapEngine(path="fast_hybrid") and run_offline(path="hybrid") on the
    card: a few process_batch calls of 64 streams in bf16 with a resync
    among them (finite probabilities, 7 K2 launches per incremental
    call); the offline runner on 3 s of synthetic audio (resyncs every 50
    frames), float32 card vs CPU at atol 1e-4."""
    from vap_realtime_tpu_torch.runtime.engine import VapEngine
    from vap_realtime_tpu_torch.runtime.offline import run_offline
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    eng = VapEngine(cfg, params=params_np, path="fast_hybrid", batch=64,
                    dtype=torch.bfloat16, resync_every=3, device="cuda")
    eng.warmup()
    rs = np.random.RandomState(26)
    zero_counts()
    n = 4
    for _ in range(n):
        out = eng.process_batch(
            (0.1 * rs.randn(64, 2, eng.chunk_samples)).astype(np.float32))
        pn = out["p_now"]
        check(pn.shape == (64, 2) and np.isfinite(pn).all()
              and (np.abs(pn.sum(-1) - 1) < 2e-2).all(),
              f"VapEngine(fast_hybrid) p_now {pn[:2]}")
    got = counts()
    want = dict(per_step("bf16"), attend=7 * (n - 1))  # call 3 resyncs
    check(got == want, f"VapEngine(fast_hybrid) launches {got}, expected "
                       f"{want}")
    audio = synthetic_audio(16000 * 3, seed=27)
    outs = {dev: run_offline(params_np, audio, cfg, "hybrid", device=dev)
            for dev in ("cuda", "cpu")}
    d = max(np.abs(outs["cuda"][k] - outs["cpu"][k]).max()
            for k in ("p_now", "p_future", "vad"))
    F = outs["cuda"]["p_now"].shape[0]
    check(d <= 1e-4 and F > cfg.context_frames,
          f"run_offline(hybrid) card vs CPU: max |d| {d:.3e}")
    print(f"[c] VapEngine(path='fast_hybrid', resync_every=3), 64 streams, "
          f"bf16: {n} process_batch calls (one resync), launches {got}; "
          f"run_offline(path='hybrid') on 3 s of audio ({F} frames, a "
          f"resync at frame {cfg.context_frames - 1}), float32 card vs CPU: "
          f"max |d| {d:.3e} (atol 1e-4)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vap_realtime_tpu_torch.config import VapConfig
    from vap_realtime_tpu_torch.profile_step import gpu_line
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    # float32 checks on the card need full float32 convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    print(f"[gpu] {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    build()
    err_main = phase_a()
    err_int8 = phase_a_int8()
    err_norm = phase_a_norm()
    err_fused = phase_a_fused()
    err_compact = phase_a_compact()
    err_lstm = phase_a_lstm()
    err_single = phase_a_single()
    err_tail = phase_a_tail()
    err_lab = phase_a_lab()
    err_read = phase_a_read()
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    params_np = synthetic_params(cfg.frame_hz)
    p_bf16, frames = phase_b(cfg, params_np)
    p4, frames4 = phase_b_slice4(cfg, params_np)
    phase_b_hybrid(cfg, params_np)
    bodies, norm, compact, fused, lstm = phase_d(cfg, p_bf16, frames, gpu)
    single, tail = phase_d_slice4(cfg, p4, frames4, gpu)
    phase_d_hybrid(cfg, p4, gpu)
    del p_bf16, frames, p4, frames4
    torch.cuda.empty_cache()
    lab, read, run_lab = phase_d_lab(gpu)
    run_bf16 = phase_c(cfg, params_np, "bf16")
    run_q8g = phase_c(cfg, params_np, "q8g_normk")
    run_fused = phase_c(cfg, params_np, "fused_compact")
    run_kv = phase_c(cfg, params_np, "kv")
    run_hybrid = phase_c(cfg, params_np, "fast_hybrid")
    phase_e(cfg, params_np)
    phase_e_slice4(cfg, params_np)
    phase_e_hybrid(cfg, params_np)

    print(gpu, flush=True)
    src = "vap_realtime_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        dict(name="attend_pair", route="cuda", source=src + "attend_pair.cu",
             replaces="vap_realtime_tpu/ops/pallas/attend.py:454",
             launches=run_bf16["attend"] + run_q8g["attend"]
             + run_kv["attend"] + run_hybrid["attend"],
             max_abs_err=max(err_main, err_int8),
             **bodies["K2 bf16 staged"], bodies=bodies),
        dict(name="channel_norm_relu", route="cuda",
             source=src + "channel_norm_relu.cu",
             replaces="vap_realtime_tpu/ops/pallas/channorm.py:43",
             launches=run_q8g["norm"], max_abs_err=err_norm, **norm),
        dict(name="attend_compact", route="cuda",
             source=src + "attend_pair.cu",
             replaces="vap_realtime_tpu/ops/pallas/attend.py:282",
             launches=run_fused["compact"], max_abs_err=err_compact,
             **compact["K10 bf16 ring"], bodies=compact),
        dict(name="conv_stack_fused", route="cuda",
             source=src + "conv_stack_fused.cu",
             replaces="vap_realtime_tpu/ops/pallas/encoder.py:291",
             launches=run_fused["fused"], max_abs_err=err_fused, **fused),
        # off the serving path, as in the JAX package: 0 launches there
        dict(name="lstm_scan", route="cuda", source=src + "lstm_scan.cu",
             replaces="vap_realtime_tpu/ops/pallas/lstm.py:48",
             launches=run_fused["lstm"], max_abs_err=err_lstm, **lstm),
        # K8 and K9: off the serving paths, as in the JAX package; their
        # launches are read over the kv server run (the slice's path): 0
        dict(name="fused_attend", route="cuda", source=src + "attend_pair.cu",
             replaces="vap_realtime_tpu/ops/pallas/attend.py:396",
             launches=run_kv["single"], max_abs_err=err_single, **single),
        dict(name="cpc_conv_tail", route="cuda",
             source=src + "cpc_conv_tail.cu",
             replaces="vap_realtime_tpu/ops/pallas/cpc_conv.py:108",
             launches=run_kv["tail"], max_abs_err=err_tail, **tail),
        # K11 and K12: the lab tools' kernels, launched over their runs
        dict(name="attend_lab", route="cuda", source=src + "attend_lab.cu",
             replaces="tools/attend_lab.py:304", launches=run_lab["lab"],
             max_abs_err=err_lab, **lab),
        dict(name="cache_read", route="cuda", source=src + "cache_read.cu",
             replaces="tools/component_bench.py:393",
             launches=run_lab["read"], max_abs_err=err_read, **read),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
