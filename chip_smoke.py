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
         - conv_stack_fused (K7) on 8192 channel-streams x 800 samples
           and beside it a ragged 8195 and 5 streams, L = 320 (both
           dtypes) and L = 1600 (bf16; the float32 body's shared memory
           refuses it), three frames, each carrying its own state: float32
           at atol 1e-4 (TF32 off); bf16 within four bf16 steps, |d| <=
           2^-6 (1 + |plain|) (both accumulate in float32 in other orders,
           and a value moved across a rounding boundary travels on through
           the later layers); the new carries too (c0 bit-equal);
         - the compact attend (K10) at B=4096 and 64, all 7 phases, ring
           rows: float32 (atol 1e-4), bf16, int8 with row scales and
           int8 codes under the frozen-scale fold (atol/rtol 2e-2 in float
           units), mixed live/DEAD and all-DEAD (output == v_cur); and
           K10's int8 body (both modes) at a ragged B = 4097 and 3, at
           T = 500 (B = 256: chunks of up to 52 rows through the ring;
           mixed and all-DEAD) and with float32 q (B = 4096, 4097;
           T = 500) at atol 1e-4 in float units;
         - lstm_scan (K5), both bodies through their launch functions
           (the serving body: 64 streams a block; the sequence body: 16
           streams a thread-block cluster, of 8 and of 16 blocks, each
           held): at (8192, 5, 256) and (100,
           5, 256) (a partial block, a ragged cluster): float32 at atol
           1e-5, bf16 outputs within one bf16 step (rtol 2^-7, atol
           1e-5); lstm_scan keeps the serving body at (8192, 5); and,
           float32 at atol 1e-4 over all steps, at the training
           encoder's shape, (16, 1998, 256) (the gates of 8 stereo 20 s
           clips' conv features, zero state), at a ragged (20, 1998, 256)
           (12 masked rows), at (16, 5, 256) and at (1024, 200, 256)
           (random gates; lstm_scan takes clusters of 8 blocks there),
           where lstm_scan takes the sequence body; the max |d| printed;
         - lstm_serve (the serving LSTM, bf16, `phase_a_serve`) at the
           serving cells' (rows, steps), (83,968, 20), (51,200, 5),
           (40,960, 5), (28,672, 5), and ragged (200, 20), (129, 5), (5,
           5): one launch a call, |kernel - plain| <= 2^-7 |plain| + 2^-8,
           and each one's distance to the float64 run printed; its ms a
           launch beside the bf16 operation bound, the plain version,
           ops.basic.lstm and torch.nn.LSTM (`time_serve`, in (d)); one
           fast_step tick of the nod 5 Hz and vap 20 Hz cells launches it
           once and drops the plain LSTM's per-step GEMMs
           (`phase_serve_tick`, after the 5 Hz tick);
         - fused_attend (K8, one k/v slot pair) at B=4096 and 64, T=50,
           all 14 slot pairs, float32 (atol 1e-4) and bf16 (atol/rtol
           2e-2), mixed live/DEAD and all-DEAD (output == v_cur), against
           its v4 plain form and the einsum reference; an int8 cache
           raises;
         - cpc_conv_tail (K9) at 8192 channel-streams x L0 = 224 (20 Hz),
           float32 (atol 1e-4, TF32 off) and bf16 x0 (one bf16 step of the
           output, |d| <= 2^-7 (1 + |plain|)), 67 x 224 (a ragged last
           tile), 64 x L0 = 384 and 128, and 4 x 1200 (row chunks);
         - attend_lab (K11) in every ablated mode at 1 and 2 streams per
           block, B=4096 and 64, T=50: float32 caches at atol = rtol 1e-4,
           bf16 caches and int8 codes (dma, q8glb) with bf16 q at 2e-2
           (bf16exp at 2e-2 in any dtype: it rounds to bf16 by design);
         - cache_read (K12) over the whole cache at B=4096 and 64, float32
           / bf16 / int8: |d| <= 1e-5 x the column's sum |x|, and two
           launches bit-equal (no atomics);
         - stage_merge (the staged ring's merge, one launch) bit-equal to
           its plain version (ring, stamps, row scales as bytes; the
           stage left empty): bf16, float32, int8 with frozen scales and
           with row scales, B = 4096 and 4097, T = 50 and 200, random
           payload bytes, a quarter of the staged rows invalid, stamps
           wrapped round the ring.
  (b)    The full-width fast step (vap, 20 Hz, 2.5 s context, synthetic
         weights) in seven configurations: staged slots with the bf16
         cache, the int8 cache with frozen scales (quant="global") and
         with row scales (quant="row"), conv_impl="normk" and
         conv_impl="fused"; "compact": slots="stream" with
         attend_impl="kernel3"; and "compact_q8g": the same on the int8
         cache with frozen scales (K10's int8 body, 7 launches a step).
         Each on a small input in float32 on the card equals the CPU path
         (which the CPU tests hold against the JAX package) at atol 1e-4;
         each at B=4096 bf16 over 17 frames
         with the kernels equals the same step with the plain versions
         (p_now atol 2e-2), and the launch counters rise by exactly 7
         attend launches per step (K1-K4, or K10 for the compact ones), 5
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
         and power limit: each kernel body's ms per launch and its bound
         (the attend bodies with their achieved GB/s; K10's also with the
         kernel's own device time from the profiler, without the
         wrapper's host time),
         its plain version, one PyTorch call over the same problem as a
         yardstick where one exists (scaled_dot_product_attention on the
         dequantised bf16 rows, torch.nn.LSTM on cuDNN; the port never
         calls them; K7 has none, so the `conv` and `normk` stacks' times
         stand beside it, with its float32 body's time, the device time of
         each of the bf16 body's five launches, its L2 weight bytes per
         call and the fused fast step's time in the same call; K8 against
         scaled_dot_product_attention; K9 against the cuDNN conv1-4 +
         ChannelNorm tail of cpc_conv_stack; K5 and K9, which take their
         float32 products as 3xTF32 on the tensor cores,
         beside both floors: three TF32 passes at 495 TFLOP/s (their
         bound) and float32 on the CUDA cores at 67 TFLOP/s; K5 and
         lstm_fused in bf16 and float32 against torch.nn.LSTM in the same
         dtype), and the
         ms/step at B=4096 of the fast step in seven configurations and of
         the kv and full steps; the hybrid paths' incremental and resync
         ticks at B=4096; and the lab tools (the slice-5 path): the attend
         lab (vap_realtime_tpu_torch.tools.attend_lab) over every ablated
         mode at 1 and 2 streams per block and the production variants,
         and the component bench over every stage, with the launch
         counters zeroed just before and read just after; K11's and K12's
         ms per launch beside their bounds, plain versions and (K12)
         torch.sum; the stage merge's device time at the open cells'
         shapes (20480 x T = 50 and 14336 x T = 200 streams, bf16, every
         row valid) beside its byte floor and the plain version's time.
  (k7)   K7 at the 20 Hz and the 5 Hz frame (800 and 3,200 fresh
         samples) on 8192 channel-streams, bf16, three frames carrying
         state: against the plain version (|d| <= 2^-6 (1 + |plain|)),
         the 5 Hz frame bit-equal to four 800-sample calls in a row and
         counted as four body calls and 8192 x 3200 samples a frame; ms
         a frame beside the operation bound; the 20 Hz frame's digest of
         z and the carries (the parent commit's build prints the same when
         the 800-sample body is unchanged).  Then one tick of the nod
         5 Hz / 10 s configuration through the benchmark's serving call
         (64 streams, bf16): finite, 4 K7 body calls and 7 K2 launches,
         its fields within the cell's limit of the float64 reference.
  (k7bits) K7's bf16 body at (8192, 800), (8192, 1600), (83968, 3200
         in four body calls) and a ragged (8195, 800), three frames
         carrying state: the new carries c0 and c1 bit-equal to those of
         the body that stored conv1's input X1 (K7_X1_C01: their digest;
         z and c2-c4 move by conv1's summation order, held to the plain
         version in (a) and (k7)), and each launch's device time,
         conv0_kernel and the four conv_layer_kernel apart.
         `python3 chip_smoke.py --k7-digests [check] [save=DIR] [ref=DIR]`
         runs only this; with save= in one build's run and ref= in
         another's, each output's max |d| between the two builds.
  (upload) The arena's fenced upload (`python3 chip_smoke.py --upload
         [save=DIR] [ref=DIR] [trace]` runs only this): the benchmark's
         serving call on the three serving configurations (nod 5 Hz,
         vap 20 Hz, nod 20 Hz) at 8192 streams, 64 ticks in the open
         loop's pattern (dispatch, collect) and then 64 in the closed
         loop's (dispatch tick k, then collect k - 1), fresh seeded frames
         every tick, 16 merge ticks: a digest of every served field of
         every stream each tick, and 64 streams' fields.  With save= the
         digests and fields are written there; with ref= (another
         build's, e.g. the parent commit's, saved the same way) every
         tick's digests must be equal.  Where the arena counts upload
         pieces, 4 a 5 Hz tick and 1 a 20 Hz tick.  With trace, a
         torch.profiler stretch of 3 ticks at the nod 5 Hz cell's 41,984
         streams: each tick's frame pieces cross PCIe at >= 40 GB/s and
         each later piece's copy overlaps K7's body calls before its own
         (at that size pieces 1-3 all cross under body call 0).
  (sync) Warm ticks of the benchmark's serving call (64 streams, bf16) on
         the three serving configurations (vap 20 Hz / 2.5 s, nod 20 Hz
         and 5 Hz / 10 s) past a merge tick, each `step_device_batch`
         under `torch.cuda.set_sync_debug_mode("error")`: none blocks the
         host, and no bin-sum table is built; first the mode is shown to
         raise on a table built from host memory.  Then ticks whose
         probability fields are computed twice, with the cached tables and
         with a table built on every call: bit-equal.
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
         each run and read just after; stage_merge launches once on each
         merge tick of the staged arenas (1 tick in 8, none on a resync
         tick) and on no other tick.  Then VapEngine(path="fast",
         conv_impl="fused"), VapEngine(path="full") and
         VapEngine(path="fast_hybrid") take a few process_batch calls on the
         card, and run_offline(path="full" and "hybrid") on synthetic audio
         equals the CPU.
  (f)    The serving surfaces (model vap, 20 Hz, 2.5 s context, synthetic
         weights, float32 unless stated; the launch counters zeroed just
         before each run and read just after, 7 K2 launches a frame):
         the synthetic weights saved as the reference's .pt checkpoints
         load bit-equal to convert_state_dict, and VapEngine(vap_model=,
         cpc_model=) on the card equals the CPU over 12 frames (atol
         1e-4); the two-port VapServer over loopback (one producer of
         float64 hops, one consumer), kv against VapEngine on the CPU
         over the same zero-padded frames (atol 1e-4) and fast bf16
         against its plain-attend twin on the card (2e-2);
         BatchedVapServer (capacity 64, kv) with 8 lockstep connections
         of 1 s each against a CPU StreamArena stepped on the same chunks
         (atol 1e-4), and a capacity-4 arena that rejects a fifth
         connection; api.Vap on two Wav sources, card vs CPU over 10
         results (atol 1e-4), its worker joined; static_step card vs CPU
         over 10 carried frames (atol 1e-4), and its torch.export on the
         card, saved and loaded, against the eager step (atol 1e-5).  The
         ms per frame of the server engine, the batched tick,
         Vap.process_vap, the static step and the exported step print
         beside the card's name and power limit.
  (g)    The training path at VapConfig() (dim 256, 1 channel + 3 stereo
         layers, 4 heads, 20 Hz; synthetic weights; float32, TF32 off;
         cuDNN deterministic for the resume check): encode_sequence on a
         (16, 320000) waveform card vs CPU (atol 1e-4); one train_step at
         batch 2 x 20 s card vs CPU (the loss at 1e-5 relative, the
         trainable leaves at 1e-6 where the CPU's gradient is at least
         1e-6 and everywhere when the card's AdamW takes the CPU's
         gradients, the frozen encoder leaves bit-equal); fit on a
         16-row x 20 s synthetic manifest, batch 8, 2 epochs with
         validation, events and checkpoints (a VAD that gives shift, hold
         and backchannel events), a resume from last.npz after 1 epoch
         against the uninterrupted run (atol 1e-5), the best checkpoint
         through run_evaluation on the card and on the CPU (the 19
         metrics of score.csv within 1e-5 relative); the ms per train
         step and eval forward at batch 8 x 20 s, seconds of stereo audio
         trained per second, peak memory; the train step split (CUDA
         events: conv stack, gi projection, K5, the rest of the forward,
         backward, AdamW); K5 launched once per forward, all on the
         sequence body (counted from 0 over the phase); then both bodies
         timed at (16, 1998, 256) on the same inputs (the sequence body
         must be the faster) beside the bound, the plain version and
         torch.nn.LSTM (cuDNN), in microseconds a step with the cluster
         size.  (The crossover grid that set lstm_scan's choice of body
         is tools/lstm_bodies.py's.)

  (h)    Run first after the build, while this process holds little of
         the card. The serving tools under load and a client (model vap,
         20 Hz, 2.5 s context, synthetic weights; the host's nproc printed):
         (i) tools/hbm_budget against the card's total memory; (ii)
         tools/serving_bench: the native server (fast path, staged slots,
         the attend kernel, bf16, int16 wire) under the native load
         generator at 1024 and 4096 streams for 10 s each, with the bf16
         cache (K2), the int8 cache with frozen scales (K3) and the host
         stub (no card, no launch): results/s, CPU seconds,
         p50/p90/p99 frame latency, the server's dispatch / fetch / send ms
         per tick, sustained_streams; every connection accepted, results
         on every run, 7 attend launches a tick (counters zeroed just
         before and read just after each bench); (iii)
         tools/capacity_probe, each in its own process, for the fast bf16
         and q8g caches at 0.25x, 0.5x and 0.9x of the staged capacity (i)
         predicts (whole 4096-stream encoder sub-batches), 5 ticks: fit,
         ms per step, peak memory (a 0.25x probe must fit; a larger one
         that does not is a finding); (iv) the wav client into a VapServer
         on a CUDA VapEngine(path="kv") with the console client reading
         the framed results in its own process: every frame's result,
         finite, 7 K2 launches a frame.  Each sub-phase's seconds print.
  (i)    After (g), the labs and the export and checkpoint tools (each
         time beside the card's name and power limit; each sub-phase's
         seconds print): (1) tools/encoder_lab at 8192 channel-streams x
         800 samples (20 Hz), bf16, all four impls (conv, normk, blocked,
         fused): ms per step, finite; K6 launched 5 times a step under
         normk and K7 once a step under fused (counters zeroed just
         before and read just after); (2) tools/roofline at B=4096, bf16:
         the measured 4096^3 matmul peak, and the conv encoder's, the
         LSTM's and the kv step's ms, TFLOP/s, % of peak (over 105%
         raises) and GB/s; (3) tools/scatter_lab at 4096 / 50 / 8: the
         five write forms' ms per frame; (4) float32, TF32 off: the static
         (99 frames) and --dynamic (T = 8 and 24 from one program)
         exports, saved and loaded, against the eager step on the card
         (1e-5) and on the CPU (1e-4); tools/vap_offline_exported over a
         3 s synthetic wav against runtime/offline.py on the card (the
         time column equal, the last frames at 2e-5); tools/export_web
         on the card against the CPU (weights.bin byte-equal, the fixture
         at 1e-5); tools/convert_checkpoint on synthetic .pt files.

The last lines: the card's name and power limit, one JSON line listing
each kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import json
import re
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
TF32_FLOP_PER_S = 495e12           # H100 SXM, dense TF32 tensor cores
BF16_TOL = 2e-2                    # attend, bf16: atol and rtol
CODE_SCALE = 3.0 / 127             # int8 scale of rows with max-abs ~3
L_NEW = 800                        # fresh samples per frame at 20 Hz
# the step's configurations: quant / conv_impl for init_fast_state and
# fast_step; slots (default "staged") and attend_impl (default "kernel")
CONFIGS = {"bf16": {}, "q8g": dict(quant="global"), "q8": dict(quant="row"),
           "normk": dict(conv_impl="normk"), "fused": dict(conv_impl="fused"),
           "compact": dict(slots="stream", attend_impl="kernel3"),
           "compact_q8g": dict(quant="global", slots="stream",
                               attend_impl="kernel3")}
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
            "lstm_seq": (lstm_scan, "sequence_launches"),
            "lstm_srv": (lstm_scan, "serving_launches"),
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
            "fused": 1 if conv == "fused" else 0, "lstm": 0, "lstm_seq": 0,
            "lstm_srv": 0, "single": 0, "tail": 0, "lab": 0, "read": 0}


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


def _ages(g, case: str, nb: int, Tn: int = T):
    """Ring (nb, Tn) and stage (S, nb) ages: live in [1, Tn+S), about a
    third DEAD ("mixed") or all DEAD ("dead")."""
    from vap_realtime_tpu_torch.ops.cuda.attend import DEAD

    dev = "cuda"
    age = torch.randint(1, Tn + S, (nb, Tn), generator=g, device=dev).float()
    sage = torch.randint(1, Tn + S, (S, nb), generator=g, device=dev).float()
    if case == "dead":
        age.fill_(DEAD)
        sage.fill_(DEAD)
    else:
        age[torch.rand(nb, Tn, generator=g, device=dev) < 0.35] = DEAD
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


def attend_inputs_int8(case: str, seed: int, nb: int = B, Tn: int = T,
                       dtype=torch.bfloat16):
    """Serving-shaped int8 attend inputs made on the card from a seed:
    int8 codes, q / k_cur / v_cur in float units (bf16 by default), row
    scales CODE_SCALE x [0.5, 1.5) of the ring (nb, P, Tn) and the stage
    (S, nb, P)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    codes = lambda *s: torch.randint(-127, 128, s, generator=g,
                                     device=dev).to(torch.int8)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    cache, stage = codes(nb, P, Tn, 4 * D), codes(S, nb, P * 4 * D)
    q2, kc2, vc2 = rn(nb, 2, D), rn(nb, 2, D), rn(nb, 2, D)
    sc = CODE_SCALE * (0.5 + torch.rand(nb, P, Tn, generator=g, device=dev))
    ssc = CODE_SCALE * (0.5 + torch.rand(S, nb, P, generator=g, device=dev))
    age, sage = _ages(g, case, nb, Tn)
    return cache, q2, kc2, vc2, age, sage, stage, sc, ssc


def fold_global(q2, kc2, vc2):
    """The quant="global" fold of `cache_format.attend` with one frozen scale
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


def fused_inputs(seed: int, dtype, N: int = 2 * B, L: int = L_NEW):
    """K7 inputs on the card: N channel-streams, three frames of L fresh
    samples, random carries (post-ReLU-like rows), and the synthetic
    encoder's packed weights in `dtype`."""
    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        TAIL_KS, pack_fused_params,
    )
    from vap_realtime_tpu_torch.weights.convert import params_to_torch
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    enc = params_to_torch(synthetic_params(20)["encoder"], "cuda", dtype)
    carries = tuple(rn(N, k - s, C).abs().to(dtype) for k, s in TAIL_KS)
    news = [(0.1 * rn(N, L)).to(dtype) for _ in range(3)]
    return (0.1 * rn(N, 5)).to(dtype), news, carries, \
        pack_fused_params(enc, dtype), enc


# K7's cases in (a): (channel-streams, samples per frame) per dtype; 2B + 3
# and 5 are ragged against the bf16 body's 128-row tiles, L = 1600 runs in
# bf16 only (the float32 body's shared memory refuses it)
FUSED_CASES = {torch.float32: [(2 * B, 800), (2 * B + 3, 800), (5, 800),
                               (2 * B, 320), (5, 320)],
               torch.bfloat16: [(2 * B, 800), (2 * B + 3, 800), (5, 800),
                                (2 * B, 320), (5, 320), (2 * B, 1600),
                                (2 * B + 3, 1600)]}


def phase_a_fused() -> float:
    """conv_stack_fused (K7) vs plain over FUSED_CASES, three frames each
    carrying its own state; returns the max abs error in bf16."""
    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        conv_stack_fused, conv_stack_fused_plain,
    )

    worst = 0.0
    for dtype, cases in FUSED_CASES.items():
        for N, L in cases:
            c0, news, carries, packed, _ = fused_inputs(8, dtype, N, L)
            st_k = st_p = (c0, *carries)
            err = 0.0
            for f, new in enumerate(news):
                zk, st_k = conv_stack_fused(st_k[0], new, st_k[1:], *packed)
                zp, st_p = conv_stack_fused_plain(st_p[0], new, st_p[1:],
                                                  *packed)
                torch.cuda.synchronize()
                what = f"{dtype} N={N} L={L} frame {f}"
                check(zk.dtype == dtype and zk.shape == (N, L // 160, C)
                      and torch.isfinite(zk).all().item(),
                      f"conv_stack_fused output {what}")
                check(torch.equal(st_k[0], st_p[0]),
                      f"conv_stack_fused carry c0 {what}")
                for name, got, want in [("z", zk, zp)] + [
                        (f"c{i}", a, b) for i, (a, b) in
                        enumerate(zip(st_k[1:], st_p[1:]), start=1)]:
                    d = (got.float() - want.float()).abs()
                    tol = (1e-4 if dtype == torch.float32
                           else 2 ** -6 * (1 + want.float().abs()))
                    check(bool((d <= tol).all()),
                          f"conv_stack_fused vs plain {what} {name}: max "
                          f"|d| {d.max().item():.3e}")
                    err = max(err, d.max().item())
            print(f"[a] conv_stack_fused {str(dtype)[6:]} ({N} x {L}), 3 "
                  f"frames: max |kernel - plain| over z and carries "
                  f"{err:.3e} (" + ("atol 1e-4" if dtype == torch.float32
                                    else "|d| <= 2^-6 (1 + |plain|)") + ")",
                  flush=True)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            del news, carries, st_k, st_p, zk, zp
            torch.cuda.empty_cache()
    return worst


def phase_a_compact() -> dict:
    """The compact attend (K10) vs plain at the serving shapes, ring rows:
    float32, bf16, int8 row scales, int8 under the frozen-scale fold;
    returns the max abs error of each body (float units)."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )

    worst = {}
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
            worst[body] = max(worst.get(body, 0.0), err)
            del cache
    torch.cuda.empty_cache()
    return worst


# K10's int8 body beyond the serving shapes: (streams, rows, q dtype,
# ages) -- ragged B (no multiple of the persistent grid, 2 blocks on each
# of the 132 SMs, nor of the 2 a block's ring holds), T = 500 (a plane of
# 500 KB: 10 chunks of up to 52 rows through the ring; 0.9 GB of int8
# cache at B = 256), float32 q
Q8_CASES = ((4097, T, torch.bfloat16, "mixed"),
            (3, T, torch.bfloat16, "mixed"),
            (256, 500, torch.bfloat16, "mixed"),
            (256, 500, torch.bfloat16, "dead"),
            (B, T, torch.float32, "mixed"), (4097, T, torch.float32, "mixed"),
            (256, 500, torch.float32, "mixed"))


def phase_a_compact_q8() -> float:
    """K10's int8 body (row scales and the frozen-scale fold) vs plain on
    Q8_CASES, all 7 phases: bf16 q at atol/rtol BF16_TOL, float32 q at
    atol 1e-4, in float units; all-DEAD rows give v_cur exactly.  Returns
    the max abs error (float units)."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )

    worst = 0.0
    for i, (nb, Tn, dt, case) in enumerate(Q8_CASES):
        cache, q2, kc2, vc2, age, _, _, sc, _ = attend_inputs_int8(
            case, 20 + i, nb, Tn, dt)
        name = "bf16" if dt == torch.bfloat16 else "float32"
        for mode in ("row", "global"):
            err = 0.0
            for ph in range(P):
                kw = dict(pair_base=2 * ph, num_heads=H, impl="compact")
                args, unit = (cache, q2, kc2, vc2, age), 1.0
                if mode == "row":
                    kw["scale"] = sc[:, ph]
                else:
                    args, unit = (cache, *fold_global(q2, kc2, vc2),
                                  age), CODE_SCALE
                got = attend_pair(*args, **kw)
                want = attend_pair_plain(*args, **kw)
                what = (f"compact int8 {mode} {name} q B={nb} T={Tn} {case} "
                        f"phase {ph}")
                if dt == torch.float32:
                    torch.cuda.synchronize()
                    d = (got - want).abs().max().item() * unit
                    check(d <= 1e-4 and torch.isfinite(got).all().item(),
                          f"{what}: max |d| {d:.3e}")
                else:
                    d = _compare(got, want, unit, what)
                if case == "dead":
                    check(torch.equal(got, args[3]),
                          f"{what}: all-DEAD rows must give v_cur")
                err = max(err, d)
            print(f"[a] attend_pair compact (K10) int8 {mode}, {name} q, "
                  f"B={nb} T={Tn} {case:5s} 7 phases: max |kernel - plain| "
                  f"{err:.3e} (float units; " + (
                      "atol 1e-4" if dt == torch.float32 else
                      f"atol {BF16_TOL:g}, rtol {BF16_TOL:g}") + ")",
                  flush=True)
            worst = max(worst, err)
        del cache
        torch.cuda.empty_cache()
    return worst


def lstm_inputs(seed: int, dtype, N: int = 2 * B):
    """(N, 5, 256) LSTM scan inputs on the card (N = 8192 by default):
    gates, h0, c0 in `dtype`; W_hh^T (256, 1024) and b_hh in float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    Hh = C
    return ((0.5 * rn(N, 5, 4 * Hh)).to(dtype), (0.1 * rn(N, Hh)).to(dtype),
            (0.1 * rn(N, Hh)).to(dtype), rn(Hh, 4 * Hh) / Hh ** 0.5,
            0.06 * rn(4 * Hh))


def lstm_pick(N: int) -> str:
    """The launcher lstm_scan takes at N streams on this card."""
    from vap_realtime_tpu_torch.ops.cuda import lstm as k5

    at_once = k5._at_once(torch.device("cuda", torch.cuda.current_device()))
    if k5._body(N, at_once) == "serving":
        return "serving"
    return f"sequence {k5._cluster(N, at_once)}"


def phase_a_lstm() -> dict:
    """lstm_scan (K5) vs plain at (8192, 5, 256) and (100, 5, 256) (a
    partial block of 64 streams, a ragged last cluster of 16), both
    bodies, the sequence body at both cluster sizes (lstm_scan takes the
    serving body at 8192, the sequence body at 100); returns the serving
    body's max abs error at 8192, {dtype name: err}."""
    from vap_realtime_tpu_torch.ops.cuda.lstm import lstm_scan_plain
    from vap_realtime_tpu_torch.tools.lstm_bodies import launchers

    worst = {}
    for N, dtype in itertools.product((2 * B, 100),
                                      (torch.float32, torch.bfloat16)):
        args = lstm_inputs(11, dtype, N)
        want = lstm_scan_plain(*args)
        for body, run in launchers().items():
            got = run(*args)
            torch.cuda.synchronize()
            err = 0.0
            for name, a, b in zip(("ys", "h_T", "c_T"), got, want):
                check(a.dtype == dtype and a.shape == b.shape
                      and torch.isfinite(a).all().item(),
                      f"lstm_scan {body} {name} {dtype}")
                d = (a.float() - b.float()).abs()
                tol = (1e-5 if dtype == torch.float32
                       else 2 ** -7 * b.float().abs() + 1e-5)
                check(bool((d <= tol).all()), f"lstm_scan {body} vs plain "
                      f"{dtype} {name}: max |d| {d.max().item():.3e}")
                err = max(err, d.max().item())
            print(f"[a] lstm_scan {body} body {str(dtype)[6:]} ({N}, 5, {C})"
                  f"{' (lstm_scan takes it)' * (lstm_pick(N) == body)}"
                  f": max |kernel - plain| {err:.3e} ("
                  + ("atol 1e-5" if dtype == torch.float32 else
                     "rtol 2^-7, atol 1e-5") + ")", flush=True)
            if N == 2 * B and body == "serving":
                worst[str(dtype)[6:]] = err
    check(lstm_pick(2 * B) == "serving", "lstm_scan left the serving body "
          f"at the serving shape ({2 * B}, 5)")
    return worst


# the serving LSTM's (rows, steps) in the serving cells: nod5 open (2 x
# 41,984 streams, 20 steps), vap sat (2 x 25,600, 5), vap open (2 x
# 20,480), nod open (2 x 14,336)
SERVE_SHAPES = ((83968, 20), (51200, 5), (40960, 5), (28672, 5))
# ragged shapes beside them: rows past the last 128-row tile
SERVE_RAGGED = ((200, 20), (129, 5), (5, 5))


def serve_inputs(seed: int, N: int, Tn: int):
    """Serving-LSTM inputs on the card, bf16: x (N, Tn, 256) >= 0 like
    K7's ReLU'd rows (|N(0, 1)|), h0 and c0 a running stream's state (0.3
    and 0.5 N(0, 1)), weights and biases U(+-1/16) (PyTorch's LSTM init
    at H = 256)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = lambda *s: (2 * torch.rand(*s, generator=g, device="cuda") - 1) / 16
    bf = torch.bfloat16
    return (rn(N, Tn, C).abs().to(bf), (0.3 * rn(N, C)).to(bf),
            (0.5 * rn(N, C)).to(bf), u(4 * C, C).to(bf), u(4 * C, C).to(bf),
            u(4 * C).to(bf), u(4 * C).to(bf))


def phase_a_serve() -> dict:
    """lstm_serve (the serving LSTM kernel) against lstm_serve_plain on the
    card in bf16 at the serving cells' shapes and ragged ones: one launch
    a call; |kernel - plain| <= 2^-7 |plain| + 2^-8 (the kernel's gate
    functions are tanh.approx, ~2^-11 relative, and its sums run in
    another order, so a bf16 rounding of h can land one ulp (2^-8
    relative) apart and carry through the recurrence); beside it each
    one's distance to the float64 run of the same function (the plain
    version with a float64 state: nothing rounded).  Returns {shape:
    {err, kernel_vs_f64, plain_vs_f64}}."""
    from vap_realtime_tpu_torch.ops.cuda.lstm import (
        lstm_serve, lstm_serve_plain,
    )

    out = {}
    for N, Tn in SERVE_RAGGED + SERVE_SHAPES:
        args = serve_inputs(25, N, Tn)
        n0 = lstm_serve.launches
        got = lstm_serve(*args)
        torch.cuda.synchronize()
        check(lstm_serve.launches == n0 + 1, "lstm_serve: not one launch")
        want = lstm_serve_plain(*args)
        ref = lstm_serve_plain(*[a.double() for a in args])
        err = err_k = err_p = 0.0
        for name, a, b, r in zip(("ys", "h_T", "c_T"), got, want, ref):
            check(a.dtype == torch.bfloat16 and a.shape == b.shape
                  and torch.isfinite(a).all().item(),
                  f"lstm_serve ({N}, {Tn}) {name}")
            d = (a.float() - b.float()).abs()
            tol = 2 ** -7 * b.float().abs() + 2 ** -8
            check(bool((d <= tol).all()), f"lstm_serve vs plain ({N}, {Tn}) "
                  f"{name}: max |d| {d.max().item():.3e}")
            err = max(err, d.max().item())
            err_k = max(err_k, (a.double() - r).abs().max().item())
            err_p = max(err_p, (b.double() - r).abs().max().item())
        print(f"[a] lstm_serve bf16 ({N}, {Tn}, {C}): max |kernel - plain| "
              f"{err:.3e} (2^-7 |plain| + 2^-8); against float64: kernel "
              f"{err_k:.3e}, plain {err_p:.3e}", flush=True)
        out[f"{N}x{Tn}"] = dict(err=err, kernel_vs_f64=err_k,
                                plain_vs_f64=err_p)
        del args, got, want, ref
    torch.cuda.empty_cache()
    return out


def time_serve(gpu) -> dict:
    """lstm_serve at the serving cells' shapes: ms a launch (CUDA events)
    and the kernel's own device time (profiler), beside the bound (bf16
    operations at 989 TFLOP/s, or the bytes: x in, ys out, h and c in and
    out), the plain version, `ops.basic.lstm` in bf16 (what the serving
    step ran before: a GEMM and ~10 elementwise kernels a step) and
    torch.nn.LSTM on cuDNN in bf16 (the yardstick; the port never calls
    it).  Returns {shape: numbers}."""
    from vap_realtime_tpu_torch.ops.basic import lstm
    from vap_realtime_tpu_torch.ops.cuda.lstm import (
        lstm_serve, lstm_serve_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    res = {}
    for N, Tn in SERVE_SHAPES:
        args = serve_inputs(26, N, Tn)
        run = lambda: lstm_serve(*args)
        ms = cuda_ms(run, reps=20, warm=3)
        dev_ms = kernel_device_ms(run, "lstm_serve_kernel", 10)
        plain_ms = cuda_ms(lambda: lstm_serve_plain(*args), reps=3, warm=1)
        basic_ms = cuda_ms(lambda: lstm(*args), reps=5, warm=2)
        net = torch.nn.LSTM(C, C, batch_first=True).to("cuda", torch.bfloat16)
        with torch.no_grad():
            for t, attr in zip(args[3:], ("weight_ih_l0", "weight_hh_l0",
                                          "bias_ih_l0", "bias_hh_l0")):
                getattr(net, attr).copy_(t)
            net.flatten_parameters()
            library_ms = cuda_ms(lambda: net(args[0], (args[1][None],
                                                       args[2][None])),
                                 reps=5, warm=2)
        flops = 2 * N * Tn * 2 * C * 4 * C
        nbytes = 2 * N * Tn * C * 2 + 4 * N * C * 2 + 4 * C * 2 * C * 2
        bound_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
        print(f"[d] lstm_serve bf16 ({N}, {Tn}, {C}): {ms:.4f} ms/launch "
              f"(kernel alone {dev_ms:.4f}), bound {bound_ms:.4f} ms ({by}: "
              f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s; {nbytes / 1e9:.3f} "
              f"GB) = {100 * bound_ms / dev_ms:.1f}% of bound; plain "
              f"{plain_ms:.4f} ms; ops.basic.lstm bf16 {basic_ms:.4f} ms; "
              f"torch.nn.LSTM (cuDNN, bf16) {library_ms:.4f} ms | {gpu}",
              flush=True)
        res[f"{N}x{Tn}"] = dict(ms=ms, kernel_ms=dev_ms, bound_ms=bound_ms,
                                bound_by=by, plain_ms=plain_ms,
                                basic_ms=basic_ms, library_ms=library_ms)
        del args, net
        torch.cuda.empty_cache()
    return res


def phase_serve_tick(gpu) -> dict:
    """One tick of the benchmark's serving call (`vapbench.serving`, the
    nod 5 Hz and the vap 20 Hz cells at 64 streams) profiled with the
    kernel and with `cpc_context` sent to `ops.basic.lstm` (the parent's
    LSTM; the comparison only, the port has no such switch): the kernel
    launches once an encode call, and the tick drops the plain LSTM's
    per-step GEMMs (cuBLAS `nvjet`, counted) and elementwise kernels, at
    least 2 T kernels.  Returns
    {cell: {kernels a tick with and without}}."""
    from vap_realtime_tpu_torch.models import encoder as enc
    from vap_realtime_tpu_torch.ops.basic import lstm
    from vap_realtime_tpu_torch.ops.cuda.lstm import lstm_serve
    from vapbench.common import load_config, load_workload
    from vapbench.serving import Serving

    cuda = torch.profiler.ProfilerActivity.CUDA
    out = {}
    for cell in ("nod5-fast-open", "vap20-fast-open"):
        wl = load_workload(cell)
        wl = dict(wl, audio=dict(wl["audio"], clips=4, seconds=4))
        sv = Serving(wl, load_config(wl["config"]), 2 ** 33 + 3, "cuda",
                     streams=SERVER_CAPACITY)
        sv.frozen_ticks(3)
        steps = sv.vcfg.cpc_frames_per_chunk
        names = {}
        for mode in ("kernel", "plain"):
            kernel = enc.lstm_serve
            if mode == "plain":
                enc.lstm_serve = lambda *a: lstm(*a)
            try:
                sv.audio.fill(0, sv.frames[0])
                n0 = lstm_serve.launches
                with torch.profiler.profile(activities=[cuda]) as prof:
                    sv.collect(*sv.dispatch(0))
                    torch.cuda.synchronize()
                launches = lstm_serve.launches - n0
            finally:
                enc.lstm_serve = kernel
            ks = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            names[mode] = dict(
                launches=launches, kernels=len(ks),
                serve=sum("lstm_serve_kernel" in k for k in ks),
                nvjet=sum("nvjet" in k for k in ks))
        k, p = names["kernel"], names["plain"]
        check(k["launches"] == 1 and k["serve"] == 1 and p["serve"] == 0,
              f"{cell}: lstm_serve launched {k['launches']} times "
              f"({k['serve']} kernels) a tick, expected 1")
        check(p["kernels"] - k["kernels"] >= 2 * steps, f"{cell}: the tick "
              f"launches {k['kernels']} kernels, {p['kernels']} with the "
              f"plain LSTM's {steps} steps")
        print(f"[serve] {cell}, {SERVER_CAPACITY} streams: one tick launches "
              f"lstm_serve_kernel {k['serve']}x ({k['launches']} wrapper "
              f"call), {k['kernels']} kernels, {k['nvjet']} nvjet GEMMs; "
              f"with ops.basic.lstm {p['kernels']} kernels, {p['nvjet']} "
              f"nvjet ({steps} LSTM steps) | {gpu}", flush=True)
        out[cell] = names
        sv.free()
    return out


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
    """cpc_conv_tail (K9) vs plain at 8192 channel-streams x 224 (20 Hz),
    67 x 224 (a ragged last tile: half a group of 2 streams in conv1, 3 of
    a group of 16 in conv4), 64 x 384 / 128 (10 / 50 Hz) and 4 x 1200
    (streams longer than a tile, cut into row chunks in conv1 and conv2);
    returns the max abs error with a bf16 x0 at 8192 x 224."""
    from vap_realtime_tpu_torch.ops.cuda.cpc_conv import (
        cpc_conv_tail, cpc_conv_tail_plain, tail_out_len,
    )

    worst = 0.0
    for nb, L0 in ((2 * B, L0_TAIL), (67, L0_TAIL), (SERVER_CAPACITY, 384),
                   (SERVER_CAPACITY, 128), (4, 1200)):
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
            if dtype == torch.bfloat16 and nb == 2 * B and L0 == L0_TAIL:
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
    launches = {}
    for config in STEP_CONFIGS:
        zero_counts()
        pk = run_steps(p, cfg, B, frames, torch.bfloat16, "cuda", config,
                       active=act)[:, 0]
        torch.cuda.synchronize()
        want = {k: v * nf for k, v in per_step(config).items()}
        got = launches[config] = counts()
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
    return p, frames, launches


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
                  into=bodies, kernel=None):
        """ms/launch (rotating over the 7 phases), plain ms, library ms
        into `into[name]`; `call(ph)` / `plain(ph)` run phase ph, `lib()`
        the yardstick and returns its output in float units, checked
        against the kernel.  With `kernel` (its CUDA name) also the
        kernel's own device time, without the wrapper's host time."""
        ph = iter(range(10 ** 9))
        ms = cuda_ms(lambda: call(next(ph) % P), reps=70, warm=7)
        plain_ms = cuda_ms(lambda: plain(1), reps=7, warm=2)
        (bound_ms, bound_by), nbytes = attend_bound(es, staged, row_scales)
        library_ms = cuda_ms(lib, reps=20, warm=3)
        d_lib = (lib().float() - call(1).float() * unit).abs().max().item()
        into[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        alone = ""
        if kernel is not None:
            dev = kernel_device_ms(lambda: call(next(ph) % P), kernel, 70)
            into[name]["device_ms"] = dev
            alone = (f"; the kernel alone {dev:.4f} ms = "
                     f"{100 * bound_ms / dev:.1f}% of bound, "
                     f"{nbytes / dev / 1e6:.1f} GB/s")
        print(f"[d] attend_pair {name}, B={B} T={T}"
              f"{f' S={S}' if staged else ''}: {ms:.4f} ms/launch, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB at "
              f"3.35 TB/s) = {100 * bound_ms / ms:.1f}% of bound, achieved "
              f"{nbytes / ms / 1e6:.1f} GB/s; plain "
              f"{plain_ms:.4f} ms; scaled_dot_product_attention yardstick "
              f"{library_ms:.4f} ms (max |sdpa - kernel| {d_lib:.3e})"
              f"{alone} | {gpu}", flush=True)

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
              lib, False, 2, False, 1.0, compact, "attend_compact_kernel")
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
                  lib, False, 1, rows, unit, compact, "attend_q8_kernel")
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
        zero_counts()
        for f in range(steps + 4):
            if f == 4:
                torch.cuda.synchronize()
                t0 = time.time()
            st, o = inc.fast_step(p_bf16, st, frames[f % frames.shape[0]],
                                  cfg, **step_kw)
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) * 1e3 / steps
        got = counts()
        streams = B * (1e3 / cfg.frame_hz) / step_ms
        if config == "fused":
            fused.update(fused_step_ms=step_ms, fused_step_streams=streams)
        print(f"[d] fast {step_kw['slots']} step bf16 {config}, B={B}, "
              f"kernels: {step_ms:.3f} ms/step (host clock, {steps} steps"
              f"{' incl. 3 merges' if init_kw['staged'] else ''}) -> "
              f"{streams:.0f} realtime streams per card at {cfg.frame_hz} "
              f"Hz; attend launches a step: K1-K4 "
              f"{got['attend'] / (steps + 4):g}, K10 "
              f"{got['compact'] / (steps + 4):g} | {gpu}", flush=True)
        del st
        torch.cuda.empty_cache()
    print(f"[d] conv_stack_fused (K7) {fused['ms']:.4f} ms/call against the "
          f"fused fast step's {fused['fused_step_ms']:.3f} ms/step (same "
          f"call, one K7 call per step, B={B}) | {gpu}", flush=True)
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
    path's dtype) and a float32 one: ms per call (four launches), the
    bound (the 3xTF32 floor: three TF32 passes per product at 495
    TFLOP/s, two in conv1 with a bf16 x0; or the bytes) beside the
    float32 CUDA-core bound (67 TFLOP/s), the plain version; and the
    cuDNN conv1-4 + ChannelNorm tail of cpc_conv_stack over the same x0
    (the yardstick: no single PyTorch call computes the tail)."""
    from vap_realtime_tpu_torch.ops.basic import channel_norm, conv1d
    from vap_realtime_tpu_torch.ops.cuda.cpc_conv import (
        TAIL_SPECS, cpc_conv_tail, cpc_conv_tail_plain, tail_out_len,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    N, lens = 2 * B, tail_out_len(L0_TAIL)
    flops_l = [2 * N * C * C * L * k for L, (k, _, _) in zip(lens,
                                                            TAIL_SPECS)]
    flops = sum(flops_l)
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

        # the kernel and the cuDNN tail in turns: kernel, tail, tail, kernel
        kernel = lambda: cpc_conv_tail(x0, packed)
        ms, tail_ms, tail2, ms2 = (cuda_ms(f, reps=5, warm=1) for f in
                                   (kernel, cudnn_tail, cudnn_tail, kernel))
        ms, tail_ms = (ms + ms2) / 2, (tail_ms + tail2) / 2
        plain_ms = cuda_ms(lambda: cpc_conv_tail_plain(x0, packed), reps=3,
                           warm=1)
        es = x0.element_size()
        nbytes = (N * (L0_TAIL + lens[-1]) * C * es
                  + sum(t.numel() for t in packed) * 4)
        passes = [2 if dtype == torch.bfloat16 else 3, 3, 3, 3]
        tf32_ops = sum(n * f for n, f in zip(passes, flops_l))
        bound_ms, bound_by = bound(nbytes, tf32_ops, TF32_FLOP_PER_S)
        f32_ms = bound(nbytes, flops)[0]
        name = str(dtype)[6:]
        print(f"[d] cpc_conv_tail (K9) {name} x0 ({N}, {L0_TAIL}, {C}): "
              f"{ms:.4f} ms/call (4 launches); bound {bound_ms:.4f} ms "
              f"({bound_by}: 3xTF32 {tf32_ops / 1e12:.3f} TFLOP of TF32 at "
              f"495 TFLOP/s; {nbytes / 1e9:.3f} GB) = "
              f"{100 * bound_ms / ms:.1f}% of bound; float32 bound "
              f"{f32_ms:.4f} ms ({flops / 1e12:.3f} TFLOP at 67 TFLOP/s) "
              f"= {100 * f32_ms / ms:.1f}%; plain {plain_ms:.4f} ms; no "
              f"single PyTorch call: the cuDNN conv1-4 + ChannelNorm tail "
              f"{tail_ms:.4f} ms | {gpu}", flush=True)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         bound_f32_ms=f32_ms, cudnn_tail_ms=tail_ms)
        del x0
    torch.cuda.empty_cache()
    return dict(res["bfloat16"], bodies=res)


def time_fused(p_bf16, frames, gpu) -> dict:
    """K7 at the serving shape (8192 channel-streams x 800 samples): ms per
    call in bf16 (the serving dtype; the JSON's numbers) and in float32,
    each beside its bound and its plain version, the CUDA launches a call
    makes, the bf16 body's per-launch device times and L2 weight bytes per
    call, and the `conv` and `normk` stacks over the same frame (no single
    PyTorch call computes the stack)."""
    from vap_realtime_tpu_torch.models.encoder import (
        cpc_conv_stack_streaming, cpc_conv_stack_streaming_normk,
    )
    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        CUDA_LAUNCHES, TAIL_KS, conv_stack_fused, conv_stack_fused_plain,
        init_conv_stream_state_fused, pack_fused_params, tail_lens,
        weight_l2_bytes,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms
    from vap_realtime_tpu_torch.tools.k7_ablate import time_call

    N = 2 * B
    T0 = L_NEW // 5
    flops = 2 * N * C * (T0 * 10 + sum(
        t_out * k * C for (k, _), (_, t_out) in zip(TAIL_KS,
                                                    tail_lens(T0))))
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        enc = {k: {n: v.to(dt) for n, v in layer.items()}
               for k, layer in p_bf16["encoder"].items()}  # two levels
        st = init_conv_stream_state_fused(N, dtype=dt, device="cuda")
        new = frames[0].reshape(N, L_NEW).to(dt)
        w0, wts, aux = pack_fused_params(enc, dt)
        args = (st["c0"][:, 0], new, tuple(st[f"c{i}"] for i in range(1, 5)),
                w0, wts, aux)
        run = lambda: conv_stack_fused(*args)
        ms = cuda_ms(run, reps=10, warm=2)
        plain_ms = cuda_ms(lambda: conv_stack_fused_plain(*args), reps=3)
        es = new.element_size()
        carry = (5 + sum(k - s for k, s in TAIL_KS) * C) * es
        nbytes = (N * (L_NEW * es + 2 * carry + 5 * C * es)
                  + (w0.numel() + sum(w.numel() for w in wts)) * es
                  + aux.numel() * 4)
        name = str(dt)[6:]
        if dt == torch.bfloat16:
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            peak = "989 TFLOP/s bf16"
            # the five launches of one call, by device time
            _, per = time_call(run, reps=5)
            l2 = weight_l2_bytes(N, L_NEW)
            conv_ms = cuda_ms(lambda: cpc_conv_stack_streaming(enc, new, st),
                              10)
            normk_ms = cuda_ms(
                lambda: cpc_conv_stack_streaming_normk(enc, new, st), 10)
            extra = (f"; {CUDA_LAUNCHES[dt]} CUDA launches a call (conv0 "
                     f"{per[0]:.4f}, conv1-4 "
                     + ", ".join(f"{t:.4f}" for t in per[1:])
                     + f" ms); L2 weight reads {l2 / 1e9:.3f} GB a call; no "
                     f"single PyTorch call: the conv stack (cuDNN convs + "
                     f"plain ChannelNorm) {conv_ms:.4f} ms, the normk stack "
                     f"{normk_ms:.4f} ms")
            res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None,
                             cuda_launches=CUDA_LAUNCHES[dt],
                             launch_ms=per, weight_l2_bytes=l2,
                             conv_stack_ms=conv_ms, normk_stack_ms=normk_ms)
        else:
            bound_ms, bound_by = bound(nbytes, flops)
            peak = "67 TFLOP/s float32 CUDA cores"
            extra = f"; {CUDA_LAUNCHES[dt]} CUDA launch a call"
            res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by,
                             cuda_launches=CUDA_LAUNCHES[dt])
        print(f"[d] conv_stack_fused {name} ({N} x {L_NEW}): {ms:.4f} "
              f"ms/call, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e12:.3f} TFLOP at {peak}; {nbytes / 1e9:.3f} GB) "
              f"= {100 * bound_ms / ms:.1f}% of bound; plain {plain_ms:.4f} "
              f"ms{extra} | {gpu}", flush=True)
        del st, new, args
        torch.cuda.empty_cache()
    return dict(res["bfloat16"], float32=res["float32"])


def time_lstm(p_bf16, gpu) -> dict:
    """K5 at (8192, 5, 256), with bf16 gates and state (the encoder's
    dtype) and with float32 ones (W_hh^T is float32 in both): ms per
    launch, the bound (the 3xTF32 floor at 495 TFLOP/s, or the bytes)
    beside the float32 CUDA-core bound (67 TFLOP/s), the plain version;
    and lstm_fused (input projection + scan) against torch.nn.LSTM on
    cuDNN over the same problem in the same dtype (TF32 off): the
    yardstick, like for like; the port never calls it.  Returns the bf16
    numbers, both dtypes under "bodies"."""
    from vap_realtime_tpu_torch.ops.cuda.lstm import (
        lstm_fused, lstm_scan, lstm_scan_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    N, Hh, Tn = 2 * B, C, 5
    flops = 2 * N * Tn * Hh * 4 * Hh
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        g = {k: v.to(dt) for k, v in p_bf16["encoder"]["lstm"].items()}
        gen = torch.Generator(device="cuda").manual_seed(12)
        x = torch.randn(N, Tn, Hh, generator=gen, device="cuda").to(dt)
        h0 = (0.1 * torch.randn(N, Hh, generator=gen, device="cuda")).to(dt)
        c0 = (0.1 * torch.randn(N, Hh, generator=gen, device="cuda")).to(dt)
        gi = torch.matmul(x, g["w_ih"].T) + g["b_ih"]
        scan = (gi, h0, c0, g["w_hh"].T, g["b_hh"])
        fused = lambda: lstm_fused(x, h0, c0, g["w_ih"], g["w_hh"],
                                   g["b_ih"], g["b_hh"])
        ms = cuda_ms(lambda: lstm_scan(*scan), reps=20, warm=3)
        plain_ms = cuda_ms(lambda: lstm_scan_plain(*scan), reps=5)
        net = torch.nn.LSTM(Hh, Hh, batch_first=True).to("cuda", dt)
        with torch.no_grad():
            for name, attr in (("w_ih", "weight_ih_l0"),
                               ("w_hh", "weight_hh_l0"),
                               ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
                getattr(net, attr).copy_(g[name])
            net.flatten_parameters()
            lib = lambda: net(x, (h0[None], c0[None]))
            # lstm_fused and nn.LSTM in turns: fused, lib, lib, fused
            fused_ms, library_ms, lib2, fused2 = (
                cuda_ms(f, reps=20, warm=3) for f in (fused, lib, lib, fused))
            fused_ms, library_ms = (fused_ms + fused2) / 2, (library_ms
                                                             + lib2) / 2
            d = (lib()[0].float() - fused()[0].float()).abs().max().item()
        es = x.element_size()
        nbytes = ((gi.numel() + 4 * N * Hh + N * Tn * Hh) * es
                  + Hh * 4 * Hh * 4 + 4 * Hh * 4)
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
        f32_ms = bound(nbytes, flops)[0]
        name = str(dt)[6:]
        print(f"[d] lstm_scan {name} ({N}, {Tn}, {Hh}): {ms:.4f} ms/launch, "
              f"bound {bound_ms:.4f} ms ({bound_by}: 3xTF32 "
              f"{3 * flops / 1e9:.2f} GFLOP of TF32 at 495 TFLOP/s; "
              f"{nbytes / 1e9:.3f} GB) = {100 * bound_ms / ms:.1f}% of "
              f"bound; float32 bound {f32_ms:.4f} ms ({flops / 1e9:.2f} "
              f"GFLOP at 67 TFLOP/s) = {100 * f32_ms / ms:.1f}%; plain "
              f"{plain_ms:.4f} ms; lstm_fused (projection + scan) "
              f"{fused_ms:.4f} ms vs torch.nn.LSTM (cuDNN, {name} weights) "
              f"{library_ms:.4f} ms (max |nn.LSTM - lstm_fused| {d:.3e}) | "
              f"{gpu}", flush=True)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         bound_f32_ms=f32_ms, lstm_fused_ms=fused_ms)
        del gi, x, net
    torch.cuda.empty_cache()
    return dict(res["bfloat16"], bodies=res)


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


MERGE_MODES = {"bf16": (torch.bfloat16, False),
               "float32": (torch.float32, False),
               "q8g": (torch.int8, "global"), "q8": (torch.int8, "row")}
# the open cells' shapes: (streams, ring rows) of vap_jp_20hz_2500ms and
# nod_erica_20hz_10000ms at the cells' loads
MERGE_CELLS = {"vap open": (20480, 50), "nod open": (14336, 200)}


def merge_inputs(mode: str, nb: int, Tn: int, seed: int):
    """A staged merge's tensors on the card: (cache, stamp, stage,
    stage_stamp, scale, stage_scale).  Payload and scales are random
    bytes (a byte copy is checked as bytes, NaN patterns included); about
    a quarter of the staged rows invalid, stream 0 all invalid, stamps
    wrapped round the ring several times and distinct mod Tn per stream."""
    dtype, quant = MERGE_MODES[mode]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def raw(shape, dt):
        es = torch.empty((), dtype=dt).element_size()
        n = int(np.prod(shape)) * es
        return torch.randint(0, 256, (n,), generator=g, device="cuda",
                             dtype=torch.uint8).view(dt).view(shape)

    cache = raw((nb, P, Tn, 4 * D), dtype)
    stage = raw((S, nb, P * 4 * D), dtype)
    stamp = torch.randint(-1, 8 * Tn, (nb, Tn), generator=g, device="cuda",
                          dtype=torch.int32)
    base = torch.randint(0, 8 * Tn, (1, nb), generator=g, device="cuda",
                         dtype=torch.int32)
    st = base + torch.arange(S, device="cuda", dtype=torch.int32)[:, None]
    st = torch.where(torch.rand((S, nb), generator=g, device="cuda") < 0.25,
                     -1, st)
    st[:, 0] = -1
    scale = stage_scale = None
    if quant == "row":
        scale = raw((nb, P, Tn), torch.float32)
        stage_scale = raw((S, nb, P), torch.float32)
    return cache, stamp, stage, st.contiguous(), scale, stage_scale


def _as_bytes(t):
    return t.view(torch.uint8)


def phase_a_merge() -> int:
    """The stage-merge kernel against its plain version on the card, bit
    for bit (ring, stamps, row scales as bytes; the stage marked empty):
    bf16, float32, the int8 cache with frozen scales (q8g) and with row
    scales (q8), B = 4096 and a ragged 4097, T = 50 and 200.  One launch
    a merge.  Returns the launches."""
    from vap_realtime_tpu_torch.ops.cuda.merge import (
        stage_merge, stage_merge_plain,
    )

    stage_merge.launches = 0
    n = 0
    for mode in MERGE_MODES:
        for nb in (B, B + 1):
            for Tn in (T, 4 * T):
                ts = merge_inputs(mode, nb, Tn, seed=nb + Tn)
                nvalid = int((ts[3] >= 0).sum())
                want = [None if t is None else t.clone() for t in ts]
                stage_merge_plain(*want)
                before = stage_merge.launches
                stage_merge(*ts)
                torch.cuda.synchronize()
                check(stage_merge.launches == before + 1,
                      f"stage_merge {mode}: {stage_merge.launches - before}"
                      f" launches a merge")
                n += 1
                for name, got, w in zip(("cache", "stamp", "stage",
                                         "stage_stamp", "scale",
                                         "stage_scale"), ts, want):
                    if w is not None:
                        check(torch.equal(_as_bytes(got), _as_bytes(w)),
                              f"stage_merge {mode} B={nb} T={Tn}: {name} "
                              f"differs from the plain version")
                check(bool((ts[3] == -1).all()),
                      f"stage_merge {mode} B={nb} T={Tn}: stage not empty")
                rows = "ring, stamps" + (", scales" if ts[4] is not None
                                         else "")
                print(f"[a] stage_merge {mode} ({nb}, {P}, {Tn}, {4 * D}), "
                      f"S={S}, {nvalid} of {S * nb} staged rows valid: "
                      f"{rows} bit-equal to the plain version, stage empty",
                      flush=True)
                del ts, want
                torch.cuda.empty_cache()
    return n


def phase_d_merge(gpu) -> dict:
    """The stage-merge kernel's device time (the profiler, without the
    stamps' restore each call needs) at the open cells' shapes, bf16,
    every staged row valid as in the cells' traffic, beside its byte floor
    (each staged row read once and written once) and the plain version's
    time (CUDA events, the restore included).  Returns the JSON fields
    (the vap open shape's at the top level)."""
    from vap_realtime_tpu_torch.ops.cuda.merge import (
        stage_merge, stage_merge_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    shapes = {}
    for name, (nb, Tn) in MERGE_CELLS.items():
        cache, stamp, stage, _, _, _ = merge_inputs("bf16", nb, Tn, seed=5)
        saved = (torch.arange(S, device="cuda", dtype=torch.int32)[:, None]
                 + 3 * Tn + torch.zeros((1, nb), device="cuda",
                                        dtype=torch.int32))
        ss = saved.clone()

        def kernel():
            ss.copy_(saved)
            stage_merge(cache, stamp, stage, ss)

        def plain():
            ss.copy_(saved)
            stage_merge_plain(cache, stamp, stage, ss)

        dev = kernel_device_ms(kernel, "stage_merge_kernel", 20)
        ms = cuda_ms(kernel, reps=20, warm=3)
        plain_ms = cuda_ms(plain, reps=3, warm=1)
        nbytes = 2 * stage.numel() * stage.element_size()
        bound_ms, bound_by = bound(nbytes, 0)
        shapes[name] = dict(ms=dev, ms_with_restore=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            streams=nb, ring_rows=Tn)
        print(f"[d] stage_merge bf16 {name} ({nb}, {P}, {Tn}, {4 * D}), "
              f"S={S}, all rows valid: the kernel {dev:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB at "
              f"3.35 TB/s) = {100 * bound_ms / dev:.1f}% of bound, "
              f"{nbytes / dev / 1e6:.1f} GB/s ({dev / bound_ms:.3f}x the "
              f"floor); with the stamps' restore {ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms | {gpu}", flush=True)
        del cache, stamp, stage, saved, ss
        torch.cuda.empty_cache()
    return dict(shapes["vap open"], library_ms=None, shapes=shapes)


# K7's frames in the long-frame phase: the 20 Hz frame (one body call,
# as before) and the 5 Hz frame (four 800-sample body calls)
K7_FRAMES = (800, 3200)


def k7_digest(seed: int, N: int, L: int, keep: bool = False):
    """sha256 of K7's bf16 outputs over 3 frames on `fused_inputs(seed,
    bf16, N, L)`: (all: z and every carry; c01: the carries c0 and c1
    alone), and with `keep` the last frame's (z, c0..c4) on the host.  The
    same digest from two builds means bit-equal outputs."""
    import hashlib

    from vap_realtime_tpu_torch.ops.cuda.encoder import conv_stack_fused

    c0, news, carries, packed, _ = fused_inputs(seed, torch.bfloat16, N, L)
    st, h, h01 = (c0, *carries), hashlib.sha256(), hashlib.sha256()
    for new in news:
        z, st = conv_stack_fused(st[0], new, st[1:], *packed)
        for i, t in enumerate((z, *st)):
            b = t.contiguous().view(torch.int16).cpu().numpy().tobytes()
            h.update(b)
            if i in (1, 2):
                h01.update(b)
    last = tuple(t.cpu() for t in (z, *st)) if keep else None
    return h.hexdigest(), h01.hexdigest(), last


def phase_k7_long(gpu) -> dict:
    """K7 on 8192 channel-streams at the 20 Hz and the 5 Hz frame, bf16:
    three frames each carrying its own state against the plain version
    (the tolerance of (a)); the 5 Hz frame bit-equal to four 800-sample
    calls in a row and counted as four body calls of 800 samples; each
    frame's ms a call beside its operation bound; and the 20 Hz frame's
    digest (`k7_digest`), which a run of the parent commit's build prints
    the same when its body is unchanged.  Returns {L: fields}."""
    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        conv_stack_fused, conv_stack_fused_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms
    from vapbench.counts.conv_stack_fused import call_ops

    N, out = 2 * B, {}
    for L in K7_FRAMES:
        c0, news, carries, packed, _ = fused_inputs(31, torch.bfloat16, N, L)
        st_k = st_p = st_c = (c0, *carries)
        err = 0.0
        calls0 = conv_stack_fused.launches
        samples0 = conv_stack_fused.samples
        for f, new in enumerate(news):
            zk, st_k = conv_stack_fused(st_k[0], new, st_k[1:], *packed)
            zp, st_p = conv_stack_fused_plain(st_p[0], new, st_p[1:],
                                              *packed)
            zc = []
            for at in range(0, L, 800):
                z1, st_c = conv_stack_fused(st_c[0], new[:, at:at + 800],
                                            st_c[1:], *packed)
                zc.append(z1)
            torch.cuda.synchronize()
            what = f"L={L} frame {f}"
            check(zk.shape == (N, L // 160, C)
                  and torch.isfinite(zk).all().item(),
                  f"conv_stack_fused output {what}")
            check(torch.equal(zk, torch.cat(zc, dim=1)) and all(
                torch.equal(a, b) for a, b in zip(st_k, st_c)),
                f"conv_stack_fused {what}: not bit-equal to 800-sample calls")
            check(torch.equal(st_k[0], st_p[0]), f"carry c0 {what}")
            for name, got, want in [("z", zk, zp)] + [
                    (f"c{i}", a, b) for i, (a, b) in
                    enumerate(zip(st_k[1:], st_p[1:]), start=1)]:
                d = (got.float() - want.float()).abs()
                check(bool((d <= 2 ** -6 * (1 + want.float().abs())).all()),
                      f"conv_stack_fused vs plain {what} {name}: max |d| "
                      f"{d.max().item():.3e}")
                err = max(err, d.max().item())
        pieces = L // 800
        calls = conv_stack_fused.launches - calls0
        samples = conv_stack_fused.samples - samples0
        # 3 frames through the wrapper, 3 x pieces 800-sample calls
        check(calls == 3 * pieces + 3 * pieces,
              f"conv_stack_fused L={L}: {calls} body calls counted, "
              f"expected {6 * pieces}")
        check(samples == 6 * N * L,
              f"conv_stack_fused L={L}: {samples} samples counted, "
              f"expected {6 * N * L}")
        args = (st_k[0], news[0], st_k[1:], *packed)
        ms = cuda_ms(lambda: conv_stack_fused(*args), reps=10, warm=2)
        plain_ms = cuda_ms(lambda: conv_stack_fused_plain(*args), reps=2)
        flops = call_ops(N, L)
        bound_ms = 1e3 * flops / BF16_FLOP_PER_S
        digest = k7_digest(31, N, L)[0] if L == 800 else None
        out[L] = dict(ms=ms, bound_ms=bound_ms, share=100 * bound_ms / ms,
                      plain_ms=plain_ms, body_calls=pieces,
                      max_abs_err=err, digest=digest)
        print(f"[k7] conv_stack_fused bf16 ({N} x {L}): {pieces} body "
              f"call(s) a frame, {ms:.4f} ms a frame, bound {bound_ms:.4f} "
              f"ms ({flops / 1e12:.3f} TFLOP at 989 TFLOP/s) = "
              f"{100 * bound_ms / ms:.1f}% of bound; plain {plain_ms:.4f} "
              f"ms; max |kernel - plain| {err:.3e} (|d| <= 2^-6 (1 + "
              f"|plain|)); bit-equal to {pieces} 800-sample call(s)"
              + (f"; digest {digest}" if digest else "") + f" | {gpu}",
              flush=True)
        del c0, news, carries, st_k, st_p, st_c, zk, zp, zc, args
        torch.cuda.empty_cache()
    return out


# K7 against the body that stored conv1's input X1 in device memory:
# (channel-streams, samples a frame); the 5 Hz cell's 83,968
# channel-streams take the 3,200-sample frame in four body calls, and
# 2B + 3 is ragged against the 128-row tiles
K7_BIT_CASES = ((2 * B, 800), (2 * B, 1600), (83968, 3200), (2 * B + 3, 800))
# k7_digest(41, N, L)'s c01 (the carries c0 and c1 over three frames) of
# that body, which conv0_kernel still computes the same way, built and
# run on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128, CUDA 12.8): the
# inputs come from torch's CUDA generator, so another torch build may draw
# others and change every digest at once
K7_X1_C01 = {
    (2 * B, 800):
        "d5f9b5f3626567ec3541bb49140d5da3522a76a7442fde2a03867de7cf8084d4",
    (2 * B, 1600):
        "9d82172f54d40a7676cb4373f23e1e2e0b2330fafad8fab63481eaf6ae1948de",
    (83968, 3200):
        "d89f994edcdcaca978936afa178d9e644119f3a4e9cacc964013b18786f29604",
    (2 * B + 3, 800):
        "d96b330f1ba83d6de239758819ef68064989df4757a82e5faedf05719d9c31cf",
}


def phase_k7_bits(gpu, expect=None, save=None, ref=None) -> dict:
    """K7's bf16 body at K7_BIT_CASES, three frames carrying state: the
    digests of `k7_digest` (c0 and c1 held equal to `expect`, the body
    that stored X1, where given); with `save` a directory, the last
    frame's z and carries written there; with `ref` one that another
    build's run saved to, each output's max |d| against it and the share
    of its elements that differ; and each launch's device time a call
    (`conv0_kernel`, then the four `conv_layer_kernel`, summed over a
    frame's body calls).  `python3 chip_smoke.py --k7-digests [check]
    [save=DIR] [ref=DIR]` runs only this, so two builds can be compared in
    one call.  Returns {"N x L": fields}."""
    import os

    from vap_realtime_tpu_torch.ops.cuda.encoder import (
        TILE_ROWS, conv_stack_fused,
    )
    from vap_realtime_tpu_torch.tools.k7_ablate import time_call

    out = {}
    for N, L in K7_BIT_CASES:
        key, pieces = f"{N} x {L}", L // 800 if L > 1600 else 1
        d_all, d01, last = k7_digest(41, N, L, keep=bool(save or ref))
        out[key] = dict(digest=d_all, digest_c01=d01, body_calls=pieces)
        line = f"digest {d_all}, c0/c1 {d01}"
        path = lambda d: os.path.join(d, f"k7_{N}x{L}.pt")
        if save:
            os.makedirs(save, exist_ok=True)
            torch.save(last, path(save))
        if ref:
            diffs = []
            for name, a, b in zip(("z", "c0", "c1", "c2", "c3", "c4"), last,
                                  torch.load(path(ref))):
                d = (a.float() - b.float()).abs()
                diffs.append((name, d.max().item(),
                              (d > 0).float().mean().item()))
            out[key]["vs_ref"] = {n: dict(max_abs=m, share=f)
                                  for n, m, f in diffs}
            line += "; vs ref (last frame) " + ", ".join(
                f"{n} max |d| {m:.3e} ({100 * f:.3f}% differ)"
                for n, m, f in diffs)
        # timed at the serving shapes only: at the ragged 8195 the profiler
        # dropped one K7 record of every window (3 to 6 calls, twice); a
        # window it cuts short leaves the times unmeasured, not the check
        if N % TILE_ROWS == 0:
            c0, news, carries, packed, _ = fused_inputs(
                41, torch.bfloat16, N, L)
            try:
                ms, per = time_call(lambda: conv_stack_fused(
                    c0, news[0], carries, *packed), reps=3)
            except RuntimeError as e:
                line += f"; launch times not measured ({e})"
            else:
                per = [sum(per[i::5]) for i in range(5)]  # a launch, pieces
                out[key].update(ms=ms, conv0_ms=per[0],
                                conv_layer_ms=per[1:])
                line += (f"; {ms:.4f} ms a frame; device ms conv0_kernel "
                         f"{per[0]:.4f}, conv_layer_kernel "
                         + ", ".join(f"{t:.4f}" for t in per[1:]))
            del c0, news, carries
        print(f"[k7bits] conv_stack_fused bf16 ({key}, {pieces} body "
              f"call(s) a frame): {line} | {gpu}", flush=True)
        if expect is not None:
            check(d01 == expect.get((N, L)),
                  f"conv_stack_fused ({key}): c0 or c1 differs from the "
                  f"body that stored X1 (digest {d01}, expected "
                  f"{expect.get((N, L))})")
        del last
        torch.cuda.empty_cache()
    return out


def phase_rate5(gpu) -> dict:
    """One 5 Hz tick on the card: the nod 5 Hz / 10 s configuration
    (`vapbench/configs/nod_erica_5hz_10000ms.json`) through the
    benchmark's serving call (`vapbench.serving.Serving`: StreamArena on
    the fast path, fused K7, staged slots, K2, bf16, int16 wire) at 64
    streams and seeded weights, after 3 frozen ticks: finite fields, 4
    K7 body calls and 7 K2 launches a tick, its ms; the sampled streams'
    fields against the float64 reference (`vapbench/reference/`) in units
    of a sound bf16 computation's gap, under the cell's limit."""
    from vap_realtime_tpu_torch.ops.cuda.attend import attend_pair
    from vap_realtime_tpu_torch.ops.cuda.encoder import conv_stack_fused
    from vapbench.common import load_config, load_workload
    from vapbench.serving import Serving

    wl = load_workload("nod5-fast-open")
    wl = dict(wl, audio=dict(wl["audio"], clips=4, seconds=4))
    sv = Serving(wl, load_config(wl["config"]), 2 ** 33 + 1, "cuda",
                 streams=SERVER_CAPACITY)
    sv.frozen_ticks(3)
    sv.audio.fill(0, sv.frames[0])
    calls0, k2 = conv_stack_fused.launches, attend_pair.launches
    t = time.perf_counter()
    sv.collect(*sv.dispatch(0))
    ms = 1e3 * (time.perf_counter() - t)
    calls = conv_stack_fused.launches - calls0
    k2 = attend_pair.launches - k2
    sv.free()
    chk = sv.check(1)
    limit = wl["check"]["limits"]["max_gap_ratio"]
    check(sv.failed == 0, "5 Hz tick: non-finite fields")
    check(calls == 4 and k2 == 7, f"5 Hz tick: {calls} K7 body calls and "
          f"{k2} K2 launches, expected 4 and 7")
    check(chk["max_gap_ratio"] <= limit, f"5 Hz tick against the "
          f"reference: max_gap_ratio {chk['max_gap_ratio']:.3f}")
    print(f"[rate5] nod 5 Hz / 10 s, {SERVER_CAPACITY} streams: one tick "
          f"{ms:.2f} ms (4 K7 body calls of 800 samples, 7 K2 launches); "
          f"against the float64 reference max |d| {chk['max_gap']:.3e}, "
          f"{chk['max_gap_ratio']:.3f}x a sound bf16 computation's (limit "
          f"{limit}) | {gpu}", flush=True)
    return dict(ms=ms, max_gap=chk["max_gap"],
                max_gap_ratio=chk["max_gap_ratio"])


# one cell of each serving configuration
SYNC_CELLS = ("vap20-fast-open", "nod20-fast-open", "nod5-fast-open")


@contextlib.contextmanager
def sync_debug_error():
    """Any blocking CUDA sync inside the block raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def phase_sync(gpu) -> dict:
    """Warm serving ticks hold no blocking sync: for each serving
    configuration, the benchmark's serving call at 64 streams after 3
    frozen ticks, 9 ticks (one merges the stage) each under the sync
    debug mode "error"; `bin_sum_table.builds` unchanged.  Then 3 ticks
    whose `vap.probs` also runs with a table built on every call: every
    field bit-equal.  Returns {workload: {ticks, builds, equal}}."""
    from vap_realtime_tpu_torch.models import objective as obj
    from vap_realtime_tpu_torch.runtime import incremental
    from vapbench.common import load_config, load_workload
    from vapbench.serving import Serving

    probs = torch.full((4, 256), 1 / 256, device="cuda")
    try:
        with sync_debug_error():
            obj._bin_sum_table(0, 1, 4, probs.dtype, probs.device)
        raised = False
    except RuntimeError:
        raised = True
    check(raised, "sync debug mode: a table built from host memory did not "
          "raise")
    cached_probs = incremental.probs_from_outputs
    out = {}
    for name in SYNC_CELLS:
        wl = load_workload(name)
        wl = dict(wl, audio=dict(wl["audio"], clips=4, seconds=4))
        sv = Serving(wl, load_config(wl["config"]), 2 ** 33 + 3, "cuda",
                     streams=SERVER_CAPACITY)
        sv.frozen_ticks(3)
        builds = obj.bin_sum_table.builds
        for k in range(9):
            sv.audio.fill(k, sv.frames[0])
            with sync_debug_error():
                sv.arena.step_device_batch(sv.frames[0].numpy(), sv.slots)
            torch.cuda.synchronize()
        check(obj.bin_sum_table.builds == builds,
              f"{name}: {obj.bin_sum_table.builds - builds} bin-sum tables "
              f"built on warm ticks")
        equal = []

        def both(outputs, cfg):
            got = cached_probs(outputs, cfg)
            table, obj.bin_sum_table = obj.bin_sum_table, obj._bin_sum_table
            try:
                want = cached_probs(outputs, cfg)
            finally:
                obj.bin_sum_table = table
            equal.append(all(torch.equal(got[f], want[f]) for f in got))
            return got

        incremental.probs_from_outputs = both
        try:
            for k in range(9, 12):
                sv.audio.fill(k, sv.frames[0])
                res = sv.arena.step_device_batch(sv.frames[0].numpy(),
                                                 sv.slots)
        finally:
            incremental.probs_from_outputs = cached_probs
        finite = all(bool(torch.isfinite(v.float()).all())
                     for v in res.values())
        sv.free()
        check(finite, f"{name}: non-finite fields")
        check(len(equal) == 3 and all(equal), f"{name}: the fields with the "
              f"cached tables differ from a table built per call: {equal}")
        out[name] = dict(ticks=9, builds=obj.bin_sum_table.builds - builds,
                         equal=len(equal))
        print(f"[sync] {name} ({wl['config']}), {SERVER_CAPACITY} streams: "
              f"9 warm ticks under sync debug mode \"error\", none raised, 0 "
              f"tables built; 3 ticks' fields bit-equal to a table built per "
              f"call | {gpu}", flush=True)
    return out


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


@contextlib.contextmanager
def recorded_ticks():
    """The port's span recorder on around a block; the list it yields
    holds the block's `vap.tick` spans once the block ends (a tick of an
    arena or of a `VapEngine`: their count and host time)."""
    from vap_realtime_tpu_torch.utils import spans

    spans.take()
    spans.enable(True)
    ticks = []
    try:
        yield ticks
    finally:
        spans.enable(False)
        ticks.extend(r for r in spans.take() if r.name == "vap.tick")


def tick_ms(ticks) -> float:
    """Mean host ms of `vap.tick` spans."""
    return sum(r.end_ns - r.start_ns for r in ticks) * 1e-6 / len(ticks)


def phase_c(cfg, params_np, config="bf16"):
    """The native server on the card, with the arena of a configuration
    (CONFIGS): 8 loopback connections.  Returns the kernels' launches
    over the run."""
    from vap_realtime_tpu_torch.io import wire
    from vap_realtime_tpu_torch.ops.cuda.merge import stage_merge
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
    step0 = getattr(arena.state, "kv", arena.state).step
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
    stage_merge.launches = 0
    ticker = threading.Thread(target=srv.serve_forever)
    clients = [threading.Thread(target=client, args=(i,))
               for i in range(n_conn)]
    with recorded_ticks() as stepped:
        ticker.start()
        try:
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=60)
        finally:
            srv.stop()
            ticker.join(timeout=10)
    launches = counts()                              # ... and read
    merge_launches = stage_merge.launches
    check(not ticker.is_alive() and not any(c.is_alive() for c in clients),
          "server or client threads did not stop")
    ticks = len(stepped)
    # resync ticks of a hybrid arena: no attend launch, no merge
    R = kw.get("resync_every", 0)
    resyncs = sum(1 for g in range(step0, step0 + ticks)
                  if R and (g + 1) % R == 0)
    # the staged merge: one launch on each merge tick, none on the others
    staged = kw.get("slots", "staged") == "staged"
    merges = sum(1 for g in range(step0, step0 + ticks)
                 if staged and (g + 1) % S == 0
                 and not (R and (g + 1) % R == 0))
    check(merge_launches == merges,
          f"{merge_launches} stage_merge launches over {ticks} server ticks "
          f"holding {merges} merge ticks")
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
          f"{'incremental ' if R else ''}tick; stage_merge {merge_launches} "
          f"= the {merges} merge ticks, 0 on the others", flush=True)
    return dict(launches, merge=merge_launches)


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


# --- slice 9: the serving surfaces ------------------------------------------

F_FRAMES = 20                      # frames (1 s of audio) a served stream


def two_port_serve(engine, audio, n_frames):
    """VapServer on free ports around `engine`: one consumer, one producer
    streaming float64 hops of (2, N) `audio` paced as the CPU serving
    tests pace them (2 ms a hop), until `n_frames` results arrived.
    Returns (results, the engine's `vap.tick` spans)."""
    from vap_realtime_tpu_torch.io import wire
    from vap_realtime_tpu_torch.runtime.server import VapServer

    srv = VapServer(engine, port_in=0, port_out=0)
    srv.start_background()
    results = []

    def consume():
        with socket.create_connection(("127.0.0.1", srv.port_out),
                                      timeout=30) as c:
            while len(results) < n_frames:
                results.append(wire.deserialize_result(
                    wire.read_framed(c), "vap"))

    consumer = threading.Thread(target=consume)
    with recorded_ticks() as stepped:
        try:
            consumer.start()
            deadline = time.time() + 10
            while not srv.clients and time.time() < deadline:
                time.sleep(0.01)
            with socket.create_connection(("127.0.0.1", srv.port_in),
                                          timeout=10) as p:
                for h in range(n_frames * engine.cfg.frame_shift // 160):
                    p.sendall(wire.conv_2floatarray_2_bytearray(
                        audio[0, h * 160:(h + 1) * 160],
                        audio[1, h * 160:(h + 1) * 160]))
                    time.sleep(0.002)
                consumer.join(timeout=60)
        finally:
            srv.stop()
    check(not consumer.is_alive() and len(results) == n_frames
          and len(stepped) == n_frames,
          f"VapServer: {len(results)} results of {n_frames}, "
          f"{len(stepped)} frames stepped")
    return results, stepped


def overlapped_frames(audio, cfg, n):
    """The frames the servers and Vap cut on the overlapped-frame paths:
    320 zero samples, then frame_samples windows every frame_shift."""
    padded = np.concatenate([np.zeros((2, 320)), audio], axis=1)
    return [padded[:, f * cfg.frame_shift:f * cfg.frame_shift
                   + cfg.frame_samples].astype(np.float32)
            for f in range(n)]


def _max_diff(results, want, keys=("p_now", "p_future", "vad")) -> float:
    return max(np.abs(np.asarray(r[k], np.float64)
                      - np.asarray(w[k], np.float64)).max()
               for r, w in zip(results, want) for k in keys)


def launches_per_frame(got: dict, n: int, what: str) -> int:
    """Checks that a run's launches are 7 K2 (attend) launches a frame
    and nothing else; returns the K2 launches."""
    want = {k: v * n for k, v in per_step("kv").items()}
    check(got == want, f"{what}: launches {got} over {n} frames, expected "
                       f"{want}")
    return got["attend"]


def phase_f_checkpoints(cfg, params_np, tmp) -> int:
    """The reference's .pt checkpoints: load_torch_checkpoint against
    convert_state_dict (bit-equal leaves), and VapEngine(vap_model=,
    cpc_model=) on the card against the same engine on the CPU (12
    frames, atol 1e-4).  Returns the K2 launches of the card's run."""
    import os

    from vap_realtime_tpu_torch.runtime.engine import VapEngine
    from vap_realtime_tpu_torch.weights.convert import (
        _flatten, convert_state_dict, load_torch_checkpoint,
    )
    from vap_realtime_tpu_torch.weights.synthetic import (
        synthetic_audio, synthetic_cpc_weights, synthetic_vap_state_dict,
    )

    vap, cpc = os.path.join(tmp, "vap.pt"), os.path.join(tmp, "cpc.pt")
    sd, cw = synthetic_vap_state_dict(cfg.frame_hz), synthetic_cpc_weights()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, vap)
    torch.save({"weights": {k: torch.from_numpy(v) for k, v in cw.items()}},
               cpc)
    got = _flatten(load_torch_checkpoint(vap, cpc))
    want = _flatten(convert_state_dict(sd, cw))
    check(got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in got),
        "load_torch_checkpoint differs from convert_state_dict")
    eng = {dev: VapEngine(cfg, vap_model=vap, cpc_model=cpc, device=dev)
           for dev in ("cuda", "cpu")}
    for e in eng.values():
        e.warmup()
    frames = overlapped_frames(synthetic_audio(16000, seed=41), cfg, 12)
    outs = {}
    for dev, e in eng.items():
        zero_counts()
        outs[dev] = [e.process(f[0], f[1]) for f in frames]
        if dev == "cuda":
            k2 = launches_per_frame(counts(), len(frames),
                                    "VapEngine(vap_model=, cpc_model=)")
    d = _max_diff(outs["cuda"], outs["cpu"])
    check(d <= 1e-4, f"VapEngine from .pt card vs CPU: max |d| {d:.3e}")
    print(f"[f] .pt checkpoints: {len(got)} leaves bit-equal to "
          f"convert_state_dict; VapEngine(vap_model=, cpc_model=, kv) "
          f"{len(frames)} frames, float32 card vs CPU: max |d| {d:.3e} "
          f"(atol 1e-4), launches {k2} K2", flush=True)
    return k2


def engine_alone_ms(engine, chunks) -> float:
    """Mean ms of engine.process over `chunks` ((2, n) each) run back to
    back in this thread, without a server around it."""
    t0 = time.perf_counter()
    for c in chunks:
        engine.process(c[0], c[1])
    return (time.perf_counter() - t0) / len(chunks) * 1e3


def phase_f_server(cfg, params_np, gpu) -> int:
    """VapServer over loopback, twice: kv float32 against VapEngine on
    the CPU over the same zero-padded frames (atol 1e-4); fast bf16
    against its plain-attend twin on the card (BF16_TOL).  7 K2 launches
    a frame in each.  Beside each run's engine ms per frame in the
    server, the same engine's on the same frames alone.  Returns the K2
    launches."""
    from vap_realtime_tpu_torch.runtime.engine import VapEngine
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    audio = synthetic_audio(16000 * 2, seed=42).astype(np.float64)
    shift = cfg.frame_shift
    fresh = [audio[:, f * shift:(f + 1) * shift] for f in range(F_FRAMES)]
    k2 = 0
    # kv, float32: the card's server against the CPU engine
    eng = VapEngine(cfg, params=params_np, device="cuda")
    eng.warmup()
    zero_counts()
    res, stepped = two_port_serve(eng, audio, F_FRAMES)
    k2 += launches_per_frame(counts(), F_FRAMES, "VapServer kv")
    ms_kv = tick_ms(stepped)
    frames = overlapped_frames(audio, cfg, F_FRAMES)
    alone_kv = engine_alone_ms(eng, frames)
    ref = VapEngine(cfg, params=params_np, device="cpu")
    want = [ref.process(f[0], f[1]) for f in frames]
    d_kv = _max_diff(res, want)
    check(d_kv <= 1e-4, f"VapServer kv card vs CPU: max |d| {d_kv:.3e}")
    echo = max(np.abs(np.asarray(r["x1"])
                      - audio[0, f * shift:(f + 1) * shift]).max()
               for f, r in enumerate(res))
    check(echo == 0, f"VapServer kv audio echo off by {echo}")
    # fast, bf16: kernels against the plain attend, both on the card
    eng = VapEngine(cfg, params=params_np, path="fast", dtype=torch.bfloat16,
                    device="cuda")
    eng.warmup()
    zero_counts()
    res, stepped = two_port_serve(eng, audio, F_FRAMES)
    k2 += launches_per_frame(counts(), F_FRAMES, "VapServer fast bf16")
    ms_fast = tick_ms(stepped)
    alone_fast = engine_alone_ms(eng, fresh)
    twin = VapEngine(cfg, params=params_np, path="fast",
                     dtype=torch.bfloat16, attend_impl="plain",
                     device="cuda")
    want = [twin.process(f[0], f[1]) for f in fresh]
    d_fast = _max_diff(res, want)
    check(d_fast <= BF16_TOL, f"VapServer fast bf16 kernels vs plain: max "
                              f"|d| {d_fast:.3e}")
    print(f"[f] VapServer (two ports, 1 producer, 1 consumer), {F_FRAMES} "
          f"frames each: kv float32 card vs CPU engine max |d| "
          f"{d_kv:.3e} (atol 1e-4); fast bf16 kernels vs plain attend "
          f"max |d| {d_fast:.3e} (atol {BF16_TOL}); 7 K2 launches a frame",
          flush=True)
    print(f"[f] VapServer engine ms per frame: kv float32 {ms_kv:.3f} "
          f"(the engine alone on the same frames {alone_kv:.3f}), fast bf16 "
          f"{ms_fast:.3f} (alone {alone_fast:.3f}) | {gpu}", flush=True)
    return k2


def lockstep_client(port, audio, n_results, out):
    """One stream of BatchedVapServer: a frame's 5 hops, then its result,
    `n_results` times."""
    from vap_realtime_tpu_torch.io import wire

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


def phase_f_batched(cfg, params_np, gpu) -> int:
    """BatchedVapServer, capacity 64, kv, float32: 8 lockstep connections
    of 1 s of audio, each held against a CPU StreamArena stepped on the
    same chunks (atol 1e-4), 7 K2 launches a tick; and a capacity-4
    arena that rejects a fifth connection.  Returns the K2 launches."""
    from vap_realtime_tpu_torch.runtime.arena import StreamArena
    from vap_realtime_tpu_torch.runtime.server_batched import (
        BatchedVapServer,
    )
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    n_conn = 8
    arena = StreamArena(cfg, params_np, capacity=SERVER_CAPACITY,
                        device="cuda")
    arena.warmup()
    srv = BatchedVapServer(arena, port=0)
    srv.start_background()
    audios = [synthetic_audio(16000, seed=50 + i).astype(np.float64)
              for i in range(n_conn)]
    results = [[] for _ in range(n_conn)]
    clients = [threading.Thread(target=lockstep_client,
                                args=(srv.bound_port, audios[i], F_FRAMES,
                                      results[i]))
               for i in range(n_conn)]
    zero_counts()
    with recorded_ticks() as stepped:
        try:
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=60)
        finally:
            srv.stop()
    got = counts()
    check(not any(c.is_alive() for c in clients)
          and all(len(r) == F_FRAMES for r in results),
          f"BatchedVapServer results {[len(r) for r in results]}")
    ticks = len(stepped)
    k2 = launches_per_frame(got, ticks, "BatchedVapServer kv")
    ms = tick_ms(stepped)
    ref = StreamArena(cfg, params_np, capacity=n_conn, device="cpu")
    slots = [ref.add_stream() for _ in range(n_conn)]
    frames = [overlapped_frames(a, cfg, F_FRAMES) for a in audios]
    d = 0.0
    for f in range(F_FRAMES):
        want = ref.step({s: frames[i][f] for i, s in enumerate(slots)})
        d = max(d, _max_diff([results[i][f] for i in range(n_conn)],
                             [want[s] for s in slots]))
    check(d <= 1e-4, f"BatchedVapServer card vs CPU arena: max |d| {d:.3e}")
    # a full arena closes the next connection at once
    small = StreamArena(cfg, params_np, capacity=4, device="cuda")
    srv = BatchedVapServer(small, port=0)
    srv.start_background()
    socks = []
    try:
        for _ in range(4):
            socks.append(socket.create_connection(
                ("127.0.0.1", srv.bound_port), timeout=10))
        deadline = time.time() + 10
        while small.n_active < 4 and time.time() < deadline:
            time.sleep(0.01)
        full = small.n_active == 4
        with socket.create_connection(("127.0.0.1", srv.bound_port),
                                      timeout=10) as extra:
            extra.settimeout(10)
            rejected = extra.recv(1) == b""
    finally:
        for s in socks:
            s.close()
        srv.stop()
    check(full and rejected, "a fifth connection to a full capacity-4 "
                             "BatchedVapServer was not rejected")
    print(f"[f] BatchedVapServer, capacity {SERVER_CAPACITY}, kv float32, "
          f"{n_conn} connections x {F_FRAMES} frames in lockstep: {ticks} "
          f"ticks, card vs CPU StreamArena max |d| {d:.3e} (atol 1e-4), "
          f"launches {got} = 7 K2 a tick; a fifth connection to a "
          f"capacity-4 arena rejected", flush=True)
    print(f"[f] BatchedVapServer host ms per tick (the arena's vap.tick "
          f"span: upload and dispatch, {n_conn} streams of capacity "
          f"{SERVER_CAPACITY}): {ms:.3f} | {gpu}", flush=True)
    return k2


def phase_f_vap(cfg, params_np, tmp, gpu) -> int:
    """api.Vap with two Wav(realtime=False) sources: 10 results on the
    card against Vap(device="cpu") (atol 1e-4); 7 K2 launches a frame.
    Returns the K2 launches."""
    import os

    from vap_realtime_tpu_torch.api import Vap
    from vap_realtime_tpu_torch.io.audio import write_wav
    from vap_realtime_tpu_torch.io.sources import Wav
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    audio = synthetic_audio(16000 * 3, seed=43)
    wavs = [os.path.join(tmp, f"{c}.wav") for c in "lr"]
    for w, a in zip(wavs, audio):
        write_wav(w, a)
    runs, k2 = {}, 0
    for dev in ("cuda", "cpu"):
        vap = Vap(mode="vap", frame_rate=cfg.frame_hz,
                  context_len_sec=cfg.context_len_sec,
                  mic1=Wav(wavs[0], realtime=False),
                  mic2=Wav(wavs[1], realtime=False), params=params_np,
                  device=dev)
        zero_counts()
        vap.start_process()          # warms the engine up: one step
        try:
            runs[dev] = [vap.get_result(timeout=60) for _ in range(10)]
        finally:
            worker = vap._thread
            vap.stop_process()
        check(vap._thread is None and not worker.is_alive(),
              "Vap.stop_process left its worker running")
        if dev == "cuda":
            n = 10 + vap.result_dict_queue.qsize()
            k2 = launches_per_frame(counts(), n + 1, "Vap (with warmup)")
            f = overlapped_frames(audio, cfg, 1)[0]
            for _ in range(3):
                vap.process_vap(f[0], f[1])
            t0 = time.perf_counter()
            for _ in range(20):
                vap.process_vap(f[0], f[1])
            ms = (time.perf_counter() - t0) / 20 * 1e3
    d = _max_diff(runs["cuda"], runs["cpu"])
    check(d <= 1e-4, f"Vap card vs CPU: max |d| {d:.3e}")
    print(f"[f] Vap (kv, float32, two Wav sources): 10 results, card vs "
          f"CPU max |d| {d:.3e} (atol 1e-4), {k2} K2 launches "
          f"({k2 // 7} frames incl. warmup); worker joined", flush=True)
    print(f"[f] Vap.process_vap ms per frame: {ms:.3f} | {gpu}", flush=True)
    return k2


def phase_f_static(cfg, params_np, tmp, gpu) -> None:
    """static_step on the card against the CPU over 10 carried frames
    (atol 1e-4), then torch.export on the card, saved and loaded: equal
    to the eager step at 1e-5."""
    import os

    from vap_realtime_tpu_torch.runtime.static import (
        make_static_fn, static_step,
    )
    from vap_realtime_tpu_torch.tools.export_static import (
        export_artifact, time_calls,
    )
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    ctx = 99
    rs = np.random.RandomState(44)
    xs = (0.1 * rs.randn(10, 2, 1, cfg.frame_samples)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = params_to_torch(params_np, dev)
        _, ex = make_static_fn(cfg, ctx, device=dev)
        ctx1, ctx2, h, c = ex[2:]
        outs[dev] = []
        for x in xs:
            o = static_step(p, torch.from_numpy(x[0]).to(dev),
                            torch.from_numpy(x[1]).to(dev), ctx1, ctx2, h, c,
                            cfg)
            ctx1 = torch.cat([ctx1, o[4][None]], 1)[:, 1:]
            ctx2 = torch.cat([ctx2, o[5][None]], 1)[:, 1:]
            h, c = o[6], o[7]
            outs[dev].append([t.cpu() for t in o])
    d = max((a - b).abs().max().item()
            for fa, fb in zip(outs["cuda"], outs["cpu"])
            for a, b in zip(fa, fb))
    check(d <= 1e-4, f"static_step card vs CPU: max |d| {d:.3e}")
    fn, ex = make_static_fn(cfg, ctx, device="cuda")
    args = (torch.from_numpy(xs[0, 0]).cuda(), torch.from_numpy(xs[0, 1])
            .cuda(), 0.5 * torch.randn_like(ex[2]),
            0.5 * torch.randn_like(ex[3])) + ex[4:]
    t0 = time.perf_counter()
    ep, p, _ = export_artifact(params_np, cfg, ctx, device="cuda")
    path = os.path.join(tmp, "static.pt2")
    torch.export.save(ep, path)
    reloaded = torch.export.load(path).module()
    t_export = time.perf_counter() - t0
    with torch.no_grad():
        want, got = fn(p, *args), reloaded(p, *args)
    d_exp = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(d_exp <= 1e-5, f"exported static step vs eager: max |d| "
                         f"{d_exp:.3e}")
    ms_eager = time_calls(fn, (p,) + args, 20)
    ms_exp = time_calls(reloaded, (p,) + args, 20)
    print(f"[f] static_step (context {ctx}), float32, 10 carried frames "
          f"card vs CPU max |d| {d:.3e} (atol 1e-4); torch.export on the "
          f"card, saved ({os.path.getsize(path)} bytes) and loaded in "
          f"{t_export:.1f} s: vs eager max |d| {d_exp:.3e} (atol 1e-5)",
          flush=True)
    print(f"[f] static step ms per frame: eager {ms_eager:.3f}, exported "
          f"{ms_exp:.3f} | {gpu}", flush=True)


def phase_f(cfg, params_np, gpu) -> int:
    """The serving surfaces (float32 unless stated): .pt checkpoints,
    VapServer, BatchedVapServer, Vap, the static step and its export.
    Returns the K2 launches of its runs."""
    import os
    import tempfile

    t0 = time.time()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        k2 = phase_f_checkpoints(cfg, params_np, tmp)
        k2 += phase_f_server(cfg, params_np, gpu)
        k2 += phase_f_batched(cfg, params_np, gpu)
        k2 += phase_f_vap(cfg, params_np, tmp, gpu)
        phase_f_static(cfg, params_np, tmp, gpu)
    print(f"[f] the serving surfaces: {k2} K2 launches over the counted "
          f"runs, {time.time() - t0:.1f} s", flush=True)
    return k2


# --- slice 10: the training path --------------------------------------------

TRAIN_ROWS, TRAIN_SEC = 16, 20.0   # (g): 8 stereo clips of 20 s, as rows


def train_waveforms(rows: int = TRAIN_ROWS,
                    seconds: float = TRAIN_SEC) -> np.ndarray:
    """(rows, seconds * 16 kHz) float32: the synthetic audio's two
    channels for seeds 0 .. rows / 2 - 1, in stereo order (row 2s is
    clip s's channel 0)."""
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    n = int(seconds * 16000)
    return np.concatenate([synthetic_audio(n, seed=s)
                           for s in range(rows // 2)])


def lstm_train_inputs(params_np):
    """K5's inputs on the training path, on the card: the frozen
    encoder's LSTM gates over the conv features of train_waveforms()
    (16, 1998, 1024) float32, zero state, W_hh^T, b_hh; and (z, the
    LSTM's params) for the yardstick."""
    from vap_realtime_tpu_torch.models.encoder import cpc_conv_stack
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    enc = params_to_torch(params_np["encoder"], "cuda")
    g = enc["lstm"]
    with torch.no_grad():
        z = cpc_conv_stack(enc, torch.from_numpy(train_waveforms()).cuda())
        z = z[:, 1:-1].contiguous()
        gi = torch.matmul(z, g["w_ih"].T) + g["b_ih"]
    h0 = torch.zeros(z.shape[0], C, device="cuda")
    return (gi, h0, h0.clone(), g["w_hh"].T, g["b_hh"]), z, g


def phase_a_lstm_train(params_np) -> dict:
    """Both K5 bodies, the sequence body at both cluster sizes, against
    the plain version, float32, atol 1e-4 over all steps: at the training
    encoder's (16, 1998, 256) (the gates of 20 s clips' conv features,
    zero state), a ragged (20, 1998, 256) (4 more rows, the first clips'
    gates time-reversed: 12 masked rows in the second cluster), (16, 5,
    256) (the first 5 steps) and (1024, 200, 256) (random gates and
    state, where lstm_scan takes clusters of 8 blocks).  lstm_scan takes
    the sequence body at all four.  Returns {launcher: max |d|}."""
    from vap_realtime_tpu_torch.ops.cuda.lstm import lstm_scan_plain
    from vap_realtime_tpu_torch.tools.lstm_bodies import inputs, launchers

    (gi, h0, c0, w, b), _, _ = lstm_train_inputs(params_np)
    gi20 = torch.cat([gi, gi[:4].flip(1)])
    z20 = torch.zeros(20, C, device="cuda")
    cases = {"the training encoder's LSTM": lambda: (gi, h0, c0, w, b),
             "ragged: 12 masked rows": lambda: (gi20, z20, z20.clone(), w,
                                                b),
             "5 steps": lambda: (gi[:, :5].contiguous(), h0, c0, w, b),
             "random, 200 steps": lambda: inputs(1024, 200, torch.float32,
                                                 seed=12)}
    errs = {}
    for case, make in cases.items():
        args = make()
        N, Tn = args[0].shape[:2]
        pick = lstm_pick(N)
        check(pick.startswith("sequence"), f"lstm_scan takes the serving "
              f"body at ({N}, {Tn})")
        with torch.no_grad():
            want = lstm_scan_plain(*args)
            for body, run in launchers().items():
                got = run(*args)
                torch.cuda.synchronize()
                err = 0.0
                for name, a, bb in zip(("ys", "h_T", "c_T"), got, want):
                    check(a.shape == bb.shape
                          and torch.isfinite(a).all().item(),
                          f"lstm_scan {body} ({N}, {Tn}) {name}")
                    err = max(err, (a - bb).abs().max().item())
                check(err <= 1e-4, f"lstm_scan {body} vs plain at ({N}, "
                      f"{Tn}, {C}): max |d| {err:.3e}")
                errs[body] = max(errs.get(body, 0.0), err)
                print(f"[a] lstm_scan {body} body float32 ({N}, {Tn}, {C})"
                      f"{' (lstm_scan takes it)' * (pick == body)} "
                      f"({case}): max |kernel - plain| {err:.3e} "
                      f"(atol 1e-4)", flush=True)
        del args, want, got
    torch.cuda.empty_cache()
    return errs


def time_lstm_train(params_np, gpu) -> dict:
    """K5 at the training shape (16, 1998, 256) float32, both bodies on
    the same inputs, in turns: ms per launch and microseconds a step
    (lstm_scan takes the sequence body: it must be the faster), the
    bound (3xTF32 at 495 TFLOP/s, or the bytes), the plain version, and
    lstm_fused (projection + scan) against torch.nn.LSTM on cuDNN in
    float32 (TF32 off) over the same problem; the port never calls
    nn.LSTM.  Returns {body: its numbers}."""
    from vap_realtime_tpu_torch.ops.cuda.lstm import (
        _launch_serving, lstm_fused, lstm_scan, lstm_scan_plain,
        max_active_clusters,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    args, z, g = lstm_train_inputs(params_np)
    N, Tn, Hh = z.shape
    pick = lstm_pick(N)
    check(pick.startswith("sequence"), f"lstm_scan takes the serving body "
          f"at ({N}, {Tn})")
    cl = int(pick.split()[1])
    runs = {"sequence": lambda: lstm_scan(*args),
            "serving": lambda: _launch_serving(*args)}
    with torch.no_grad():
        t = {k: [] for k in runs}
        for k in ("sequence", "serving", "serving", "sequence"):
            t[k].append(cuda_ms(runs[k], reps=5, warm=1))
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        plain_ms = cuda_ms(lambda: lstm_scan_plain(*args), reps=2, warm=1)
        h0 = args[1]
        net = torch.nn.LSTM(Hh, Hh, batch_first=True).cuda()
        for name, attr in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                           ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
            getattr(net, attr).copy_(g[name])
        net.flatten_parameters()
        fused = lambda: lstm_fused(z, h0, h0, g["w_ih"], g["w_hh"],
                                   g["b_ih"], g["b_hh"])
        lib = lambda: net(z, (h0[None], h0[None]))
        f1, l1, l2, f2 = (cuda_ms(f, reps=5, warm=1)
                          for f in (fused, lib, lib, fused))
        fused_ms, library_ms = (f1 + f2) / 2, (l1 + l2) / 2
        d = (lib()[0] - fused()[0]).abs().max().item()
    check(ms["sequence"] < ms["serving"], f"the sequence body "
          f"({ms['sequence']:.4f} ms) is not faster than the serving body "
          f"({ms['serving']:.4f} ms) at ({N}, {Tn})")
    flops = 2 * N * Tn * Hh * 4 * Hh
    nbytes = (args[0].numel() + N * Tn * Hh + 4 * N * Hh + Hh * 4 * Hh
              + 4 * Hh) * 4
    bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    f32_ms = bound(nbytes, flops)[0]
    res = {}
    for k in ("sequence", "serving"):
        what = (f"cluster {cl}, {max_active_clusters(cl)} clusters at once"
                if k == "sequence" else "64 streams a block")
        print(f"[g] lstm_scan {k} body float32 ({N}, {Tn}, {Hh}) ({what}): "
              f"{ms[k]:.4f} ms/launch ({ms[k] / Tn * 1e3:.3f} us a step), "
              f"bound {bound_ms:.4f} ms ({bound_by}: 3xTF32 "
              f"{3 * flops / 1e9:.2f} GFLOP of TF32 at 495 TFLOP/s; "
              f"{nbytes / 1e9:.3f} GB) = {100 * bound_ms / ms[k]:.2f}% of "
              f"bound; float32 bound {f32_ms:.4f} ms; plain {plain_ms:.4f} "
              f"ms | {gpu}", flush=True)
        res[k] = dict(ms=ms[k], plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms,
                      bound_f32_ms=f32_ms, us_a_step=ms[k] / Tn * 1e3)
    res["sequence"].update(cluster=cl, lstm_fused_ms=fused_ms)
    print(f"[g] lstm_fused (projection + sequence body) {fused_ms:.4f} ms vs "
          f"torch.nn.LSTM (cuDNN, float32, TF32 off) {library_ms:.4f} ms "
          f"(max |nn.LSTM - lstm_fused| {d:.3e}); the sequence body "
          f"{ms['serving'] / ms['sequence']:.1f}x the serving body's speed "
          f"| {gpu}", flush=True)
    del net
    torch.cuda.empty_cache()
    return res


def phase_g_step(cfg, params_np, wav) -> int:
    """One train_step at batch 2 x 20 s, card against CPU (float32, TF32
    off): the loss at 1e-5 relative; the trainable leaves at 1e-6 where
    the CPU gradient is at least 100x Adam's eps (below that, Adam's
    first update amplifies the gradients' rounding; see
    tests/test_torch_train.py), and on EVERY element when the card's
    AdamW takes the CPU's gradients; the frozen leaves bit-equal to
    before.  Returns the card forwards made (1)."""
    from vap_realtime_tpu_torch.train.step import (
        compute_loss, freeze_encoder_mask, make_optimizer,
    )
    from vap_realtime_tpu_torch.weights.convert import (
        params_to_numpy, params_to_torch, tree_items,
    )

    rs = np.random.RandomState(46)
    batch = {"waveform": wav[:4].reshape(2, 2, -1),
             "vad": (rs.rand(2, int((TRAIN_SEC + 2) * cfg.frame_hz), 2)
                     > 0.5).astype(np.float32)}
    res = {}
    for dev in ("cuda", "cpu"):
        p = params_to_torch(params_np, dev)
        opt = make_optimizer(p)
        loss, _ = compute_loss(p, {k: torch.from_numpy(v).to(dev)
                                   for k, v in batch.items()}, cfg)
        loss.backward()
        grads = {k: t.grad.cpu() for k, t in tree_items(p)
                 if t.grad is not None}
        opt.step()
        res[dev] = (loss.item(), grads, dict(tree_items(params_to_numpy(p))))
    fed = params_to_torch(params_np, "cuda")
    opt = make_optimizer(fed)
    for k, t in tree_items(fed):
        if t.requires_grad:
            t.grad = res["cpu"][1][k].cuda()
    opt.step()
    fed = dict(tree_items(params_to_numpy(fed)))
    start = dict(tree_items(params_np))
    mask = dict(tree_items(freeze_encoder_mask(params_np)))
    d_loss = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    check(np.isfinite(res["cuda"][0]) and d_loss <= 1e-5,
          f"train_step loss card {res['cuda'][0]} vs CPU {res['cpu'][0]}")
    d_cond = d_all = d_fed = d_grad = 0.0
    n_cond = n_all = 0
    for k, m in mask.items():
        got, want = res["cuda"][2][k], res["cpu"][2][k]
        if not m:
            check(np.array_equal(got, start[k]), f"frozen leaf {k} moved")
            continue
        g = res["cpu"][1][k].numpy()
        cond = np.abs(g) >= 1e-6
        n_cond, n_all = n_cond + int(cond.sum()), n_all + cond.size
        if cond.any():
            d_cond = max(d_cond, float(np.abs(got - want)[cond].max()))
        d_all = max(d_all, float(np.abs(got - want).max()))
        d_fed = max(d_fed, float(np.abs(fed[k] - want).max()))
        d_grad = max(d_grad, float(np.abs(res["cuda"][1][k].numpy() - g)
                                   .max() / max(np.abs(g).max(), 1e-30)))
    check(d_cond <= 1e-6 and d_fed <= 1e-6,
          f"train_step trainable leaves card vs CPU: {d_cond:.3e} on "
          f"{n_cond} of {n_all} elements, {d_fed:.3e} with the CPU's "
          f"gradients (atol 1e-6)")
    print(f"[g] train_step batch 2 x {TRAIN_SEC:.0f} s card vs CPU: loss "
          f"{res['cuda'][0]:.6f} (rel {d_loss:.2e}); gradients max |d| / "
          f"leaf max {d_grad:.2e}; trainable leaves max |d| {d_cond:.3e} "
          f"on the {n_cond} of {n_all} elements with |g| >= 1e-6 (atol "
          f"1e-6; {d_all:.3e} over all), {d_fed:.3e} when the card's AdamW "
          f"takes the CPU's gradients; frozen leaves bit-equal", flush=True)
    return 1


def turn_taking_vad(duration: float, offset: float):
    """A 7.8 s cycle, started `offset` s before 0: A speaks, pauses 0.4 s
    and goes on (a hold), B takes the turn (a shift), A backchannels 0.3 s
    into B's turn, and B hands the turn back (a shift)."""
    segs, c = [[], []], -offset
    while c < duration + 2.0:
        for ch, a, b in ((0, 0.0, 1.5), (0, 1.9, 3.4), (1, 3.8, 7.4),
                         (0, 5.0, 5.3)):
            if c + b > 0:
                segs[ch].append([round(max(c + a, 0.0), 2), round(c + b, 2)])
        c += 7.8
    return segs


def turn_taking_manifest(tmp: str, n_rows: int, duration: float) -> str:
    """The synthetic manifest with each row's VAD from turn_taking_vad
    (row i offset by 0.5 i s): shift, hold and backchannel events."""
    import csv

    from vap_realtime_tpu_torch.train.data import synthetic_manifest

    path = synthetic_manifest(tmp, n_rows=n_rows, duration=duration)
    with open(path) as f:
        rows = list(csv.reader(f))
    for i, row in enumerate(rows[1:]):
        row[3] = json.dumps(turn_taking_vad(duration, 0.5 * i))
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def phase_g_fit(cfg, tmp) -> int:
    """fit on a 16-row x 20 s synthetic manifest whose VAD gives shift,
    hold and backchannel events, batch 8 (2 steps an epoch), 2 epochs
    with validation, events and checkpoints; resumed from last.npz after
    1 epoch against the uninterrupted run (1e-5); the best checkpoint
    through run_evaluation on the card and on the CPU: the same 19
    metrics, the loss and the turn-taking metrics within 1e-5 relative.
    Returns the card forwards made."""
    import csv
    import os

    from vap_realtime_tpu_torch.train.data import DataConfig
    from vap_realtime_tpu_torch.train.evaluation import run_evaluation
    from vap_realtime_tpu_torch.train.events import EventConfig
    from vap_realtime_tpu_torch.train.trainer import (
        OptConfig, find_best_checkpoint, fit,
    )
    from vap_realtime_tpu_torch.weights.convert import _flatten

    path = turn_taking_manifest(tmp, 16, TRAIN_SEC)
    dc = DataConfig(train_path=path, val_path=path, batch_size=8,
                    audio_duration=TRAIN_SEC, frame_hz=cfg.frame_hz)
    ec = EventConfig(frame_hz=cfg.frame_hz, max_time=TRAIN_SEC)
    logs = []
    run = lambda epochs, d, resume=None: fit(
        cfg, dc, OptConfig(max_epochs=epochs), ec,
        ckpt_dir=os.path.join(tmp, d), resume_from=resume, device="cuda",
        log_fn=logs.append)
    t0 = time.time()
    h2 = run(2, "full")
    t_fit = time.time() - t0
    run(1, "a")
    hr = run(2, "b", os.path.join(tmp, "a", "last.npz"))
    for m in logs:
        print(f"[g] fit: {m}", flush=True)
    check(np.isfinite(h2["train_loss"]) and np.isfinite(h2["val_loss"]),
          f"fit losses {h2['train_loss']} {h2['val_loss']}")
    a, b = _flatten(h2["params"]), _flatten(hr["params"])
    d = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    check(d <= 1e-5 and hr["epoch"] == 1,
          f"resumed fit vs uninterrupted: max |d| {d:.3e}")
    ckpt = find_best_checkpoint(os.path.join(tmp, "full"))
    check(ckpt is not None, "fit saved no best checkpoint")
    rows = {}
    for dev in ("cuda", "cpu"):
        out = run_evaluation(ckpt, cfg, DataConfig(
            test_path=path, batch_size=8, audio_duration=TRAIN_SEC,
            frame_hz=cfg.frame_hz), ec, out_root=os.path.join(tmp, dev),
            device=dev)
        with open(out) as f:
            rows[dev] = {r["metric"]: float(r["value"])
                         for r in csv.DictReader(f)}
    rows, cpu = rows["cuda"], rows["cpu"]
    check(len(rows) == 19 and rows.keys() == cpu.keys()
          and np.isfinite(rows.get("test_loss", float("nan"))),
          f"score.csv card {rows} CPU {cpu}")
    d_metric = max(abs(rows[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)
                   if rows[k] != cpu[k] else 0.0 for k in rows)
    check(d_metric <= 1e-5, f"run_evaluation card vs CPU: max relative "
                            f"|d| {d_metric:.3e}")
    print("[g] run_evaluation metrics on the card: " + ", ".join(
        f"{k[5:]} {v:.4f}" for k, v in sorted(rows.items())), flush=True)
    print(f"[g] fit 2 epochs x 2 steps (batch 8 x {TRAIN_SEC:.0f} s, "
          f"validation with events) in {t_fit:.1f} s: train_loss "
          f"{h2['train_loss']:.4f}, "
          f"val_loss {h2['val_loss']:.4f}; resumed from last.npz after 1 "
          f"epoch vs uninterrupted: max |d| {d:.3e} (atol 1e-5); "
          f"run_evaluation on {os.path.basename(ckpt)}: {len(rows)} "
          f"metrics, test_loss {rows['test_loss']:.4f}, card vs CPU max "
          f"relative |d| {d_metric:.3e} (1e-5)", flush=True)
    # 4 forwards an epoch (2 train, 2 validation); 2 for the evaluation
    return 4 * (2 + 1 + 1) + 2


def phase_g_timing(cfg, params_np, wav, gpu) -> int:
    """ms per train step (batch 8 x 20 s, dropout on; the median after
    the first), ms per eval forward, seconds of stereo audio trained per
    second, peak memory.  Returns the card forwards made."""
    import statistics

    from vap_realtime_tpu_torch.models.vap import VapModel
    from vap_realtime_tpu_torch.train.trainer import (
        OptConfig, make_eval_step, make_train_step, make_tx,
    )

    rs = np.random.RandomState(47)
    B = TRAIN_ROWS // 2
    batch = {"waveform": torch.from_numpy(wav.reshape(B, 2, -1)).cuda(),
             "vad": torch.from_numpy((rs.rand(
                 B, int((TRAIN_SEC + 2) * cfg.frame_hz), 2) > 0.5).astype(
                     np.float32)).cuda()}
    model = VapModel(cfg, params_np, device="cuda")
    step = make_train_step(make_tx(model, OptConfig()), cfg)
    eval_step = make_eval_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, ev = [], []
    for i in range(6):
        t = time.perf_counter()
        step(model, batch, torch.Generator(device="cuda").manual_seed(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for _ in range(4):
        t = time.perf_counter()
        eval_step(model, batch)["loss"].item()
        ev.append((time.perf_counter() - t) * 1e3)
    ms_step, ms_eval = statistics.median(times[1:]), statistics.median(ev[1:])
    print(f"[g] training, VapConfig() ({cfg.channel_layers} + "
          f"{cfg.cross_layers} layers, dim {cfg.dim}, {cfg.frame_hz} Hz), "
          f"batch {B} x {TRAIN_SEC:.0f} s float32: {ms_step:.3f} ms per "
          f"train step (median of 5 after the first, {times[0]:.1f} ms), "
          f"{ms_eval:.3f} ms per eval forward, "
          f"{B * TRAIN_SEC / (ms_step / 1e3):.1f} s of stereo audio trained "
          f"per second, peak memory {peak:.2f} GiB | {gpu}", flush=True)
    return 6 + 4


def phase_g_split(cfg, params_np, wav, gpu) -> int:
    """The train step at batch 8 x 20 s (dropout on) split on the card's
    clock: CUDA events recorded between the conv stack, the gi
    projection, K5, the rest of the forward (downsample, trunk, heads,
    loss), the backward and AdamW, with the encoder's `cpc_conv_stack`
    and `lstm_fused` wrapped to record them (the wrapper repeats
    lstm_fused's two lines); the median of 4 steps after one.  Returns
    the card forwards made."""
    import statistics

    from vap_realtime_tpu_torch.models import encoder as enc_mod
    from vap_realtime_tpu_torch.models.vap import VapModel
    from vap_realtime_tpu_torch.ops.cuda.lstm import lstm_scan
    from vap_realtime_tpu_torch.train.trainer import (
        OptConfig, loss_fn, make_tx,
    )

    rs = np.random.RandomState(48)
    nb = TRAIN_ROWS // 2
    batch = {"waveform": torch.from_numpy(wav.reshape(nb, 2, -1)).cuda(),
             "vad": torch.from_numpy((rs.rand(
                 nb, int((TRAIN_SEC + 2) * cfg.frame_hz), 2) > 0.5).astype(
                     np.float32)).cuda()}
    model = VapModel(cfg, params_np, device="cuda")
    tx = make_tx(model, OptConfig())
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    conv, fused = enc_mod.cpc_conv_stack, enc_mod.lstm_fused

    def conv_marked(*a, **k):
        out = conv(*a, **k)
        mark("conv stack")
        return out

    def fused_marked(x, h0, c0, w_ih, w_hh, b_ih, b_hh):
        gi = torch.matmul(x, w_ih.T) + b_ih
        mark("gi projection")
        out = lstm_scan(gi, h0, c0, w_hh.T, b_hh)
        mark("K5")
        return out

    parts = {}
    enc_mod.cpc_conv_stack, enc_mod.lstm_fused = conv_marked, fused_marked
    try:
        for i in range(5):
            marks.clear()
            mark("start")
            tx.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch, cfg,
                              torch.Generator(device="cuda").manual_seed(i))
            mark("rest of the forward")
            loss.backward()
            mark("backward")
            tx.step()
            mark("AdamW")
            torch.cuda.synchronize()
            if i == 0:
                continue
            for (_, a), (name, b) in zip(marks, marks[1:]):
                parts.setdefault(name, []).append(a.elapsed_time(b))
            parts.setdefault("step", []).append(
                marks[0][1].elapsed_time(marks[-1][1]))
    finally:
        enc_mod.cpc_conv_stack, enc_mod.lstm_fused = conv, fused
    med = {k: statistics.median(v) for k, v in parts.items()}
    check(set(med) == {"conv stack", "gi projection", "K5",
                       "rest of the forward", "backward", "AdamW", "step"},
          f"the train step split saw {sorted(med)}")
    print(f"[g] the train step split, batch {nb} x {TRAIN_SEC:.0f} s "
          f"float32, ms (median of 4 after 1, CUDA events): " + ", ".join(
              f"{k} {v:.3f}" for k, v in med.items() if k != "step")
          + f"; the step {med['step']:.3f} | {gpu}", flush=True)
    return 5


def phase_g(cfg, params_np, gpu) -> dict:
    """The training path on the card at VapConfig() (full width,
    synthetic weights): encode_sequence card vs CPU, one train_step card
    vs CPU, fit / resume / run_evaluation, the step's times; K5 launches
    once per forward over the phase, on the sequence body; the train
    step split.  Returns {"launches": K5 launches, "sequence" / "serving":
    each body's, "k5": both bodies' times at the training shape}."""
    import os
    import tempfile

    from vap_realtime_tpu_torch.models.encoder import encode_sequence
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    t0 = time.time()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # for the resume check
    wav = train_waveforms()
    zero_counts()
    e = {}
    for dev in ("cuda", "cpu"):
        enc = params_to_torch(params_np["encoder"], dev)
        e[dev] = encode_sequence(enc, torch.from_numpy(wav).to(dev),
                                 cfg.downsample_kernel).detach().cpu()
    d = (e["cuda"] - e["cpu"]).abs().max().item()
    n_frames = (wav.shape[1] // 160 - 2) // cfg.downsample_kernel
    check(tuple(e["cuda"].shape) == (TRAIN_ROWS, n_frames, cfg.dim)
          and torch.isfinite(e["cuda"]).all().item() and d <= 1e-4,
          f"encode_sequence card vs CPU: max |d| {d:.3e}")
    print(f"[g] encode_sequence {tuple(wav.shape)} -> "
          f"{tuple(e['cuda'].shape)} card vs CPU: max |d| {d:.3e} (atol "
          f"1e-4)", flush=True)
    forwards = 1 + phase_g_step(cfg, params_np, wav)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        forwards += phase_g_fit(cfg, tmp)
    forwards += phase_g_timing(cfg, params_np, wav, gpu)
    forwards += phase_g_split(cfg, params_np, wav, gpu)
    got = counts()
    launches = got["lstm"]
    check(launches == forwards and got["lstm_seq"] == forwards
          and got["lstm_srv"] == 0,
          f"K5 launched {launches} times ({got['lstm_seq']} sequence body, "
          f"{got['lstm_srv']} serving body) over {forwards} forwards on the "
          f"card")
    torch.backends.cudnn.deterministic = deterministic
    k5 = time_lstm_train(params_np, gpu)
    print(f"[g] the training path: {launches} K5 launches, all on the "
          f"sequence body, over {forwards} forwards, "
          f"{time.time() - t0:.1f} s", flush=True)
    return {"launches": launches, "sequence": got["lstm_seq"],
            "serving": got["lstm_srv"], "k5": k5}


# --- slice 11: the serving tools under load ---------------------------------

H_STREAMS = (1024, 4096)           # (ii): the serving bench's stream counts
H_SECONDS = 10                     # (ii): seconds a load-generator run
H_FRACTIONS = (0.25, 0.5, 0.9)     # (iii): of the capacity (i) predicts
H_CHUNK = 4096                     # (iii): streams an encoder sub-batch
# (iii): fast-path caches probed: (hbm_budget label, capacity_probe flags)
H_CACHES = {"bf16": ("bf16", []),
            "q8g": ("int8 frozen scales (q8g)", ["--q8g"])}


def phase_h_budget() -> dict:
    """(i) hbm_budget against the card's total memory: the table, and
    the fast path's rows of the bf16 and q8g caches."""
    from vap_realtime_tpu_torch.tools import hbm_budget

    rows = hbm_budget.main([])
    gib = torch.cuda.get_device_properties(0).total_memory / 1024**3
    fast = {r["label"]: r for r in rows if r["path"] == "fast"}
    pred = {name: fast[label] for name, (label, _) in H_CACHES.items()}
    for name, r in pred.items():
        check(r["staged_cap"] > 4 * H_CHUNK, f"hbm_budget: {name} holds "
              f"{r['staged_cap']} staged streams")
        print(f"[h] (i) hbm_budget fast {name}: {r['bytes']:,} B/stream "
              f"({r['staged_bytes']:,} staged) -> {r['cap']:,} streams "
              f"({r['staged_cap']:,} staged) in {gib:.2f} GiB", flush=True)
    return pred


def phase_h_serving(gpu) -> dict:
    """(ii) the serving bench: the native server on the card (fast path,
    the attend kernel, staged slots, bf16, int16 wire) under the native
    load generator at H_STREAMS streams for H_SECONDS s each, with the
    bf16 cache (K2), the int8 cache with frozen scales (K3) and the host
    stub (the host leg alone: no launch).  Every connection accepted,
    results on each run, and 7 attend launches per tick (the served ticks
    and the arena's two warm-up ticks a run), the counters zeroed just
    before and read just after each bench.  Returns {cache: (report,
    launches)}."""
    from vap_realtime_tpu_torch.tools import serving_bench

    out = {}
    for name, extra, kernel in (("bf16", [], "K2"),
                                ("q8g", ["--quant_cache", "global"], "K3"),
                                ("stub", ["--stub_device"], None)):
        zero_counts()
        rep = serving_bench.main(
            ["--streams", ",".join(map(str, H_STREAMS)),
             "--seconds", str(H_SECONDS), "--engine_path", "fast",
             "--attend_impl", "kernel", "--slots", "staged"] + extra)
        got = counts()
        runs = rep["runs"]
        ticks = sum(r["ticks"] for r in runs)
        want = {k: v * (ticks + 2 * len(runs)) * bool(kernel)
                for k, v in per_step("bf16").items()}
        check(got == want and (got["attend"] > 0 or not kernel),
              f"serving bench {name}: launches {got}, expected {want} "
              f"over {ticks} ticks + 2 warm-up ticks a run")
        for r in runs:
            check(r["connected"] == r["streams"] and r["send_errs"] == 0,
                  f"serving bench {name} at {r['streams']} streams: "
                  f"{r['connected']} connected, {r['send_errs']} send "
                  f"errors")
            check(r["results"] > 0 and r["latency_ms"]["n"] > 0,
                  f"serving bench {name} at {r['streams']} streams: "
                  f"{r['results']} results")
            print(f"[h] (ii) serving bench fast {name} "
                  f"({kernel or 'host leg alone'}), {r['streams']} streams x "
                  f"{H_SECONDS} s: {r['results_per_sec']} results/s of "
                  f"{r['expected_per_sec']} (realtime {r['realtime']}), "
                  f"latency p50 {r['latency_ms']['p50']} / p90 "
                  f"{r['latency_ms']['p90']} / p99 {r['latency_ms']['p99']} "
                  f"/ max {r['latency_ms']['max']} ms, server ms per tick "
                  f"{r['server_ms_per_tick']} over {r['ticks']} ticks, "
                  f"{r['late_drops']} late drops, "
                  f"{r['result_ticks_dropped']} result ticks dropped, "
                  f"backlog {r['backlog_frames']}, {r['sent_hops']} hops "
                  f"sent of {r['streams'] * 100 * H_SECONDS}, CPU s "
                  f"{r['cpu_s']} | {gpu}", flush=True)
        print(f"[h] (ii) serving bench fast {name}: sustained_streams "
              f"{rep['sustained_streams']}, launches {got} | "
              f"{json.dumps(rep['config'])}", flush=True)
        out[name] = (rep, got["attend"])
    return out


def phase_h_capacity(pred: dict, gpu) -> dict:
    """(iii) the capacity probe of the fast path (staged slots, the attend
    kernel, bf16 state) with the bf16 cache and with --q8g, at
    H_FRACTIONS of the staged capacity (i) predicts, rounded down to
    whole H_CHUNK-stream encoder sub-batches (--conv_chunks B / H_CHUNK:
    the encoder's transient memory stays that of 4096 streams), each in
    its own process, --ticks 5.  A 0.25x probe must fit; a larger one
    that does not is printed as a finding.  Returns {(cache, fraction):
    the probe's result}."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    print(f"[h] (iii) this process holds "
          f"{torch.cuda.memory_reserved() / 1024**3:.2f} GiB of the card "
          f"({torch.cuda.memory_allocated() / 1024**3:.2f} GiB allocated) "
          f"while the probes run", flush=True)
    out = {}
    for name, (label, flags) in H_CACHES.items():
        cap = pred[name]["staged_cap"]
        for frac in H_FRACTIONS:
            batch = int(cap * frac) // H_CHUNK * H_CHUNK
            cmd = [sys.executable, "-m",
                   "vap_realtime_tpu_torch.tools.capacity_probe",
                   "--batch", str(batch), "--ticks", "5",
                   "--conv_chunks", str(batch // H_CHUNK)] + flags
            t = time.time()
            r = subprocess.run(cmd, cwd=root, capture_output=True,
                               text=True, timeout=600)
            check(r.returncode == 0, f"capacity_probe {name} B={batch} exit "
                                     f"{r.returncode}: {r.stderr[-3000:]}")
            res = json.loads(r.stdout.strip().splitlines()[-1])
            check(res["ok"] or frac > 0.25,
                  f"capacity_probe {name} at 0.25x ({batch} streams) does "
                  f"not fit: {res.get('error')}")
            if res["ok"]:
                peak = res.get("max_memory_allocated_gib")
                what = (f"fits: {res['ms_per_step']} ms per step, "
                        f"{res['streams_if_realtime']:,} streams if "
                        f"realtime, peak {peak} GiB allocated")
            else:
                what = f"FINDING: does not fit ({res['error'][:200]})"
            print(f"[h] (iii) capacity_probe fast {name} at {frac}x of "
                  f"{cap:,} = {batch:,} streams (conv_chunks "
                  f"{batch // H_CHUNK}): {what}; {time.time() - t:.1f} s | "
                  f"{gpu}", flush=True)
            out[(name, frac)] = res
    return out


def phase_h_client(cfg, params_np) -> int:
    """(iv) the port's wav client into a VapServer on a CUDA
    VapEngine(path="kv") (float32), the console client reading the framed
    results in its own process: every frame's result printed, finite; 7
    K2 launches a frame (counters zeroed just before the wav client
    runs).  Returns the K2 launches."""
    import os
    import subprocess
    import tempfile

    from vap_realtime_tpu_torch.clients.input_wav import main as wav_main
    from vap_realtime_tpu_torch.io.audio import write_wav
    from vap_realtime_tpu_torch.runtime.engine import VapEngine
    from vap_realtime_tpu_torch.runtime.server import VapServer
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    engine = VapEngine(cfg, params=params_np, path="kv", device="cuda")
    engine.warmup()
    audio = synthetic_audio(16000 * 2, seed=11)
    hops = len(range(0, audio.shape[1] - 160, 160))
    frames = (320 + hops * 160 - cfg.frame_samples) // cfg.frame_shift + 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_cmd = s.getsockname()[1]
    srv = VapServer(engine, port_in=0, port_out=0)
    srv.start_background()
    console = subprocess.Popen(
        [sys.executable, "-m", "vap_realtime_tpu_torch.clients.output_console",
         "--port_num", str(srv.port_out), "--print_every", "1"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with recorded_ticks() as stepped:
        try:
            deadline = time.time() + 60
            while not srv.clients and time.time() < deadline:
                time.sleep(0.05)
            check(len(srv.clients) == 1,
                  "the console client did not connect")
            with tempfile.TemporaryDirectory() as tmp:
                left = os.path.join(tmp, "l.wav")
                right = os.path.join(tmp, "r.wav")
                write_wav(left, audio[0], 16000)
                write_wav(right, audio[1], 16000)
                zero_counts()
                wav_main(["--port_num", str(srv.port_in),
                          "--command_port_num", str(port_cmd),
                          "--input_wav_left", left,
                          "--input_wav_right", right])
            deadline = time.time() + 30
            while engine.state.step < frames and time.time() < deadline:
                time.sleep(0.05)
            time.sleep(0.5)          # the last results reach the console
        finally:
            srv.stop()
            try:
                out, err = console.communicate(timeout=30)
            finally:
                console.kill()
    got = counts()
    check(len(stepped) == frames,
          f"VapServer stepped {len(stepped)} of {frames} frames")
    k2 = launches_per_frame(got, frames, "input_wav -> VapServer kv")
    lines = [ln for ln in out.splitlines() if ln.startswith("t=")]
    # "t=... p_now=[a, b] p_future=[a, b] vad=[a, b]": six values a line
    vals = [float(v) for ln in lines
            for v in re.findall(r"[-\w.]+(?=[,\]])", ln)]
    check(console.returncode == 0 and len(lines) == frames
          and len(vals) == 6 * frames and np.isfinite(vals).all(),
          f"output_console: exit {console.returncode}, {len(lines)} "
          f"results of {frames}, {len(vals)} values: {err[-2000:]}")
    print(f"[h] (iv) input_wav (2 s, {hops} hops) -> VapServer on "
          f"VapEngine(path='kv', cuda, float32) -> output_console: "
          f"{len(lines)} results of {frames} frames, all finite; {k2} K2 "
          f"launches (7 a frame); engine "
          f"{tick_ms(stepped):.3f} ms a frame",
          flush=True)
    return k2


def phase_h(cfg, params_np, gpu) -> dict:
    """The serving tools under load and a client on the card: (i)
    hbm_budget, (ii) serving_bench, (iii) capacity_probe, (iv) input_wav
    -> VapServer -> output_console.  Returns {"k2": K2 launches, "k3":
    K3 launches} of the counted runs."""
    import os
    import subprocess

    t0 = time.time()
    nproc = subprocess.run(["nproc"], capture_output=True, text=True,
                           check=True).stdout.strip()
    print(f"[h] host: nproc {nproc}, os.cpu_count() {os.cpu_count()} (the "
          f"server and the load generator share them)", flush=True)
    t = time.time()
    pred = phase_h_budget()
    print(f"[h] (i) {time.time() - t:.1f} s", flush=True)
    t = time.time()
    serving = phase_h_serving(gpu)
    print(f"[h] (ii) {time.time() - t:.1f} s", flush=True)
    t = time.time()
    phase_h_capacity(pred, gpu)
    print(f"[h] (iii) {time.time() - t:.1f} s", flush=True)
    t = time.time()
    k2_client = phase_h_client(cfg, params_np)
    print(f"[h] (iv) {time.time() - t:.1f} s", flush=True)
    print(f"[h] the serving tools under load: {time.time() - t0:.1f} s",
          flush=True)
    return {"k2": serving["bf16"][1] + k2_client, "k3": serving["q8g"][1]}


# --- slice 12: the export and checkpoint tools and the labs ----------------

I_ITERS = 24                       # the labs' timed iterations


def phase_i_encoder(gpu) -> dict:
    """(1) encoder_lab at 2B channel-streams, 20 Hz, bf16, all four
    impls: ms per step each, finite; K6 launched 5 a step under normk
    and K7 one call a step under fused (the lab's 2 warm-up steps and
    I_ITERS timed ones; the counters zeroed just before and read just
    after).  Returns {"norm": K6 launches, "fused": K7 calls}."""
    from vap_realtime_tpu_torch.tools import encoder_lab

    zero_counts()
    ms = encoder_lab.main(["--impls", "conv,normk,blocked,fused",
                           "--batch", str(2 * B), "--hz", "20", "--dtype",
                           "bf16", "--iters", str(I_ITERS)])
    got = counts()
    steps = I_ITERS + 2
    check(all(np.isfinite(v) and v > 0 for v in ms.values()) and len(ms) == 4,
          f"encoder_lab times {ms}")
    check(got["norm"] == 5 * steps and got["fused"] == steps,
          f"encoder_lab: {got['norm']} K6 launches, {got['fused']} K7 calls "
          f"over {steps} steps of each")
    print(f"[i] (1) encoder_lab, {2 * B} channel-streams x {L_NEW} samples, "
          f"bf16, ms/step: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         ms.items())
          + f"; K6 {got['norm']} launches (5 a step), K7 {got['fused']} "
          f"calls (1 a step) over {steps} steps | {gpu}", flush=True)
    return {"norm": got["norm"], "fused": got["fused"]}


def phase_i_roofline(gpu) -> None:
    """(2) roofline at B = 4096, bf16: the measured matmul peak and each
    component's ms, TFLOP/s, % of peak (the tool raises above 105%) and
    GB/s."""
    from vap_realtime_tpu_torch.tools import roofline

    res = roofline.main(["--batch", str(B), "--dtype", "bf16", "--iters",
                         str(I_ITERS)])
    peak = res.pop("peak_tflops")
    check(np.isfinite(peak) and all(
        np.isfinite(v) and v > 0 for r in res.values() for v in r.values()),
        f"roofline {res}")
    print(f"[i] (2) roofline B={B} bf16: peak {peak:.1f} TFLOP/s "
          f"(4096^3 matmuls); " + "; ".join(
              f"{k} {r['ms']:.3f} ms, {r['tflops']:.1f} TFLOP/s, "
              f"{r['pct_peak']:.1f}% of peak, {r['gbs']:.0f} GB/s"
              for k, r in res.items()) + f" | {gpu}", flush=True)


def phase_i_scatter(gpu) -> None:
    """(3) scatter_lab at 4096 / 50 / 8: the five write forms' ms per
    frame."""
    from vap_realtime_tpu_torch.tools import scatter_lab

    res = scatter_lab.main(["--batch", str(B), "--T", str(T), "--S", str(S)])
    check(len(res) == 5 and all(np.isfinite(v) and v > 0
                                for v in res.values()), f"scatter {res}")
    print(f"[i] (3) scatter_lab B={B} T={T} S={S}, ms per frame: "
          + ", ".join(f"{k} {v:.4f}" for k, v in res.items())
          + f" | {gpu}", flush=True)


def _max_out_diff(a, b) -> float:
    return max((x.cpu() - y.cpu()).abs().max().item() for x, y in zip(a, b))


def phase_i_static(cfg, params_np, tmp, gpu) -> None:
    """(4a) the export tool on the card, float32, TF32 off: the static
    (99) and --dynamic programs, saved and loaded, against the eager step
    on the card (1e-5) and the CPU's (1e-4); the dynamic one at T = 8 and
    24 from one program."""
    import os

    from vap_realtime_tpu_torch.runtime.static import make_static_fn
    from vap_realtime_tpu_torch.tools import export_static
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    p = {d: params_to_torch(params_np, d) for d in ("cuda", "cpu")}
    fn, _ = make_static_fn(cfg, 99, device="cpu")
    lines = []
    for flag, lengths in (("", (99,)), ("--dynamic", (8, 24))):
        out = os.path.join(tmp, "static" + flag.replace("-", "_"))
        t0 = time.perf_counter()
        export_static.main(["--synthetic_weights", "--out", out]
                           + ([flag] if flag else []))
        prog = torch.export.load(out + ".pt2").module()
        t_export = time.perf_counter() - t0
        for Tn in lengths:
            rs = np.random.RandomState(Tn)
            x = (0.1 * rs.randn(2, 1, cfg.frame_samples)).astype(np.float32)
            ctx = (0.5 * rs.randn(2, 1, Tn, cfg.dim)).astype(np.float32)
            hc = (0.1 * rs.randn(2, 2, cfg.dim)).astype(np.float32)
            args = [torch.from_numpy(a) for a in (x[0], x[1], ctx[0], ctx[1],
                                                  hc[0], hc[1])]
            with torch.no_grad():
                got = prog(p["cuda"], *[a.cuda() for a in args])
                eager = fn(p["cuda"], *[a.cuda() for a in args])
                cpu = fn(p["cpu"], *args)
            d_eager, d_cpu = _max_out_diff(got, eager), _max_out_diff(got, cpu)
            check(got[2].shape == (Tn,) and d_eager <= 1e-5 and d_cpu <= 1e-4,
                  f"exported {flag or 'static'} T={Tn}: vs eager "
                  f"{d_eager:.3e}, vs CPU {d_cpu:.3e}")
            lines.append(f"{flag or 'static'} T={Tn}: vs eager {d_eager:.3e},"
                         f" vs CPU {d_cpu:.3e}")
        lines[-1] += f" (exported, saved, loaded in {t_export:.1f} s)"
    print(f"[i] (4a) export_static on the card, float32: " + "; ".join(lines)
          + f" (atol 1e-5 / 1e-4) | {gpu}", flush=True)


def phase_i_offline(params_np, tmp, gpu) -> None:
    """(4b) vap_offline_exported on the card over a 3 s synthetic stereo
    wav (a static program of 20 context frames) against
    runtime/offline.py (full path, 20 context frames) on the card: the
    same time column, the last frames within 2e-5."""
    import os

    from vap_realtime_tpu_torch.config import VapConfig
    from vap_realtime_tpu_torch.io.audio import write_wav
    from vap_realtime_tpu_torch.runtime.offline import run_offline
    from vap_realtime_tpu_torch.tools import export_static, vap_offline_exported
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    audio = synthetic_audio(3 * 16000)
    wavs = []
    for ch in range(2):
        wavs.append(os.path.join(tmp, f"ch{ch}.wav"))
        write_wav(wavs[-1], audio[ch], 16000)
    out = os.path.join(tmp, "ctx20")
    export_static.main(["--synthetic_weights", "--out", out,
                        "--context_frames", "20"])
    t0 = time.perf_counter()
    n = vap_offline_exported.main(
        ["--artifact", out + ".pt2", "--params", out + ".npz",
         "--input_wav_left", wavs[0], "--input_wav_right", wavs[1],
         "--filename_output", out + ".csv"])
    t_run = time.perf_counter() - t0
    got = np.loadtxt(out + ".csv", delimiter=",", skiprows=1)
    ref = run_offline(params_np, audio, VapConfig(frame_hz=20,
                                                  context_len_sec=1.0),
                      path="full", device="cuda")
    d = max(np.abs(got[-3:, 1:3] - ref["p_now"][-3:]).max(),
            np.abs(got[-3:, 3:5] - ref["p_future"][-3:]).max())
    check(n == len(ref["t"]) == got.shape[0]
          and np.array_equal(got[:, 0], ref["t"]) and d <= 2e-5,
          f"vap_offline_exported: {n} rows, last frames vs offline {d:.3e}")
    print(f"[i] (4b) vap_offline_exported on the card: {n} frames in "
          f"{t_run:.2f} s ({t_run / n * 1e3:.2f} ms a frame), last 3 vs "
          f"runtime/offline.py max |d| {d:.3e} (atol 2e-5) | {gpu}",
          flush=True)


def phase_i_web(tmp, gpu) -> None:
    """(4c) export_web with its fixture on the card against the same
    export on the CPU: weights.bin byte-equal, the manifest equal but for
    `expected`, which is within 1e-5."""
    import os

    from vap_realtime_tpu_torch.tools import export_web

    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = export_web.main(["--synthetic_weights", "--out",
                                    os.path.join(tmp, "web_" + dev),
                                    "--device", dev])
    blobs, man = {}, {}
    for dev, d in out.items():
        with open(os.path.join(d, "weights.bin"), "rb") as f:
            blobs[dev] = f.read()
        with open(os.path.join(d, "manifest.json")) as f:
            man[dev] = json.load(f)
    exp = {dev: man[dev]["selftest"].pop("expected") for dev in man}
    d = max(float(np.abs(np.asarray(exp["cuda"][k])
                         - np.asarray(exp["cpu"][k])).max())
            for k in exp["cpu"])
    check(blobs["cuda"] == blobs["cpu"] and man["cuda"] == man["cpu"]
          and d <= 1e-5, f"export_web card vs CPU: expected max |d| {d:.3e}")
    print(f"[i] (4c) export_web (context 99): weights.bin "
          f"{len(blobs['cuda']):,} bytes equal to the CPU export's, the "
          f"fixture on the card vs the CPU max |d| {d:.3e} (atol 1e-5) | "
          f"{gpu}", flush=True)


def phase_i_convert(tmp) -> None:
    """(4d) convert_checkpoint on the synthetic .pt files: the npz
    bit-equal to convert_state_dict on the raw arrays."""
    import os

    from vap_realtime_tpu_torch.tools import convert_checkpoint
    from vap_realtime_tpu_torch.weights.convert import (
        _flatten, convert_state_dict,
    )
    from vap_realtime_tpu_torch.weights.synthetic import (
        synthetic_cpc_weights, synthetic_vap_state_dict,
    )

    vap, cpc, out = (os.path.join(tmp, f) for f in ("v.pt", "c.pt", "w.npz"))
    torch.save({k: torch.from_numpy(v)
                for k, v in synthetic_vap_state_dict(20).items()}, vap)
    torch.save({"weights": {k: torch.from_numpy(v)
                            for k, v in synthetic_cpc_weights().items()}},
               cpc)
    n = convert_checkpoint.main(["--vap_model", vap, "--cpc_model", cpc,
                                 "--out", out])
    want = _flatten(convert_state_dict(synthetic_vap_state_dict(20),
                                       synthetic_cpc_weights()))
    with np.load(out) as got:
        same = sorted(got.files) == sorted(want) and all(
            np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype
            for k in want)
    check(same and n == sum(v.size for v in want.values()),
          "convert_checkpoint npz vs convert_state_dict")
    print(f"[i] (4d) convert_checkpoint: {len(want)} arrays, {n:,} params, "
          f"bit-equal to convert_state_dict", flush=True)


def phase_i(cfg, params_np, gpu) -> dict:
    """The labs and the export and checkpoint tools on the card: (1)
    encoder_lab, (2) roofline, (3) scatter_lab, (4) export_static (static
    and --dynamic), vap_offline_exported, export_web, convert_checkpoint.
    Each sub-phase's seconds print.  Returns the encoder lab's K6 / K7
    launches."""
    import os
    import tempfile

    t0 = time.time()
    t = time.time()
    lab = phase_i_encoder(gpu)
    print(f"[i] (1) {time.time() - t:.1f} s", flush=True)
    t = time.time()
    phase_i_roofline(gpu)
    print(f"[i] (2) {time.time() - t:.1f} s", flush=True)
    t = time.time()
    phase_i_scatter(gpu)
    print(f"[i] (3) {time.time() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        for name, run in (("4a", lambda: phase_i_static(cfg, params_np, tmp,
                                                        gpu)),
                          ("4b", lambda: phase_i_offline(params_np, tmp,
                                                         gpu)),
                          ("4c", lambda: phase_i_web(tmp, gpu)),
                          ("4d", lambda: phase_i_convert(tmp))):
            t = time.time()
            run()
            print(f"[i] ({name}) {time.time() - t:.1f} s", flush=True)
    print(f"[i] the labs and the export tools: {time.time() - t0:.1f} s",
          flush=True)
    return lab


UPLOAD_STREAMS, UPLOAD_TICKS = 8192, 64
UPLOAD_GBPS = 40.0                 # a piece's copy: PCIe Gen5 x16's pace


def _upload_serving(name: str, streams: int, seed: int,
                    device: str = "cuda"):
    """The benchmark's serving call for cell `name` at `streams` streams
    (a small audio pool), after 3 frozen ticks."""
    from vapbench.common import load_config, load_workload
    from vapbench.serving import Serving

    wl = load_workload(name)
    wl = dict(wl, audio=dict(wl["audio"], clips=4, seconds=4))
    sv = Serving(wl, load_config(wl["config"]), seed, device,
                 streams=streams)
    sv.frozen_ticks(3)
    return sv


def _upload_ticks(sv, ticks: int, sat: bool, at: int = 0):
    """`ticks` ticks from tick `at`, fresh frames each: open (dispatch,
    collect) or sat (dispatch tick k, then collect k - 1).  Returns per
    tick (digest of every field of every stream, 64 streams' fields)."""
    import hashlib

    out = []

    def take(host, ev):
        if ev is not None:
            ev.synchronize()
        mats = [host[k].numpy().reshape(sv.N, -1) for k in sv.fields]
        m = np.ascontiguousarray(np.concatenate(mats, axis=1))
        out.append((hashlib.sha256(m.tobytes()).hexdigest()[:16],
                    torch.from_numpy(m[:: sv.N // 64].copy())))

    prev = None
    for k in range(at, at + ticks):
        sv.audio.fill(k, sv.frames[k % 3])
        cur = sv.dispatch(k)
        if not sat:
            take(*cur)
            continue
        if prev is not None:
            take(*prev)
        prev = cur
    if prev is not None:
        take(*prev)
    return out


def _upload_trace(gpu) -> dict:
    """3 profiled open-loop ticks at the nod 5 Hz cell's streams: per
    piece its copy's GB/s, and for piece j >= 1 the share of its copy
    under K7's body calls 0 .. j - 1 (first launch to last)."""
    from torch.autograd import DeviceType

    from vapbench.common import load_workload

    N = load_workload("nod5-fast-open")["streams"]
    sv = _upload_serving("nod5-fast-open", N, 2 ** 33 + 9)
    ticks = 3
    for k in range(2):
        sv.audio.fill(k, sv.frames[k % 3])
        sv.collect(*sv.dispatch(k))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for k in range(2, 2 + ticks):
            sv.audio.fill(k, sv.frames[k % 3])
            sv.collect(*sv.dispatch(k))
        torch.cuda.synchronize()
    sv.free()
    dev = [(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    piece_bytes = N * 2 * 800 * 2
    # the frame pieces: the host->device copies over 100 us (the active
    # mask's copy is N bytes, a few us)
    copies = sorted((s, e) for n, s, e in dev
                    if "HtoD" in n and e - s > 100)
    k7 = sorted((s, e) for n, s, e in dev
                if "conv0_kernel" in n or "conv_layer_kernel" in n)
    check(len(copies) == 4 * ticks and len(k7) == 20 * ticks,
          f"upload trace: {len(copies)} piece copies and {len(k7)} K7 "
          f"launches over {ticks} ticks, expected {4 * ticks} and "
          f"{20 * ticks}")
    calls = [(k7[i][0], k7[i + 4][1]) for i in range(0, len(k7), 5)]
    gbps = [piece_bytes / ((e - s) * 1e-6) / 1e9 for s, e in copies]
    under = []
    for t in range(ticks):
        for j in range(1, 4):
            cs, ce = copies[4 * t + j]
            ks, ke = calls[4 * t][0], calls[4 * t + j - 1][1]
            under.append(max(0.0, min(ce, ke) - max(cs, ks)) / (ce - cs))
    exposed = [(calls[4 * t][0] - copies[4 * t][0]) * 1e-3
               for t in range(ticks)]
    print(f"[upload] nod 5 Hz, {N} streams, {ticks} profiled ticks: piece "
          f"copies {piece_bytes / 1e6:.1f} MB at "
          + ", ".join(f"{g:.1f}" for g in gbps) + " GB/s; share of piece "
          "j's copy under K7's body calls before j (j = 1..3): "
          + ", ".join(f"{u:.3f}" for u in under) + "; first copy's start "
          "to K7's first launch " + ", ".join(f"{x:.3f}" for x in exposed)
          + f" ms | {gpu}", flush=True)
    check(min(gbps) >= UPLOAD_GBPS, f"upload trace: a piece's copy at "
          f"{min(gbps):.1f} GB/s, under {UPLOAD_GBPS}")
    check(min(under) > 0, f"upload trace: a piece's copy does not overlap "
          f"K7's earlier body calls (shares {under})")
    return dict(gbps=gbps, under=under, exposed_ms=exposed)


def phase_upload(gpu, save=None, ref=None, trace=False) -> dict:
    """The fenced upload against another build (`--upload`, see the
    module docstring).  Returns {cell: {ticks, pieces, equal}}."""
    import os

    from vap_realtime_tpu_torch.runtime.arena import StreamArena

    out = {}
    for name in SYNC_CELLS:
        sv = _upload_serving(name, UPLOAD_STREAMS, 2 ** 33 + 7)
        pieces0 = getattr(StreamArena, "upload_pieces", None)
        got = _upload_ticks(sv, UPLOAD_TICKS, sat=False)
        got += _upload_ticks(sv, UPLOAD_TICKS, sat=True, at=UPLOAD_TICKS)
        sv.free()
        ticks = len(got)
        res = dict(ticks=ticks)
        line = f"{ticks} ticks (open, then sat)"
        if pieces0 is not None:
            res["pieces"] = (StreamArena.upload_pieces - pieces0) / ticks
            want = 4 if sv.vcfg.frame_hz == 5 else 1
            check(res["pieces"] == want, f"{name}: "
                  f"{res['pieces']} upload pieces a tick, expected {want}")
            line += f", {res['pieces']:g} upload piece(s) a tick"
        path = lambda d: os.path.join(d, f"upload_{name}.pt")
        if save:
            os.makedirs(save, exist_ok=True)
            torch.save(got, path(save))
        if ref:
            theirs = torch.load(path(ref))
            check(len(theirs) == ticks, f"{name}: {len(theirs)} reference "
                  f"ticks, {ticks} here")
            same = [a[0] == b[0] for a, b in zip(got, theirs)]
            d = max((a[1] - b[1]).abs().max().item()
                    for a, b in zip(got, theirs))
            res.update(equal=sum(same), max_abs_sample=d)
            line += (f"; every field of every stream bit-equal to the "
                     f"reference build's at {sum(same)} of {ticks} ticks "
                     f"(64 streams' max |d| {d:.3e})")
            check(all(same), f"{name}: served fields differ from the "
                  f"reference build's at ticks "
                  f"{[i for i, x in enumerate(same) if not x][:10]}")
        print(f"[upload] {name}, {UPLOAD_STREAMS} streams: {line} | {gpu}",
              flush=True)
        out[name] = res
        torch.cuda.empty_cache()
    if trace:
        out["trace"] = _upload_trace(gpu)
    return out


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
    if sys.argv[1:2] == ["--upload"]:
        opt = dict(a.split("=", 1) for a in sys.argv[2:] if "=" in a)
        print(json.dumps(phase_upload(gpu, opt.get("save"), opt.get("ref"),
                                      "trace" in sys.argv[2:])), flush=True)
        return 0
    if sys.argv[1:2] == ["--k7-digests"]:
        opt = dict(a.split("=", 1) for a in sys.argv[2:] if "=" in a)
        expect = K7_X1_C01 if "check" in sys.argv[2:] else None
        print(json.dumps(phase_k7_bits(gpu, expect, opt.get("save"),
                                       opt.get("ref"))), flush=True)
        return 0

    build()
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    params_np = synthetic_params(cfg.frame_hz)
    # first, while this process holds almost nothing of the card: (h)'s
    # capacity probes share the card with it
    serving = phase_h(cfg, params_np, gpu)
    err_main = phase_a()
    err_int8 = phase_a_int8()
    err_norm = phase_a_norm()
    err_fused = phase_a_fused()
    err_compact = phase_a_compact()
    err_q8 = max(phase_a_compact_q8(), err_compact["int8 row"],
                 err_compact["int8 global"])
    err_lstm = phase_a_lstm()
    err_serve = phase_a_serve()
    err_lstm_train = phase_a_lstm_train(params_np)
    err_single = phase_a_single()
    err_tail = phase_a_tail()
    err_lab = phase_a_lab()
    err_read = phase_a_read()
    merge_checked = phase_a_merge()
    p_bf16, frames, run_steps_b = phase_b(cfg, params_np)
    p4, frames4 = phase_b_slice4(cfg, params_np)
    phase_b_hybrid(cfg, params_np)
    bodies, norm, compact, fused, lstm = phase_d(cfg, p_bf16, frames, gpu)
    single, tail = phase_d_slice4(cfg, p4, frames4, gpu)
    phase_d_hybrid(cfg, p4, gpu)
    del p_bf16, frames, p4, frames4
    torch.cuda.empty_cache()
    lab, read, run_lab = phase_d_lab(gpu)
    merge = phase_d_merge(gpu)
    k7_long = phase_k7_long(gpu)
    k7_bits = phase_k7_bits(gpu, K7_X1_C01)
    rate5 = phase_rate5(gpu)
    serve_tick = phase_serve_tick(gpu)
    serve = time_serve(gpu)
    phase_sync(gpu)
    phase_upload(gpu, trace=True)
    run_bf16 = phase_c(cfg, params_np, "bf16")
    run_q8g = phase_c(cfg, params_np, "q8g_normk")
    run_fused = phase_c(cfg, params_np, "fused_compact")
    run_kv = phase_c(cfg, params_np, "kv")
    run_hybrid = phase_c(cfg, params_np, "fast_hybrid")
    phase_e(cfg, params_np)
    phase_e_slice4(cfg, params_np)
    phase_e_hybrid(cfg, params_np)
    k2_surfaces = phase_f(cfg, params_np, gpu)
    train = phase_g(VapConfig(), params_np, gpu)
    lab_i = phase_i(cfg, params_np, gpu)

    print(gpu, flush=True)
    src = "vap_realtime_tpu_torch/csrc/"
    # K5's serving body over the main path's runs, each counted from 0
    srv_launches = run_fused["lstm_srv"] + train["serving"]
    err_seq = max(v for k, v in err_lstm_train.items() if k != "serving")
    print(json.dumps({"kernels": [
        dict(name="attend_pair", route="cuda", source=src + "attend_pair.cu",
             replaces="vap_realtime_tpu/ops/pallas/attend.py:454",
             launches=run_bf16["attend"] + run_q8g["attend"]
             + run_kv["attend"] + run_hybrid["attend"] + k2_surfaces
             + serving["k2"] + serving["k3"],
             max_abs_err=max(err_main, err_int8),
             **bodies["K2 bf16 staged"], bodies=bodies),
        dict(name="channel_norm_relu", route="cuda",
             source=src + "channel_norm_relu.cu",
             replaces="vap_realtime_tpu/ops/pallas/channorm.py:43",
             launches=run_q8g["norm"] + lab_i["norm"], max_abs_err=err_norm,
             **norm),
        dict(name="attend_compact", route="cuda",
             source=src + "attend_pair.cu",
             replaces="vap_realtime_tpu/ops/pallas/attend.py:282",
             launches=run_fused["compact"], max_abs_err=err_compact["bf16"],
             **compact["K10 bf16 ring"],
             bodies={"K10 bf16 ring": compact["K10 bf16 ring"]}),
        # K10 on an int8 cache (its own CUDA kernel): launched by the
        # compact_q8g step in (b), 7 a step; none on the server runs
        dict(name="attend_compact_q8", route="cuda",
             source=src + "attend_pair.cu",
             replaces="vap_realtime_tpu/ops/pallas/attend.py:296",
             launches=run_steps_b["compact_q8g"]["compact"],
             max_abs_err=err_q8, **compact["K10 int8 global ring"],
             bodies={k: v for k, v in compact.items() if "int8" in k}),
        dict(name="conv_stack_fused", route="cuda",
             source=src + "conv_stack_fused.cu",
             replaces="vap_realtime_tpu/ops/pallas/encoder.py:291",
             launches=run_fused["fused"] + lab_i["fused"],
             max_abs_err=err_fused, **fused,
             frames={str(k): v for k, v in k7_long.items()},
             bit_cases=k7_bits, rate5_tick=rate5),
        # off the serving paths, as in the JAX package; its main path is
        # the training encoder's LSTM, (16, 1998, 256) float32, one launch
        # a forward over (g), on the sequence body; both bodies at that
        # shape, and the serving body at the serving shape, under "bodies"
        dict(name="lstm_scan", route="cuda", source=src + "lstm_scan.cu",
             replaces="vap_realtime_tpu/ops/pallas/lstm.py:48",
             launches=run_fused["lstm"] + train["launches"],
             max_abs_err=err_seq, **train["k5"]["sequence"],
             bodies={
                 "sequence (16, 1998, 256) float32": dict(
                     train["k5"]["sequence"],
                     launches=run_fused["lstm_seq"] + train["sequence"],
                     max_abs_err=err_seq),
                 "serving (16, 1998, 256) float32": dict(
                     train["k5"]["serving"], launches=srv_launches,
                     max_abs_err=err_lstm_train["serving"]),
                 "serving (8192, 5, 256) bf16": dict(
                     lstm["bodies"]["bfloat16"],
                     max_abs_err=err_lstm["bfloat16"], launches=srv_launches),
                 "serving (8192, 5, 256) float32": dict(
                     lstm["bodies"]["float32"],
                     max_abs_err=err_lstm["float32"],
                     launches=srv_launches)}),
        # replaces no TPU kernel (the JAX serving step runs the LSTM as
        # XLA ops): one launch an encode call on CUDA bf16, counted over
        # the two profiled ticks; its numbers at (83,968, 20), the others
        # under "shapes"
        dict(name="lstm_serve", route="cuda", source=src + "lstm_serve.cu",
             replaces=None,
             launches=sum(v["kernel"]["launches"]
                          for v in serve_tick.values()),
             max_abs_err=max(v["err"] for v in err_serve.values()),
             **serve[f"{SERVE_SHAPES[0][0]}x{SERVE_SHAPES[0][1]}"],
             shapes=serve),
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
        # replaces no TPU kernel (the JAX merge is XLA scatters): one
        # launch a merge tick over the server runs, checked bit-equal to
        # the plain version in (a) over `merge_checked` merges
        dict(name="stage_merge", route="cuda", source=src + "stage_merge.cu",
             replaces=None,
             launches=sum(r["merge"] for r in (run_bf16, run_q8g, run_fused,
                                               run_kv, run_hybrid)),
             max_abs_err=0.0, merges_checked=merge_checked, **merge),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
