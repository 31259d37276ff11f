"""Where K10's int8 body spends its time: the body with one part changed.

    python -m vap_realtime_tpu_torch.tools.k10_ablate [--reps 70]

Builds copies of `csrc/attend_pair.cu` into `build/k10_ablate/`, each
with the textual edits of one entry of VARIANTS, swaps each in for the
wrapper's library, and times `attend_pair(impl="compact")` on an int8
cache at the serving shape (B=4096 streams, T=50 rows, D=256, 7 phases,
bf16 q), with row scales and under the frozen-scale fold: the call's
time by CUDA events (the wrapper's host time included) and the kernel's
own device time (torch.profiler).  Every variant runs twice, in mirrored
order, in one process.  Variants that switch work off compute wrong
values by design: only their times are read.  Card only; prints each
line beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from vap_realtime_tpu_torch.ops.cuda import attend as katt
from vap_realtime_tpu_torch.ops.cuda import build as kbuild

SOURCE = os.path.join(kbuild.CSRC, "attend_pair.cu")
OUT = os.path.join(kbuild.BUILD, "k10_ablate")
B, P, T, D, H = 4096, 7, 50, 256, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

_K = "    for (int rb = 0; rb < n; rb += 2 * RPP) {"
_SOFTMAX = "    for (int j = warp; j < J; j += kQ8Threads / 32) {"
_V = "    for (int r = g; r < n; r += 4 * G) {"
_OFF = [(_K, _K.replace("rb < n", "rb < 0")),
        (_SOFTMAX, _SOFTMAX.replace("j < J", "j < 0")),
        (_V, _V.replace("r < n", "r < 0"))]

# name -> [(text in the source, its replacement)]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    # the scores (K pass) skipped
    "no_scores": _OFF[:1],
    # the weighted V sum skipped
    "no_vsum": _OFF[2:],
    # only the copies, barriers and stores: scores, softmax, V sum skipped
    "stream_only": _OFF,
    # half-plane stages: two chunks a stream at T=50, 4 blocks an SM
    "stage_26k": [("constexpr int kQ8Stage = 52 * 1024;",
                   "constexpr int kQ8Stage = 26 * 1024;")],
    # a ring of 3 planes a block: 1 block an SM
    "ring_3": [("constexpr int kQ8Stages = 2;",
                "constexpr int kQ8Stages = 3;")],
    # 16 warps a block: 64 registers a thread at 2 blocks an SM (spills)
    "threads_512": [("constexpr int kQ8Threads = 256;",
                     "constexpr int kQ8Threads = 512;")],
}


def variant_source(name: str, source: Optional[str] = None) -> str:
    """The source of variant `name`; each edit must match exactly once."""
    src = open(SOURCE).read() if source is None else source
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"k10_ablate: variant {name}: its edit matches "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(names) -> Dict[str, ctypes.CDLL]:
    """Compile the variants in parallel; {name: bound library}."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for n in names:
        cu, so = os.path.join(OUT, f"{n}.cu"), os.path.join(OUT, f"lib{n}.so")
        with open(cu, "w") as f:
            f.write(variant_source(n))
        procs[n] = (so, subprocess.Popen(
            [kbuild.nvcc(), kbuild.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", kbuild.CSRC, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"k10_ablate: {n} failed to build:\n{log}")
        libs[n] = katt.bind(ctypes.CDLL(so))
    return libs


def inputs(seed: int = 3):
    """An int8 cache (B, P, T, 4D), bf16 q / k_cur / v_cur, ages (about a
    third DEAD) and row scales of each phase, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = torch.randint(-127, 128, (B, P, T, 4 * D), generator=g,
                          device="cuda").to(torch.int8)
    q2, kc2, vc2 = (torch.randn(B, 2, D, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    age = torch.randint(1, T + 1, (B, T), generator=g, device="cuda").float()
    age[torch.rand(B, T, generator=g, device="cuda") < 0.35] = katt.DEAD
    sc = (0.5 + torch.rand(B, P, T, generator=g, device="cuda")) * 3 / 127
    return cache, q2, kc2, vc2, age, sc


def time_calls(fn, reps: int) -> Tuple[float, float]:
    """(ms per call by CUDA events, the kernel's device ms per call)."""
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    ms = cuda_ms(fn, reps=reps, warm=7)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "attend_q8_kernel" in e.name]
    if len(us) != reps:
        raise RuntimeError(f"k10_ablate: the profiler saw {len(us)} K10 "
                           f"launches over {reps} calls")
    return ms, sum(us) / reps / 1e3


def main(argv: Optional[list] = None) -> Dict[str, list]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=70)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k10_ablate: needs a CUDA card")
    from vap_realtime_tpu_torch.profile_step import gpu_line

    names = args.variants.split(",")
    libs = build_variants(names)
    gpu = gpu_line()
    cache, q2, kc2, vc2, age, sc = inputs()
    res: Dict[str, list] = {n: [] for n in names}
    kernel_lib = katt._lib
    try:
        for n in names + names[::-1]:
            katt._lib = lambda n=n: libs[n]
            for mode in ("global", "row"):
                ph = iter(range(10 ** 9))
                if mode == "row":
                    def call():
                        p = next(ph) % P
                        katt.attend_pair(cache, q2, kc2, vc2, age,
                                         scale=sc[:, p], pair_base=2 * p,
                                         num_heads=H, impl="compact")
                else:
                    def call():
                        p = next(ph) % P
                        katt.attend_pair(cache, q2, kc2, vc2, age,
                                         pair_base=2 * p, num_heads=H,
                                         impl="compact")
                ms, dev = time_calls(call, args.reps)
                nbytes = (B * T * 4 * D + B * T * 4 * (2 if mode == "row"
                                                      else 1)
                          + 4 * B * 2 * D * 2)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                res[n].append((mode, ms, dev))
                print(f"[k10_ablate] {n:12s} int8 {mode:6s} {ms:.4f} "
                      f"ms/call, the kernel alone {dev:.4f} ms = "
                      f"{100 * bound / dev:.1f}% of the {bound:.4f} ms "
                      f"bound | {gpu}", flush=True)
    finally:
        katt._lib = kernel_lib
    return res


if __name__ == "__main__":
    main()
