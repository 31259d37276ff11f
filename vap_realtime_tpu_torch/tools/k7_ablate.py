"""Where K7's bf16 body spends its time: the body with one part changed.

    python -m vap_realtime_tpu_torch.tools.k7_ablate [--reps 5]

Builds copies of `csrc/conv_stack_fused.cu` into `build/k7_ablate/`, each
with the textual edits of one entry of VARIANTS, swaps each in for the
wrapper's library, and times one `conv_stack_fused` call at the serving
shape (8192 channel-streams x 800 samples, bf16, the synthetic encoder):
each CUDA launch's device time (torch.profiler) and the call's (CUDA
events).  Every variant runs twice, in mirrored order, in one process.
Variants that switch work off compute wrong values by design: only their
times are read.  Card only; prints each line beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from vap_realtime_tpu_torch.ops.cuda import build as kbuild
from vap_realtime_tpu_torch.ops.cuda import encoder as kenc

SOURCE = os.path.join(kbuild.CSRC, "conv_stack_fused.cu")
OUT = os.path.join(kbuild.BUILD, "k7_ablate")

_FLUSH = '''  if (lane < 16) {
    bf16* dst;
    bf16* car;
    rows(lane, dst, car);
    const bf16* src = stage + lane * kOutLd;
    if (dst != nullptr) bulk_store(dst, src, kC * sizeof(bf16));
    if (car != nullptr) bulk_store(car, src, kC * sizeof(bf16));
    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
  }'''

# name -> [(text in the source, its replacement)]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    # the GEMMs' bias + ChannelNorm + ReLU + stores skipped
    "no_gemm_epilogue": [(
        "      norm_rows16(d, sAux, sOut",
        "      if (d[5] == 12345.f) norm_rows16(d, sAux, sOut")],
    # every row staged, none stored (conv0 and the GEMMs)
    "no_stores": [(
        "    if (dst != nullptr) bulk_store(dst, src, kC * sizeof(bf16));\n"
        "    if (car != nullptr) bulk_store(car, src, kC * sizeof(bf16));\n",
        "")],
    # the weight tiles loaded for a block's first tile only (conv2-4; conv1
    # loads its own from a consumer thread)
    "weights_once": [
        ("mbar_expect_tx(&full[st], kABytes + kWBytes);",
         "mbar_expect_tx(&full[st], kABytes + "
         "(tile == blockIdx.x ? kWBytes : 0));"),
        ("tma_load(sW + st * (kC * kBK), &mapW, &full[st], k0, 0);",
         "if (tile == blockIdx.x) "
         "tma_load(sW + st * (kC * kBK), &mapW, &full[st], k0, 0);")],
    # conv1's A stages filled with zeros: no samples, statistics or c1
    # read, no products, no normalisation (the stage stores stay)
    "zero_a_build": [
        ("      if (blockIdx.x < a.tiles)\n        issue_a1_rows(",
         "      if (blockIdx.x < 0)\n        issue_a1_rows("),
        ("          if ((c & 3) == 0) {\n            finish_a1_rows(",
         "          if (c < 0) {\n            finish_a1_rows("),
        ("          build_conv1_a(out, rows, *s0, (c & 3) * kBK);",
         "          out = A1Out{};")],
    # the staged rows stored by the warp with 16-byte stores
    "plain_stores": [(_FLUSH, '''#pragma unroll 4
  for (int rr = 0; rr < 16; ++rr) {
    bf16* dst;
    bf16* car;
    rows(rr, dst, car);
    const uint4 v =
        *reinterpret_cast<const uint4*>(stage + rr * kOutLd + 8 * lane);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + 8 * lane) = v;
    if (car != nullptr) *reinterpret_cast<uint4*>(car + 8 * lane) = v;
  }
  __syncwarp();''')],
    # unpadded stage rows, so rows contiguous in device memory leave as one
    # bulk copy per run
    "merged_runs": [
        ("constexpr int kOutLd = kC + 8;", "constexpr int kOutLd = kC;"),
        (_FLUSH, '''  bf16* dst = nullptr;
  bf16* car = nullptr;
  if (lane < 16) rows(lane, dst, car);
  const unsigned long long up = __shfl_up_sync(
      0xffffffffu, reinterpret_cast<unsigned long long>(dst), 1);
  const bool live = lane < 16 && dst != nullptr;
  const bool start = live && (lane == 0 || up == 0ull ||
                              reinterpret_cast<bf16*>(up) + kC != dst);
  const unsigned starts = __ballot_sync(0xffffffffu, start);
  const unsigned lives = __ballot_sync(0xffffffffu, live);
  if (start) {
    const unsigned stop = (starts | ~lives) & ~((2u << lane) - 1u);
    const int end = stop ? __ffs(stop) - 1 : 16;
    bulk_store(dst, stage + lane * kOutLd,
               (end - lane) * kC * sizeof(bf16));
  }
  if (car != nullptr)
    bulk_store(car, stage + lane * kOutLd, kC * sizeof(bf16));
  if (lane < 16)
    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");''')],
}


def variant_source(name: str, source: Optional[str] = None) -> str:
    """The source of variant `name`; each edit must match exactly once."""
    src = open(SOURCE).read() if source is None else source
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"k7_ablate: variant {name}: its edit matches "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variants(names) -> Dict[str, object]:
    """Compile the variants in parallel; {name: bound library}."""
    import ctypes

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for n in names:
        cu, so = os.path.join(OUT, f"{n}.cu"), os.path.join(OUT, f"lib{n}.so")
        with open(cu, "w") as f:
            f.write(variant_source(n))
        procs[n] = (so, subprocess.Popen(
            [kbuild.nvcc(), kbuild.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"k7_ablate: {n} failed to build:\n{log}")
        libs[n] = kenc.bind(ctypes.CDLL(so))
    return libs


def time_call(fn, reps: int) -> Tuple[float, List[float]]:
    """(ms per call by CUDA events, [device ms of each launch of a call])."""
    from vap_realtime_tpu_torch.profile_step import cuda_ms

    ms = cuda_ms(fn, reps=4 * reps)
    # the profiler can drop kernel records (seen once on the H100: 17 of
    # 25); a window that is not whole calls is profiled again, at most
    # three times in all
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # in launch order (the profiler's list need not be)
        us = [e.time_range.elapsed_us() for e in sorted(
                  (e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and ("conv0_kernel" in e.name
                        or "conv_layer_kernel" in e.name)),
                  key=lambda e: e.time_range.start)]
        if us and len(us) % reps == 0:
            break
    else:
        raise RuntimeError(f"k7_ablate: the profiler saw {len(us)} K7 "
                           f"launches over {reps} calls")
    k = len(us) // reps
    return ms, [sum(us[i::k]) / reps / 1e3 for i in range(k)]


def main(argv: Optional[list] = None) -> Dict[str, list]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k7_ablate: needs a CUDA card")
    from vap_realtime_tpu_torch.profile_step import gpu_line
    from vap_realtime_tpu_torch.weights.convert import params_to_torch
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    names = args.variants.split(",")
    libs = build_variants(names)
    gpu = gpu_line()
    N, L, bf = 8192, 800, torch.bfloat16
    enc = params_to_torch(synthetic_params(20)["encoder"], "cuda", bf)
    packed = kenc.pack_fused_params(enc, bf)
    g = torch.Generator(device="cuda").manual_seed(1)
    c0 = (0.1 * torch.randn(N, 5, generator=g, device="cuda")).to(bf)
    carries = tuple(torch.randn(N, k - s, kenc.C, generator=g,
                                device="cuda").abs().to(bf)
                    for k, s in kenc.TAIL_KS)
    new = (0.1 * torch.randn(N, L, generator=g, device="cuda")).to(bf)
    res: Dict[str, list] = {n: [] for n in names}
    kernel_lib = kenc._lib
    try:
        for n in names + names[::-1]:
            kenc._lib = lambda n=n: libs[n]
            ms, per = time_call(
                lambda: kenc.conv_stack_fused(c0, new, carries, *packed),
                args.reps)
            res[n].append(ms)
            print(f"[k7_ablate] {n:17s} {ms:.4f} ms/call | conv0 "
                  f"{per[0]:.4f}, conv1-4 "
                  + ", ".join(f"{t:.4f}" for t in per[1:])
                  + f" ms | {gpu}", flush=True)
    finally:
        kenc._lib = kernel_lib
    return res


if __name__ == "__main__":
    main()
