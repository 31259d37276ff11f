"""Where K5's sequence body spends a step: the body with one part changed.

    python -m vap_realtime_tpu_torch.tools.k5_ablate [--reps 5]
        [--variants kernel,...]

Builds copies of `csrc/lstm_scan.cu` into `build/k5_ablate/`, each with
the textual edits of one entry of VARIANTS, swaps each in for the
wrapper's library, and times the sequence body (`_launch_sequence`) at
the training encoder's shape, (16, 1998, 256) float32, at both cluster
sizes (8 blocks, W_hh^T raw in shared memory; 16 blocks, non-portable,
W_hh^T's TF32 hi and lo parts): ms a call and microseconds a step (CUDA
events), and the max |d| against the plain version.  Every variant runs
twice, in mirrored order, in one process.  Variants that switch work off
compute wrong values by design: only their times are read.  A variant
whose launch fails prints so.  Card only; prints each line beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from vap_realtime_tpu_torch.ops.cuda import build as kbuild
from vap_realtime_tpu_torch.ops.cuda import lstm as k5

SOURCE = os.path.join(kbuild.CSRC, "lstm_scan.cu")
OUT = os.path.join(kbuild.BUILD, "k5_ablate")
B, T = 16, 1998
CLUSTERS = (8, 16)

_KSPLIT = "static constexpr int kKSplit = CS == 16 ? 8 : 4;"

# name -> [(text in the source, its replacement)].  A variant must not
# drop the h_t stores alone: each block's wait for h_t would never end.
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    # no gate loads after the first two steps
    "no_gates": [("    copy_gates(t + Sh::kGiDepth - 1);",
                  "    cp_async_commit();")],
    # no ys stores
    "no_ys": [("      if (n0 + rr < B)\n        store4(ys",
               "      if (false)\n        store4(ys")],
    # no product: the MMA phase's k loop skipped
    "no_mma": [("for (int kk = 0; kk < Sh::kKSteps; ++kk) {",
                "for (int kk = 0; kk < 0; ++kk) {")],
    # the block alone: no h_t exchange (no st.async, no mbarrier wait or
    # re-arm), a block barrier where the wait was
    "no_exchange": [
        ("      mbar_wait(mbar + 8 * (t & 1), ((t - 1) >> 1) & 1);",
         "      __syncthreads();"),
        ("      if (tid == 0 && t + 1 < T) mbar_expect(",
         "      if (false) mbar_expect("),
        ("    if (t + 1 < T) {\n      const uint32_t nb",
         "    if (false) {\n      const uint32_t nb")],
    # the product's K in 4 slices whatever the cluster
    "ksplit4": [(_KSPLIT, _KSPLIT.replace("? 8 : 4", "? 4 : 4"))],
}


def variant_source(name: str, source: Optional[str] = None) -> str:
    """The source of variant `name`; each edit must match exactly once."""
    src = open(SOURCE).read() if source is None else source
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"k5_ablate: variant {name}: its edit matches "
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
            raise RuntimeError(f"k5_ablate: {n} failed to build:\n{log}")
        libs[n] = k5.bind(ctypes.CDLL(so))
    return libs


def main(argv: Optional[list] = None) -> Dict[str, list]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k5_ablate: needs a CUDA card")
    from vap_realtime_tpu_torch.profile_step import cuda_ms, gpu_line
    from vap_realtime_tpu_torch.tools.lstm_bodies import inputs

    names = args.variants.split(",")
    libs = build_variants(names)
    gpu = gpu_line()
    a = inputs(B, T, torch.float32)
    with torch.no_grad():
        want = k5.lstm_scan_plain(*a)[0]
    res: Dict[str, list] = {n: [] for n in names}
    kernel_lib = k5._lib
    try:
        for n in names + names[::-1]:
            k5._lib = lambda n=n: libs[n]
            for c in CLUSTERS:
                run = lambda: k5._launch_sequence(*a, cluster=c)
                try:
                    with torch.no_grad():
                        ys = run()[0]
                        ms = cuda_ms(run, reps=args.reps, warm=1)
                except RuntimeError as e:
                    print(f"[k5_ablate] {n:12s} cluster {c:2d}: {e} | {gpu}",
                          flush=True)
                    continue
                err = (ys - want).abs().max().item()
                res[n].append((c, ms))
                print(f"[k5_ablate] {n:12s} cluster {c:2d} ({B}, {T}, 256) "
                      f"float32: {ms:.4f} ms/call, {1e3 * ms / T:.3f} us a "
                      f"step; max |ys - plain| {err:.3e} | {gpu}",
                      flush=True)
    finally:
        k5._lib = kernel_lib
    return res


if __name__ == "__main__":
    main()
