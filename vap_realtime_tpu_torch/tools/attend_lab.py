"""Attend-kernel lab on the card: cost attribution inside the attend
kernel by ablation.

Port of `tools/attend_lab.py`.  It times a 7-phase attend chain — the
serving step's launch pattern: 7 sequential launches over the 7 cache
phases per iteration, q fed forward as q * 0.999 + 0.001 * o so nothing
can be hoisted — for ablated kernel bodies (the K11 kernel,
`ops/cuda/attend_lab.py`) and the production bodies (the serving attend
kernel, `attend_pair`):

  dma            the phase plane read and summed         -> read floor
  mxu            + the head-summed k * q scores times v, no softmax
  bcast          the production body (K1)
  bcast_<mode>   K1's softmax ablated: nomax, noexp, f32out, nodenom,
                 noout, bf16exp
  compact        the compact production body (K10)
  q8_dma         dma on the int8 cache
  q8_row         the int8 production body with row scales (K4)
  q8_glb         the scale-free int8 body
  v5             the shared age * m, s_cur folded into the bias

Variant names are the JAX lab's.  Its stream-block sweep (`_b8`, `_b16`,
`_b32`, `_b64`: the TPU grid's stream block Bb) has no meaning on the
card: such a name runs the variant without the suffix.  The card's
counterpart is the number of streams per CUDA block: the suffix `_s2`
runs an ablated body with two streams per block (`_s1`, the default,
one).  The production bodies have the serving kernel's one layout.

Diagnostic only: the ablated variants are numerically wrong by design.
Each variant is timed with CUDA events over `--iters` chained iterations
after two warm-up iterations.

    python -m vap_realtime_tpu_torch.tools.attend_lab [--batch 4096]
        [--T 50] [--variants dma,mxu,...] [--iters 24] [--device cpu]
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from typing import Dict, Optional

import torch

from vap_realtime_tpu_torch.ops.cuda.attend import attend_pair
from vap_realtime_tpu_torch.ops.cuda.attend_lab import attend_lab
from vap_realtime_tpu_torch.runtime.arena import resolve_device

D, H, PHASES = 256, 4, 7
DEFAULT_VARIANTS = ("dma,mxu,bcast,bcast_nomax,bcast_bf16exp,compact,"
                    "bcast_b16,bcast_b64")
# every variant of the JAX lab
JAX_VARIANTS = (
    "dma", "mxu", "bcast", "compact", "bcast_nomax", "bcast_bf16exp",
    "bcast_noexp", "bcast_f32out", "bcast_f32out_b8", "bcast_nodenom",
    "bcast_noout", "bcast_b16", "bcast_b64", "q8_dma", "q8_row", "q8_glb",
    "q8_glb_b8", "q8_glb_b16", "q8_row_b8", "q8_dma_b8", "v5_b8", "v5_b16",
    "v5_b32", "bcast_b8")
PRODUCTION = {"bcast": "bcast", "compact": "compact", "q8_row": "bcast"}
ABLATED = {"dma": "dma", "mxu": "mxu", "q8_dma": "dma", "q8_glb": "q8glb",
           "v5": "v5", **{f"bcast_{m}": m for m in (
               "nomax", "noexp", "f32out", "nodenom", "noout", "bf16exp")}}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_variant(name: str):
    """name -> (base name, streams per block); `_b<N>` suffixes (the TPU
    stream block) are dropped, `_s<N>` sets the streams per block."""
    base = re.sub(r"_b\d+$", "", name)
    streams = 1
    m = re.fullmatch(r"(.+)_s([12])", base)
    if m:
        base, streams = m.group(1), int(m.group(2))
    if base not in PRODUCTION and base not in ABLATED:
        raise ValueError(f"unknown variant {name!r}")
    if base in PRODUCTION and streams != 1:
        raise ValueError(f"{name!r}: the production bodies have one layout")
    return base, streams


def make_launch(name: str, cache, cache_q8, age, rowscale):
    """launch(q, phase) -> o, both (B, 2D), for one variant."""
    base, streams = parse_variant(name)
    B = cache.shape[0]
    cch = cache_q8 if base.startswith("q8_") else cache
    if base in PRODUCTION:
        scale = rowscale if base == "q8_row" else None
        impl = PRODUCTION[base]

        def launch(q, ph):
            q3 = q.view(B, 2, D)
            return attend_pair(cch, q3, q3, q3, age, scale=scale,
                               pair_base=2 * ph, num_heads=H,
                               impl=impl).view(B, 2 * D)
        return launch
    mode = ABLATED[base]
    return lambda q, ph: attend_lab(mode, cch, q, q, q, age, ph,
                                    num_heads=H, streams=streams)


def time_chain(launch, q0, iters: int, device) -> float:
    """ms per 7-phase iteration of the chain (CUDA events on the card, the
    host clock on the CPU), after two warm-up iterations."""

    def run(n):
        q = q0
        for _ in range(n):
            for ph in range(PHASES):
                o = launch(q, ph)
                q = q * 0.999 + 0.001 * o
        return q

    run(2)
    if device.type != "cuda":
        t = time.perf_counter()
        q = run(iters)
        q.float().sum().item()
        return (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize(device)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    q = run(iters)
    t1.record()
    t1.synchronize()
    q.float().sum().item()                  # the chain's output is consumed
    return t0.elapsed_time(t1) / iters


def inputs(B: int, T: int, device, seed: int = 0):
    """The lab's inputs, made on the device from a seed: a bf16 (B, 7, T,
    4D) cache and its int8 lookalike (codes over the full range), bf16 q
    (B, 2D), live ages in [1, T), row scales in [0.01, 0.03)."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    cache = (torch.randn(B, PHASES, T, 4 * D, **kw) * 0.3).to(torch.bfloat16)
    q0 = (torch.randn(B, 2 * D, **kw) * 0.3).to(torch.bfloat16)
    age = torch.randint(1, T, (B, T), **kw).float()
    cache_q8 = torch.randint(-127, 128, cache.shape, **kw).to(torch.int8)
    rowscale = torch.rand(B, T, **kw) * 0.02 + 0.01
    return cache, cache_q8, q0, age, rowscale


def main(argv: Optional[list] = None) -> Dict[str, float]:
    """Returns {variant: ms per 7-phase step}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.variants.split(",")
    for name in names:
        parse_variant(name)
    B, T = args.batch, args.T
    cache, cache_q8, q0, age, rowscale = inputs(B, T, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (host clock)")
    log(f"device: {where}  B={B} T={T} {PHASES} phases/iter")
    results = {}
    for name in names:
        launch = make_launch(name, cache, cache_q8, age, rowscale)
        ms = time_chain(launch, q0, args.iters, device)
        results[name] = ms
        log(f"{name:16s} {ms:8.4f} ms / 7-phase step "
            f"({ms / PHASES:7.4f} ms/launch)")
    print({k: round(v, 4) for k, v in results.items()}, flush=True)
    return results


if __name__ == "__main__":
    main()
