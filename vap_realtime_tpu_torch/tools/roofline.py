"""Roofline report for the VAP hot components on one card.

Port of `tools/roofline.py`.  Times each component in steady state (the
component bench's CUDA-event chain, `tools/component_bench.py` `timed`:
every step's input evolves from the previous step's output), takes the
JAX tool's analytic FLOP and byte counts, and reports achieved TFLOP/s,
GB/s and the share of the card's matmul peak, measured here with a chain
of 4096 x 4096 x 4096 `torch.matmul`s in the same dtype:

  conv_encoder   the chunked CPC conv stack (conv0..conv4 + norms)
  lstm_context   the LSTM over one frame's 100 Hz features (`cpc_context`:
                 the serving kernel in bf16 on the card, plain otherwise)
  kv_step_total  kv_step (stream slots, the einsum attend, as in JAX)

The JAX tool's relay-overhead calibration has no counterpart here: the
CUDA events time the card alone.  A share of peak over 105% raises: it
would mean a wrong count, not a fast card.

    python -m vap_realtime_tpu_torch.tools.roofline [--batch 4096]
        [--dtype bf16|f32] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.encoder import cpc_context, cpc_conv_stack
from vap_realtime_tpu_torch.runtime import incremental
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.tools.component_bench import timed
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
MAX_SHARE = 1.05          # of the measured peak; above it a count is wrong


class Component:
    """fn: carry -> carry (one step); init: () -> the first carry;
    flops / bytes: the JAX tool's analytic counts for one step."""

    def __init__(self, fn: Callable, init: Callable, flops: float,
                 bytes_: float):
        self.fn, self.init, self.flops, self.bytes = fn, init, flops, bytes_


def build_components(B: int, dtype, cfg: VapConfig, params,
                     device) -> Dict[str, Component]:
    """The three components at B stereo streams; params: the params tree
    as tensors on `device` in `dtype`."""
    D = cfg.dim
    S = cfg.frame_samples
    N = B * 2  # stream-channels
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: (torch.randn(*s, generator=g) * 0.1).to(device, dtype)
    enc = params["encoder"]
    comps = {}

    # --- conv encoder stack (conv0..conv4 + norms) ---
    conv_flops = N * 2 * D * (224 * 10 * 1 + 56 * 8 * D + 28 * 4 * D
                              + 14 * 4 * D + 7 * 4 * D)
    wav0 = rn(N, S)

    def conv_fn(carry):
        z = cpc_conv_stack(enc, carry)
        # fold the output back into the carry to chain data dependence
        return carry * 0.999 + 1e-3 * z.float().mean().to(dtype)

    comps["conv_encoder"] = Component(
        conv_fn, lambda: wav0, conv_flops,
        N * (S + 224 * D * 4) * np.dtype(np.float32).itemsize)

    # --- LSTM context net (5 steps at 20 Hz) ---
    T5 = cfg.cpc_frames_per_chunk
    z0 = rn(N, T5, D)
    lstm_flops = N * T5 * (2 * D * 4 * D * 2)  # ih + hh matmuls

    def lstm_fn(carry):
        z, h, cc = carry
        y, h2, c2 = cpc_context(enc, z, h, cc)
        return (z * 0.999 + 1e-3 * y.float().mean().to(dtype), h2, c2)

    zeros = lambda: torch.zeros((N, D), dtype=dtype, device=device)
    comps["lstm_context"] = Component(
        lstm_fn, lambda: (z0, zeros(), zeros()), lstm_flops,
        N * T5 * D * 4 * 3)

    # --- incremental trunk step (attention + FFN + heads, KV cache) ---
    chunk0 = rn(B, 2, S)
    n_slots = 28
    Tctx = cfg.context_frames
    # projections + attention reads dominate
    attn_flops = B * (42 * D * D * 2 + 14 * Tctx * D * 2 * 2
                      + 6 * 2 * D * 3 * D * 2 + D * 256 * 2)
    cache_bytes = (B * Tctx * n_slots * D
                   * torch.empty((), dtype=dtype).element_size())

    def kv_fn(carry):
        st, ch = carry
        st, out = incremental.kv_step(params, st, ch, cfg)
        return st, ch * 0.999 + 1e-4 * out["p_now"].float().sum().to(dtype)

    comps["kv_step_total"] = Component(
        kv_fn, lambda: (incremental.init_kv_state(cfg, B, dtype,
                                                  device=device), chunk0),
        attn_flops + conv_flops + lstm_flops, cache_bytes)
    return comps


def measure_peak(dtype, device, n: int = 4096, iters: int = 24) -> float:
    """FLOP/s of a chain of (n, n) x (n, n) matmuls in `dtype`: a = 1/n
    everywhere (exact in bf16), so c = a @ c keeps c at ones."""
    a = torch.full((n, n), 1.0 / n, dtype=dtype, device=device)
    c = torch.ones((n, n), dtype=dtype, device=device)
    ms = timed(lambda c: torch.matmul(a, c), c, iters, device)
    return 2 * n ** 3 / (ms * 1e-3)


def main(argv: Optional[list] = None) -> Dict[str, dict]:
    """Returns {"peak_tflops": x, component: {ms, tflops, pct_peak,
    gbs}}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    params = params_to_torch(synthetic_params(20), dev, dtype)

    peak = measure_peak(dtype, dev, iters=args.iters)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (host clock)")
    print(f"device: {where}  measured matmul peak: {peak / 1e12:.1f} "
          f"TFLOP/s ({args.dtype})", flush=True)
    print(f"{'component':<16} {'ms/step':>9} {'TFLOP/s':>9} "
          f"{'% peak':>7} {'GB/s':>8}", flush=True)
    res: Dict[str, dict] = {"peak_tflops": peak / 1e12}
    for name, comp in build_components(args.batch, dtype, cfg, params,
                                       dev).items():
        ms = timed(comp.fn, comp.init(), args.iters, dev)
        tf = comp.flops / (ms * 1e-3) / 1e12
        share = tf * 1e12 / peak
        gbs = comp.bytes / (ms * 1e-3) / 1e9
        res[name] = dict(ms=ms, tflops=tf, pct_peak=100 * share, gbs=gbs)
        print(f"{name:<16} {ms:9.3f} {tf:9.1f} {100 * share:6.1f}% "
              f"{gbs:8.0f}", flush=True)
        if share > MAX_SHARE:
            raise RuntimeError(f"{name}: {100 * share:.1f}% of the measured "
                               "peak: its FLOP count or its timing is wrong")
    return res


if __name__ == "__main__":
    main()
