"""Encoder conv-stack lab: the streaming CPC conv stack's impls alone.

Port of `tools/encoder_lab.py`.  Times each impl of the streaming conv
stack (the fast path's encoder before its LSTM) on one frame of fresh
samples a step, with the chunk evolving from the summed output and the
carries passed on, through the component bench's CUDA-event chain
(`tools/component_bench.py` `timed`):

  conv     PyTorch convs + the plain ChannelNorm + ReLU
  normk    PyTorch convs + the channel_norm_relu kernel (K6), 5 a step
  blocked  stride-block matmuls, plain PyTorch
  fused    the whole stack in the conv_stack_fused kernel (K7), one call
           (five CUDA launches in bf16) a step

    python -m vap_realtime_tpu_torch.tools.encoder_lab \\
        [--impls conv,normk,blocked,fused] [--batch 8192] [--hz 20]
        [--dtype bf16|f32] [--device cpu]

--batch counts CHANNEL-streams (two a stereo stream).  The JAX tool's
`fused:mode:ablate@block_b` suffixes name variants of its TPU kernel; K7
has one design here, and its ablations are `tools/k7_ablate.py`, so a
suffix raises.  An impl that fails prints FAILED, as in the JAX tool,
and the tool then exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import torch

from vap_realtime_tpu_torch.models.encoder import (
    cpc_conv_stack_streaming, cpc_conv_stack_streaming_blocked,
    cpc_conv_stack_streaming_normk, init_conv_stream_state,
    init_cpc_encoder_params,
)
from vap_realtime_tpu_torch.ops.cuda.encoder import (
    cpc_conv_stack_streaming_fused,
)
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.tools.component_bench import timed

IMPLS = {"conv": cpc_conv_stack_streaming,
         "normk": cpc_conv_stack_streaming_normk,
         "blocked": cpc_conv_stack_streaming_blocked,
         "fused": cpc_conv_stack_streaming_fused}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def check_impl(impl: str) -> None:
    """Raises for a name the port does not have, and names k7_ablate for
    the JAX tool's fused-kernel variants."""
    if impl in IMPLS:
        return
    if impl.startswith("fused"):
        raise ValueError(
            f"{impl!r}: K7 has one design on the card; time its ablations "
            "with python -m vap_realtime_tpu_torch.tools.k7_ablate")
    raise ValueError(f"unknown impl {impl!r}; choose from {list(IMPLS)}")


def make_body(step, params):
    """carry (state, chunk, acc) -> the next: one step of the stack, its
    output summed into acc, and the chunk nudged by acc (the JAX tool's
    `measure` body)."""
    def body(carry):
        st, ch, acc = carry
        z, st = step(params, ch, st)
        acc = acc + z.float().sum()
        ch = ch * 0.999 + 1e-4 * acc.to(ch.dtype)
        return st, ch, acc
    return body


def main(argv: Optional[list] = None) -> Dict[str, float]:
    """Returns {impl: ms per step} of the impls that ran."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--impls", default="conv,fused")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--hz", type=int, default=20)
    ap.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    impls = args.impls.split(",")
    for impl in impls:
        check_impl(impl)

    dev = resolve_device(args.device)
    dt = DTYPES[args.dtype]
    L, B = 16000 // args.hz, args.batch
    params = init_cpc_encoder_params(torch.Generator().manual_seed(0))
    params = {k: {n: t.to(dev, dt) for n, t in v.items()}
              for k, v in params.items()}
    g = torch.Generator().manual_seed(0)
    chunk = (torch.randn(B, L, generator=g) * 0.1).to(dev, dt)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (host clock)")
    print(f"device {where}  B={B} chan-streams  L={L}  {args.dtype}",
          flush=True)
    res: Dict[str, float] = {}
    failed = []
    for impl in impls:
        carry = (init_conv_stream_state(B, dtype=dt, device=dev), chunk,
                 torch.zeros((), device=dev))
        try:
            res[impl] = timed(make_body(IMPLS[impl], params), carry,
                              args.iters, dev)
            print(f"  {impl:8s}: {res[impl]:7.3f} ms/step", flush=True)
        except Exception as e:  # a failure is data too, as in the JAX tool
            failed.append(impl)
            print(f"  {impl:8s}: FAILED {type(e).__name__}: {e}", flush=True)
    if failed:
        sys.exit(f"encoder_lab: {', '.join(failed)} FAILED")
    return res


if __name__ == "__main__":
    main()
