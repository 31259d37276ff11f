"""Export the static VAP step (`runtime/static.py`) with `torch.export`.

Reference analogue: tools/export_vap_onnx.py (a static 99-frame export)
and the repo-root `tools/export_static.py` (the JAX package's StableHLO
export).  Produces:
- <out>.pt2 : the exported program (`torch.export.save`; reload with
  `torch.export.load(path).module()` and call it as
  fn(params, x1, x2, e1_context, e2_context, h, c));
- <out>.npz : the params pytree it takes (`weights/convert.py`);
- with --benchmark: reloads the program and reports ms per call over N
  calls on zero inputs, on the device it was exported for.
With --dynamic the context length is symbolic (`torch.export.Dim("T")`
on axis 1 of both context inputs): one program answers any T from 2 to
MAX_T, as the reference's dynamic-axes ONNX export does.  The ONNX and
TFLite exports of the JAX package's tools are not ported; the web export
is `tools/export_web.py`.

Run (on the card; `--device cpu` for the CPU):
    python -m vap_realtime_tpu_torch.tools.export_static \\
        --synthetic_weights --out vap20hz [--context_frames 99] [--dynamic]
        [--benchmark]
(or --vap_model vap.pt --cpc_model cpc.pt, or --checkpoint_npz w.npz).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime import cli
from vap_realtime_tpu_torch.runtime.static import make_static_fn
from vap_realtime_tpu_torch.weights.convert import (
    params_to_torch, save_pytree_npz,
)


# the largest context length a --dynamic program takes
MAX_T = 512


def _none_tree(tree):
    """`tree`'s nesting with None at every leaf: static shapes."""
    if isinstance(tree, dict):
        return {k: _none_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_none_tree(v) for v in tree)
    return None


def export_artifact(params, cfg: VapConfig, context_frames: int = 99,
                    device="cuda", dynamic: bool = False):
    """Export the static step at a fixed context length, or with
    `dynamic=True` at a symbolic one (2 <= T <= MAX_T; the example
    inputs keep `context_frames`).  params: the params pytree with numpy
    leaves.  Returns (ExportedProgram, the params as float32 tensors on
    `device`, the example inputs)."""
    fn, example = make_static_fn(cfg, context_frames, device)
    p = params_to_torch(params, example[0].device, torch.float32)
    shapes = None
    if dynamic:
        T = torch.export.Dim("T", min=2, max=MAX_T)
        shapes = (_none_tree(p), None, None, {1: T}, {1: T}, None, None)
    with torch.no_grad():
        exported = torch.export.export(fn, (p,) + example,
                                       dynamic_shapes=shapes)
    return exported, p, example


def time_calls(fn, args, runs: int) -> float:
    """Mean ms per call of fn(*args) after one warm-up call (the device
    synchronised before and after the timed calls)."""
    sync = (torch.cuda.synchronize if args[-1].device.type == "cuda"
            else (lambda: None))
    with torch.no_grad():
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn(*args)
        sync()
    return (time.perf_counter() - t0) / runs * 1e3


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    cli.add_weight_args(ap)
    ap.add_argument("--frame_hz", type=int, default=20)
    ap.add_argument("--context_len_sec", type=float, default=2.5)
    ap.add_argument("--context_frames", type=int, default=99,
                    help="static context length (reference export: 99)")
    ap.add_argument("--dynamic", action="store_true",
                    help="export with a symbolic context length")
    ap.add_argument("--out", default="vap_static")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--bench_runs", type=int, default=10)
    args = ap.parse_args(argv)
    cli.check_weight_args(ap, args)

    cfg = VapConfig(frame_hz=args.frame_hz,
                    context_len_sec=args.context_len_sec)
    params = cli.load_weights(args, cfg)
    exported, p, example = export_artifact(params, cfg, args.context_frames,
                                           args.device, args.dynamic)
    torch.export.save(exported, args.out + ".pt2")
    save_pytree_npz(args.out + ".npz", params)
    print(f"wrote {args.out}.pt2 ({os.path.getsize(args.out + '.pt2')} "
          f"bytes) and {args.out}.npz")

    if args.benchmark:
        reloaded = torch.export.load(args.out + ".pt2").module()
        ms = time_calls(reloaded, (p,) + example, args.bench_runs)
        print(f"latency: {ms:.3f} ms/inference ({args.bench_runs} runs, "
              f"zero inputs, ctx={args.context_frames}, {example[0].device})")


if __name__ == "__main__":
    main()
