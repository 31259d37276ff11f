"""Offline runner driving an exported static step (`.pt2`).

Port of `tools/vap_offline_exported.py`, which drives the JAX package's
StableHLO artifact (reference analogue: tools/vap_offline_onnx.py).  It
loads a program written by `tools/export_static.py`, keeps the state
outside it as the reference's ONNX runner does (zero-initialised
contexts and LSTM state, each context rolled one row a frame), and
writes the offline runner's CSV.  The context length is read from the
program's `e1_context` input; a program exported with `--dynamic` has no
fixed length and is refused.

Run (on the card the program was exported for; `--device cpu` for a
program exported with `--device cpu`):
    python -m vap_realtime_tpu_torch.tools.vap_offline_exported \\
        --artifact vap20.pt2 --params vap20.npz \\
        --input_wav_left l.wav --input_wav_right r.wav
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io.audio import read_wav
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.runtime.streaming import frame_audio
from vap_realtime_tpu_torch.weights.convert import (
    load_pytree_npz, params_to_torch,
)


def context_input(exported) -> torch.Tensor:
    """The (fake) tensor of the program's `e1_context` input."""
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name == "e1_context":
            return node.meta["val"]
    raise ValueError("the program has no e1_context input: not a static "
                     "step from tools/export_static.py")


def main(argv: Optional[list] = None) -> int:
    """Returns the number of CSV rows written."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--artifact", required=True, help=".pt2 file")
    ap.add_argument("--params", required=True, help=".npz params")
    ap.add_argument("--input_wav_left", required=True)
    ap.add_argument("--input_wav_right", required=True)
    ap.add_argument("--filename_output", default="output_offline_exported.txt")
    ap.add_argument("--vap_process_rate", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = VapConfig(frame_hz=args.vap_process_rate)
    exported = torch.export.load(args.artifact)
    ctx = context_input(exported)
    T_ctx, D = ctx.shape[1], ctx.shape[2]
    if not isinstance(T_ctx, int):
        raise SystemExit(f"{args.artifact} has a symbolic context length "
                         f"({T_ctx}): export it without --dynamic to run it "
                         "here")
    if ctx.device.type != dev.type:
        raise SystemExit(f"{args.artifact} was exported for {ctx.device}; "
                         f"run it with --device {ctx.device.type}")
    call = exported.module()
    params = params_to_torch(load_pytree_npz(args.params), dev)

    left, _ = read_wav(args.input_wav_left)
    right, _ = read_wav(args.input_wav_right)
    if left.ndim > 1:
        left = left[:, 0]
    if right.ndim > 1:
        right = right[:, 0]
    n = min(len(left), len(right))
    frames = torch.from_numpy(np.ascontiguousarray(
        frame_audio(np.stack([left[:n], right[:n]]), cfg), np.float32)).to(dev)

    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    ctx1, ctx2, h, c = z(1, T_ctx, D), z(1, T_ctx, D), z(2, D), z(2, D)
    rows = []
    with torch.no_grad():
        for f_i in range(frames.shape[0]):
            t = (f_i * cfg.frame_shift + cfg.frame_samples) / cfg.sample_rate
            (p_now, p_fut, _v1, _v2, e1, e2, h, c) = call(
                params, frames[f_i, 0:1], frames[f_i, 1:2], ctx1, ctx2, h, c)
            ctx1 = torch.cat([ctx1, e1[None]], dim=1)[:, 1:]
            ctx2 = torch.cat([ctx2, e2[None]], dim=1)[:, 1:]
            p_now, p_fut = p_now.cpu().numpy(), p_fut.cpu().numpy()
            rows.append((t, p_now[0], p_now[1], p_fut[0], p_fut[1]))

    with open(args.filename_output, "w") as f:
        f.write("time_sec,p_now(0=left),p_now(1=right),"
                "p_future(0=left),p_future(1=right)\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    print(f"Generated output file: {args.filename_output} ({len(rows)})")
    return len(rows)


if __name__ == "__main__":
    main()
