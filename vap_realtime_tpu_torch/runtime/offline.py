"""Offline batch runner — the `vap_offline.py` analogue (CSV output).

Slides a frame-size window with shift = frame - 320 over two WAVs and
writes `time_sec,p_now(0=left),p_now(1=right),p_future(0=left),
p_future(1=right)` rows, the reference output format
(rvap/vap_main/vap_offline.py:39-88).  Port of
`vap_realtime_tpu/runtime/offline.py` for every engine path ("full",
"kv", "hybrid", "fast", "fast_hybrid"; the hybrid paths resync every
`context_frames` frames, as there).  The frames run through one Python
loop of steps on the card unless `--device cpu` is given.

Run:
    python -m vap_realtime_tpu_torch.runtime.offline \\
        --input_wav_left a.wav --input_wav_right b.wav \\
        --checkpoint_npz weights.npz --vap_process_rate 20 \\
        --context_len_sec 2.5 --filename_output out.csv
(`--vap_model vap.pt --cpc_model cpc.pt` loads the reference's .pt
checkpoints instead; `--synthetic_weights` seeded test weights.)
"""

from __future__ import annotations

import argparse
import functools
from typing import Dict, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io.audio import read_wav
from vap_realtime_tpu_torch.runtime import cli, streaming
from vap_realtime_tpu_torch.runtime.arena import (
    FRESH_PATHS, check_path, init_path_state, path_step, resolve_device,
)
from vap_realtime_tpu_torch.weights.convert import params_to_torch


def run_offline(params, audio: np.ndarray, cfg: VapConfig,
                path: str = "full", attend_impl: str = "kernel",
                quant_cache=False, device=None) -> Dict[str, np.ndarray]:
    """audio: (2, N) float32 -> dict of per-frame outputs (F, ...) and
    their timestamps "t".  params: the params pytree with numpy leaves,
    run in float32 on `device` (None = CUDA).  path: "full" (the
    parity-exact recompute), "kv", "hybrid", "fast" or "fast_hybrid";
    attend_impl and quant_cache apply to all but full (kv and fast on
    global slots: all frames are active; the hybrid paths on stream
    slots, resyncing every context_frames frames)."""
    check_path(path)
    dev = resolve_device(device)
    if path in FRESH_PATHS:
        # fresh-sample chunks; frame k summarises audio ending at
        # (k+1)*frame_shift (no 320-sample look-ahead)
        shift = cfg.frame_shift
        F = audio.shape[-1] // shift
        frames = audio[:, :F * shift].reshape(2, F, shift).transpose(1, 0, 2)
        t = (np.arange(F) + 1) * shift / cfg.sample_rate
    else:
        frames = streaming.frame_audio(audio, cfg)
        t = (np.arange(frames.shape[0]) * cfg.frame_shift
             + cfg.frame_samples) / cfg.sample_rate
    x = torch.as_tensor(np.ascontiguousarray(frames, np.float32))[:, None]
    state = init_path_state(path, cfg, 1, torch.float32, dev, staged=False,
                            quant=quant_cache)
    step = functools.partial(path_step, path, slots="global",
                             attend_impl=attend_impl,
                             resync_every=cfg.context_frames)
    _, outs = streaming.scan_frames(step, params_to_torch(params, dev), state,
                                    x.to(dev), cfg)
    res = {k: v[:, 0].float().cpu().numpy() for k, v in outs.items()}
    res["t"] = t
    return res


def write_csv(path: str, outs: Dict[str, np.ndarray]) -> None:
    """The reference's CSV: header, then one row per frame."""
    with open(path, "w") as f:
        f.write("time_sec,p_now(0=left),p_now(1=right),"
                "p_future(0=left),p_future(1=right)\n")
        for i in range(len(outs["t"])):
            f.write(f"{outs['t'][i]},{outs['p_now'][i, 0]},"
                    f"{outs['p_now'][i, 1]},{outs['p_future'][i, 0]},"
                    f"{outs['p_future'][i, 1]}\n")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    cli.add_weight_args(ap)
    ap.add_argument("--filename_output", type=str,
                    default="output_offline.txt")
    ap.add_argument("--input_wav_left", type=str, required=True)
    ap.add_argument("--input_wav_right", type=str, required=True)
    ap.add_argument("--vap_process_rate", type=int, default=20)
    ap.add_argument("--context_len_sec", type=float, default=2.5)
    ap.add_argument("--engine_path",
                    choices=["full", "kv", "fast", "hybrid", "fast_hybrid"],
                    default="full",
                    help="'full' = parity-exact recompute, 'kv' = "
                         "incremental KV cache, 'fast' = streaming conv + "
                         "KV; 'hybrid' / 'fast_hybrid' = kv / fast with a "
                         "full-trunk resync every context_frames frames")
    cli.add_quant_arg(ap)
    ap.add_argument("--attend_impl",
                    choices=["kernel", "kernel3", "grouped", "einsum"],
                    default="kernel",
                    help="'kernel' = the hand-written CUDA attend kernel "
                         "(its plain version on the CPU); 'kernel3' = its "
                         "compact-softmax body")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cli.check_weight_args(ap, args)

    cfg = VapConfig(frame_hz=args.vap_process_rate,
                    context_len_sec=args.context_len_sec)
    params = cli.load_weights(args, cfg)

    left, sr_l = read_wav(args.input_wav_left)
    right, sr_r = read_wav(args.input_wav_right)
    if sr_l != cfg.sample_rate or sr_r != cfg.sample_rate:
        raise SystemExit(f"expected {cfg.sample_rate} Hz WAVs, "
                         f"got {sr_l}/{sr_r}")
    if left.ndim > 1:
        left = left[:, 0]
    if right.ndim > 1:
        right = right[:, 0]
    n = min(len(left), len(right))
    outs = run_offline(params, np.stack([left[:n], right[:n]]), cfg,
                       args.engine_path, attend_impl=args.attend_impl,
                       quant_cache=args.quant_cache, device=args.device)
    write_csv(args.filename_output, outs)
    print(f"Generated output file: {args.filename_output} "
          f"({len(outs['t'])} frames)")


if __name__ == "__main__":
    main()
