"""Evaluation CLI — the reference's `train/evaluation.py`, on the card.

Loads a checkpoint (the npz params format both packages write; by
default the best of a run directory, min val_loss parsed from the
filename, reference evaluation.py:97-120), runs the test manifest, and
writes `runs_evaluation/<ckpt>/score.csv` with the loss and the
turn-taking metrics (evaluation.py:206-236, train/README.md:110-135),
the same metric names as the JAX package's CLI.

Run (on the card; --device cpu for the CPU):
    python -m vap_realtime_tpu_torch.train.evaluation \
        --checkpoint_dir runs/vap --data_test_path test.csv
"""

from __future__ import annotations

import argparse
import csv
import os

from vap_realtime_tpu_torch.config import (
    VapConfig, add_argparse_args, args_to_conf,
)
from vap_realtime_tpu_torch.models.vap import VapModel
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.train.data import DataConfig, VapDataLoader
from vap_realtime_tpu_torch.train.events import EventConfig, TurnTakingEvents
from vap_realtime_tpu_torch.train.trainer import (
    evaluate, find_best_checkpoint, make_eval_step,
)
from vap_realtime_tpu_torch.weights.convert import load_pytree_npz


def run_evaluation(checkpoint: str, vap_cfg: VapConfig,
                   data_cfg: DataConfig, event_cfg: EventConfig,
                   out_root: str = "runs_evaluation",
                   device="cuda") -> str:
    """Evaluate `checkpoint` on `data_cfg.test_path`; returns the path of
    the score.csv written.  Runs on CUDA unless device="cpu"."""
    dev = resolve_device(device)
    model = VapModel(vap_cfg, load_pytree_npz(checkpoint), device=dev)
    loader = VapDataLoader(data_cfg.test_path, data_cfg, shuffle=False,
                           train=False)
    metrics = evaluate(model, loader, make_eval_step(vap_cfg), vap_cfg,
                       TurnTakingEvents(event_cfg), dev)

    name = os.path.splitext(os.path.basename(checkpoint))[0]
    out_dir = os.path.join(out_root, name)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "score.csv")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "value"])
        for k in sorted(metrics):
            w.writerow([f"test_{k}", metrics[k]])
    print(f"wrote {out_path}")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_argparse_args(ap)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--checkpoint_dir", type=str, default=None)
    ap.add_argument("--data_test_path", type=str, required=True)
    ap.add_argument("--data_batch_size", type=int, default=8)
    ap.add_argument("--data_audio_duration", type=float, default=20.0)
    ap.add_argument("--out_root", type=str, default="runs_evaluation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ckpt = args.checkpoint or find_best_checkpoint(args.checkpoint_dir)
    if ckpt is None:
        ap.error("no checkpoint found (--checkpoint or --checkpoint_dir)")

    vap_cfg = args_to_conf(args)
    data_cfg = DataConfig(
        test_path=args.data_test_path, batch_size=args.data_batch_size,
        audio_duration=args.data_audio_duration, frame_hz=vap_cfg.frame_hz)
    event_cfg = EventConfig(frame_hz=vap_cfg.frame_hz,
                            max_time=data_cfg.audio_duration)
    return run_evaluation(ckpt, vap_cfg, data_cfg, event_cfg, args.out_root,
                          args.device)


if __name__ == "__main__":
    main()
