"""One process of a multi-process training step (the counterpart of the
JAX package's `tools/multihost_worker.py`).  Run one per process:

    python -m vap_realtime_tpu_torch.parallel.worker \
        --address tcp://localhost:PORT --world_size 2 --rank 0 \
        --out w0.npz [--device cpu]

Each process joins the group (NCCL on the card, gloo on the CPU), sums
fleet metrics with `all_host_metrics`, takes its slice of one global
batch (made from seed 0, the same on every rank) and runs one trainer
step on it under DistributedDataParallel (one stereo layer, seed-0
weights, dropout off).  It writes its
loss, the summed metrics, and the trainable leaves after the step to
--out (npz: "params/<leaf>", and the averaged gradient the step took as
"grads/<leaf>"), for the launcher to compare with one process's step
on the whole batch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def global_inputs(seed: int, batch: int = 4, samples: int = 8000,
                  vad_frames: int = 50):
    """The global batch every rank loads: waveform (batch, 2, samples),
    vad (batch, vad_frames, 2) (0.5 s of audio at 20 Hz and the 2 s
    horizon)."""
    rs = np.random.RandomState(seed)
    return {"waveform": (0.1 * rs.randn(batch, 2, samples)).astype(
                np.float32),
            "vad": (rs.rand(batch, vad_frames, 2) > 0.5).astype(np.float32)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--address", required=True)
    ap.add_argument("--world_size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vap_realtime_tpu_torch.config import VapConfig
    from vap_realtime_tpu_torch.models.vap import VapModel, init_vap_params
    from vap_realtime_tpu_torch.parallel.distributed import (
        all_host_metrics, global_batch, init_distributed, world, wrap_model,
    )
    from vap_realtime_tpu_torch.parallel.mesh import shard_batch
    from vap_realtime_tpu_torch.runtime.arena import resolve_device
    from vap_realtime_tpu_torch.train.step import freeze_encoder_mask
    from vap_realtime_tpu_torch.train.trainer import (
        OptConfig, make_train_step, make_tx,
    )
    from vap_realtime_tpu_torch.weights.convert import (
        params_to_numpy, tree_items,
    )

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    init_distributed(args.address, args.world_size, args.rank, dev)
    rank, size = world()
    assert (rank, size) == (args.rank, args.world_size)
    try:
        fleet = all_host_metrics({"streams": 10.0 * (rank + 1),
                                  "frames": 5.0})
        cfg = VapConfig(frame_hz=20, context_len_sec=2.5, cross_layers=1)
        model = VapModel(cfg, init_vap_params(
            torch.Generator().manual_seed(0), cfg), device=dev)
        tx = make_tx(model, OptConfig())
        step = make_train_step(tx, cfg)
        local = global_batch(global_inputs(0))
        metrics = step(wrap_model(model, dev), shard_batch(local, dev), None)
        loss = float(metrics["loss"])
        sums = all_host_metrics({"loss": loss})
        mask = dict(tree_items(freeze_encoder_mask(model.params)))
        params = {f"params/{k}": v for k, v in
                  tree_items(params_to_numpy(model.params)) if mask[k]}
        params.update({f"grads/{k}": v.grad.cpu().numpy()
                       for k, v in tree_items(model.params) if mask[k]})
        np.savez(args.out, rank=rank, world_size=size,
                 fleet_streams=fleet["streams"], fleet_frames=fleet["frames"],
                 loss=loss, loss_sum=sums["loss"],
                 local_batch=local["waveform"].shape[0], **params)
        print(f"[worker {rank}] ok loss={loss:.6f}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
