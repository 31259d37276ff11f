"""Training CLI — the reference's `train/train.py`, in PyTorch on the card.

Capability contract from the reference (train/train.py):
- AdamW lr 3.63e-4, wd 1e-3, betas (0.9, 0.999) (OptConfig :27-49) over
  the trainable leaves only: the encoder's conv, norm and LSTM stay
  frozen, bit for bit (`train/step.py`)
- ReduceLROnPlateau on val_loss: factor 0.5, patience 2 (:602-619)
- EarlyStopping on val_loss, patience 10 (:263-273)
- ModelCheckpoint: keep the best checkpoint, name embeds epoch/val_loss
  (:248-256), in the npz params format both packages read; resume via
  --resume_from
- SymmetricSpeakers channel flip p=0.5 on train batches (callbacks.py)
- loss = CE(vap projection labels) + BCE(vad)
- validation: loss + turn-taking event metrics (hs/hs2/ls/...)
- several processes: `torch.distributed` (one card each), each rank on
  its slice of the global batch, DistributedDataParallel averaging the
  gradients (train.py:316-321)

`last.npz` is the port's own full training state (params, the AdamW
moments and step counts, lr, the plateau / early-stop counters, the
generator's state): resuming from it continues the run exactly.  Every
random draw (init, dropout, augmentation) comes from one
`torch.Generator` seeded from `OptConfig.seed`.

Run (on the card; --device cpu for the CPU):
    python -m vap_realtime_tpu_torch.train.trainer \
        --data_train_path train.csv --data_val_path val.csv [...]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import (
    VapConfig, add_argparse_args, args_to_conf,
)
from vap_realtime_tpu_torch.models import objective as obj
from vap_realtime_tpu_torch.models.transformer import fold_in
from vap_realtime_tpu_torch.models.vap import VapModel, init_vap_params
from vap_realtime_tpu_torch.parallel.distributed import (
    all_host_metrics, init_distributed, world, wrap_model,
)
from vap_realtime_tpu_torch.parallel.mesh import shard_batch
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.train.data import DataConfig, VapDataLoader
from vap_realtime_tpu_torch.train.events import EventConfig, TurnTakingEvents
from vap_realtime_tpu_torch.train.metrics import (
    event_metrics, extract_prediction_and_targets,
)
from vap_realtime_tpu_torch.train.step import (
    loss_from_outputs, make_optimizer,
)
from vap_realtime_tpu_torch.utils.spans import span
from vap_realtime_tpu_torch.weights.convert import (
    _flatten, _unflatten, load_pytree_npz, params_to_numpy, save_pytree_npz,
)


@dataclass
class OptConfig:
    """Reference OptConfig defaults (train/train.py:27-64)."""

    learning_rate: float = 3.63e-4
    weight_decay: float = 1e-3
    betas: tuple = (0.9, 0.999)
    lr_scheduler_factor: float = 0.5
    lr_scheduler_patience: int = 2
    early_stopping_patience: int = 10
    max_epochs: int = 100
    seed: int = 0


def make_tx(model: VapModel, opt: OptConfig) -> torch.optim.AdamW:
    """AdamW over the model's trainable leaves (`step.make_optimizer`);
    the learning rate lives in its param group, where the plateau decay
    sets it."""
    return make_optimizer(model.params, opt.learning_rate,
                          opt.weight_decay, opt.betas)


def loss_fn(model, batch, cfg: VapConfig,
            generator: Optional[torch.Generator]):
    """(loss, metrics) of the model (a `VapModel`, or one inside
    DistributedDataParallel) on a batch of tensors: the loss of
    `step.loss_from_outputs`, vap + vad for the loader's batches."""
    return loss_from_outputs(model(batch["waveform"], generator), batch, cfg)


def make_train_step(tx: torch.optim.Optimizer, cfg: VapConfig,
                    augment: bool = False):
    """step(model, batch, generator) -> metrics: one AdamW step in place.
    With `augment`, the noise-robust (MC) waveform augmentation
    (reference train/transforms.py via AudioAugmentationCallback) draws
    from `fold_in(generator, 0)` and dropout from `fold_in(generator,
    1)`; otherwise dropout draws from `generator`.  The step's layers are
    spans (`utils/spans.py`) identified by the step's index: the step,
    the forward (`loss_fn`'s model call), the loss, the backward and the
    optimizer (its zero_grad and its update)."""
    if augment:
        from vap_realtime_tpu_torch.train.transforms import augment_batch
    index = 0

    def step(model, batch, generator: torch.Generator):
        nonlocal index
        with span("vap.train.step", id=index):
            index += 1
            if augment:
                batch = dict(batch, waveform=augment_batch(
                    batch["waveform"], fold_in(generator, 0)))
                generator = fold_in(generator, 1)
            with span("vap.optimizer"):
                tx.zero_grad(set_to_none=True)
            with span("vap.forward"):
                outs = model(batch["waveform"], generator)
            with span("vap.loss"):
                loss, metrics = loss_from_outputs(outs, batch, cfg)
            with span("vap.backward"):
                loss.backward()
            with span("vap.optimizer"):
                tx.step()
            return {k: v.detach() for k, v in metrics.items()}
    return step


def make_eval_step(cfg: VapConfig):
    """step(model, batch) -> the loss terms and p_now / p_future, without
    dropout or autograd."""
    @torch.no_grad()
    def step(model, batch):
        outs = model(batch["waveform"])
        _, metrics = loss_from_outputs(outs, batch, cfg)
        probs = torch.softmax(outs["logits"], dim=-1)
        return {**metrics, "p_now": obj.p_now(probs, cfg.n_bins),
                "p_future": obj.p_future(probs, cfg.n_bins)}
    return step


def evaluate(model, loader, eval_step, cfg: VapConfig,
             eventer: Optional[TurnTakingEvents],
             device) -> Dict[str, float]:
    """Mean loss over the loader's batches, plus the turn-taking event
    metrics when `eventer` is given."""
    losses = []
    all_preds: Dict[str, list] = {}
    all_targets: Dict[str, list] = {}
    for batch in loader:
        out = eval_step(model, shard_batch(batch, device))
        losses.append(float(out["loss"]))
        if eventer is not None:
            events = eventer(batch["vad"])
            preds, targets = extract_prediction_and_targets(
                out["p_now"].cpu().numpy(), out["p_future"].cpu().numpy(),
                events)
            for k, v in preds.items():
                if v is not None:
                    all_preds.setdefault(k, []).append(v)
                    all_targets.setdefault(k, []).append(targets[k])
    metrics = {"loss": float(np.mean(losses)) if losses else float("nan")}
    if all_preds:
        flat_p = {k: np.concatenate(v) for k, v in all_preds.items()}
        flat_t = {k: np.concatenate(v) for k, v in all_targets.items()}
        metrics.update(event_metrics(flat_p, flat_t))
    return metrics


def save_train_state(path: str, model: VapModel,
                     tx: torch.optim.Optimizer, generator: torch.Generator,
                     meta: Dict) -> None:
    """Full-state checkpoint: params, the optimiser's per-leaf state
    (AdamW's moments and step count, in the order of its param group),
    the generator's state and the scheduler / early-stop counters:
    everything `fit` needs to continue EXACTLY as if uninterrupted (the
    capability the reference stubs out, train/train.py:323-329).  Atomic
    write (tmp + rename)."""
    flat = {f"params/{k}": v for k, v in
            _flatten(params_to_numpy(model.params)).items()}
    for i, st in tx.state_dict()["state"].items():
        for k, v in st.items():
            flat[f"opt/{i:05d}/{k}"] = v.detach().cpu().numpy()
    flat["rng"] = generator.get_state().numpy()
    flat["meta_json"] = np.asarray(json.dumps(meta))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def is_full_train_state(path: str) -> bool:
    with np.load(path, allow_pickle=False) as data:
        return "meta_json" in data.files


def load_train_state(path: str):
    """-> (params tree (numpy), {param index: {name: array}} of the
    optimiser, generator state (uint8), meta)."""
    with np.load(path, allow_pickle=False) as data:
        params = _unflatten({k[len("params/"):]: data[k]
                             for k in data.files if k.startswith("params/")})
        opt: Dict[int, Dict[str, np.ndarray]] = {}
        for k in data.files:
            if k.startswith("opt/"):
                _, i, name = k.split("/")
                opt.setdefault(int(i), {})[name] = data[k]
        rng = data["rng"]
        meta = json.loads(str(data["meta_json"]))
    return params, opt, rng, meta


def _restore_optimizer(tx: torch.optim.Optimizer, opt_state, lr: float):
    sd = tx.state_dict()
    sd["state"] = {i: {k: torch.from_numpy(np.array(v))
                       for k, v in st.items()}
                   for i, st in opt_state.items()}
    tx.load_state_dict(sd)
    _set_lr(tx, lr)


def _set_lr(tx: torch.optim.Optimizer, lr: float) -> None:
    for group in tx.param_groups:
        group["lr"] = lr


def find_best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The min-val_loss checkpoint by filename (evaluation.py:97-120)."""
    best, best_loss = None, float("inf")
    if not os.path.isdir(ckpt_dir):
        return None
    for f in os.listdir(ckpt_dir):
        m = re.search(r"val_([0-9.]+)\.npz$", f)
        if m:
            loss = float(m.group(1).rstrip("."))
            if loss < best_loss:
                best, best_loss = os.path.join(ckpt_dir, f), loss
    return best


def fit(vap_cfg: VapConfig, data_cfg: DataConfig, opt_cfg: OptConfig,
        event_cfg: Optional[EventConfig] = None,
        ckpt_dir: str = "runs/vap", init_params=None,
        resume_from: Optional[str] = None, augment: bool = False,
        device="cuda", log_fn=print) -> Dict:
    """Train on `data_cfg.train_path`, validate on `data_cfg.val_path`
    after every epoch, keep the best checkpoint and a full-state
    `last.npz` in `ckpt_dir`.  Runs on CUDA unless device="cpu" (raises
    without CUDA).  Inside a process group (`parallel/distributed.py`)
    every rank loads the global batch and trains on its slice under
    DistributedDataParallel; rank 0 writes the checkpoints.  Returns the
    last epoch's history with "params" (numpy)."""
    dev = resolve_device(device)
    rank, world_size = world()
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(opt_cfg.seed)

    resume = opt_state = None
    if resume_from and is_full_train_state(resume_from):
        init_params, opt_state, rng, resume = load_train_state(resume_from)
        gen.set_state(torch.from_numpy(np.array(rng)))
    elif resume_from:
        init_params = load_pytree_npz(resume_from)  # params-only warm start
    elif init_params is None:
        init_params = init_vap_params(gen, vap_cfg)
    model = VapModel(vap_cfg, init_params, device=dev)
    tx = make_tx(model, opt_cfg)
    net = wrap_model(model, dev)

    step_fn = make_train_step(tx, vap_cfg, augment=augment)
    eval_fn = make_eval_step(vap_cfg)
    eventer = TurnTakingEvents(event_cfg) if event_cfg else None
    train_loader = VapDataLoader(data_cfg.train_path, data_cfg,
                                 shuffle=True, train=True,
                                 seed=opt_cfg.seed)
    val_loader = (VapDataLoader(data_cfg.val_path, data_cfg, shuffle=False,
                                train=False)
                  if data_cfg.val_path else None)

    best_val = float("inf")
    plateau = early = start_epoch = 0
    lr = opt_cfg.learning_rate
    history: Dict = {}
    if resume is not None:
        best_val, plateau, early, lr = (resume["best_val"],
                                        resume["plateau"], resume["early"],
                                        resume["lr"])
        start_epoch = resume["epoch"] + 1
        _restore_optimizer(tx, opt_state, lr)
        log_fn(f"resumed full train state from {resume_from} "
               f"(next epoch {start_epoch}, lr={lr:.2e})")

    def save_last(epoch):
        if rank == 0:
            save_train_state(
                os.path.join(ckpt_dir, "last.npz"), model, tx, gen,
                {"epoch": epoch, "lr": lr, "best_val": best_val,
                 "plateau": plateau, "early": early})

    for epoch in range(start_epoch, opt_cfg.max_epochs):
        t0 = time.time()
        losses = []
        train_loader.set_epoch(epoch)
        for batch in train_loader:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            step_gen = fold_in(torch.Generator(device=dev).manual_seed(seed),
                               rank)
            metrics = step_fn(net, shard_batch(batch, dev, rank, world_size),
                              step_gen)
            losses.append(metrics["loss"])
        train_loss = (float(torch.stack(losses).mean()) if losses
                      else float("nan"))
        if world_size > 1:  # the mean over the ranks' equal slices
            train_loss = all_host_metrics({"l": train_loss})["l"] / world_size

        msg = (f"epoch {epoch}: train_loss={train_loss:.4f} "
               f"({time.time() - t0:.1f}s, lr={lr:.2e})")
        history = {"epoch": epoch, "train_loss": train_loss, "lr": lr}

        if val_loader is not None:
            val = evaluate(model, val_loader, eval_fn, vap_cfg, eventer, dev)
            if world_size > 1:  # every rank decides on rank 0's number
                val["loss"] = all_host_metrics(
                    {"v": val["loss"] if rank == 0 else 0.0})["v"]
            val_loss = val["loss"]
            msg += f" val_loss={val_loss:.4f}"
            if "hs2_balanced_accuracy" in val:
                msg += f" hs2_bacc={val['hs2_balanced_accuracy']:.3f}"
            history.update({f"val_{k}": v for k, v in val.items()})

            if val_loss < best_val:  # ModelCheckpoint top-1
                best_val = val_loss
                plateau = early = 0
                path = os.path.join(
                    ckpt_dir, f"vap_epoch{epoch}-val_{val_loss:.5f}.npz")
                if rank == 0:
                    save_pytree_npz(path, params_to_numpy(model.params))
                msg += f" [saved {os.path.basename(path)}]"
            else:
                plateau += 1
                early += 1
                # ReduceLROnPlateau factor 0.5 patience 2
                if plateau > opt_cfg.lr_scheduler_patience:
                    lr *= opt_cfg.lr_scheduler_factor
                    _set_lr(tx, lr)
                    plateau = 0
                    msg += f" [lr -> {lr:.2e}]"
                if early >= opt_cfg.early_stopping_patience:
                    # keep last.npz current on the early-stop exit too
                    save_last(epoch)
                    log_fn(msg + " [early stop]")
                    break
        # the full-state "last" checkpoint: resuming from it continues the
        # run exactly (moments, lr, plateau / early counters, generator)
        save_last(epoch)
        log_fn(msg)

    history["params"] = params_to_numpy(model.params)
    return history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_argparse_args(ap)
    for f, t, d in [("data_train_path", str, None),
                    ("data_val_path", str, None),
                    ("data_test_path", str, None),
                    ("data_batch_size", int, 8),
                    ("data_audio_duration", float, 20.0),
                    ("opt_learning_rate", float, 3.63e-4),
                    ("opt_weight_decay", float, 1e-3),
                    ("opt_max_epochs", int, 100),
                    ("opt_early_stopping_patience", int, 10),
                    ("opt_seed", int, 0),
                    ("ckpt_dir", str, "runs/vap"),
                    ("resume_from", str, None)]:
        ap.add_argument(f"--{f}", type=t, default=d)
    ap.add_argument("--augment", action="store_true",
                    help="noise-robust (MC) waveform augmentation")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; one card per process) or cpu")
    ap.add_argument("--dist_address", default=None,
                    help="tcp://host:port of rank 0, for several processes")
    ap.add_argument("--world_size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)

    device = args.device
    if args.world_size > 1 and torch.device(device).type == "cuda":
        device = f"cuda:{args.rank % max(torch.cuda.device_count(), 1)}"
    init_distributed(args.dist_address, args.world_size, args.rank, device)
    vap_cfg = args_to_conf(args)
    data_cfg = DataConfig(
        train_path=args.data_train_path, val_path=args.data_val_path,
        test_path=args.data_test_path, batch_size=args.data_batch_size,
        audio_duration=args.data_audio_duration, frame_hz=vap_cfg.frame_hz,
    )
    opt_cfg = OptConfig(
        learning_rate=args.opt_learning_rate,
        weight_decay=args.opt_weight_decay,
        max_epochs=args.opt_max_epochs,
        early_stopping_patience=args.opt_early_stopping_patience,
        seed=args.opt_seed,
    )
    event_cfg = EventConfig(frame_hz=vap_cfg.frame_hz,
                            max_time=data_cfg.audio_duration)
    fit(vap_cfg, data_cfg, opt_cfg, event_cfg, ckpt_dir=args.ckpt_dir,
        resume_from=args.resume_from, augment=args.augment, device=device)


if __name__ == "__main__":
    main()
