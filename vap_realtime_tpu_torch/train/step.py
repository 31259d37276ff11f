"""Training step: loss, gradients, AdamW update with the encoder frozen.

Loss contract from the reference (train/train.py:583-630 `shared_step`):
``loss = loss_vap (CE over projection labels) + loss_vad (BCE)``, labels
from the future VAD window; the bc / nod / lid heads add their terms
when the batch carries their tracks.  The encoder is frozen
(rvap/vap_main/encoder.py:48-51): the CPC conv stack, its norms and the
LSTM never change; the downsample, the transformers and the heads train.

The JAX package builds its freeze as `optax.masked(adamw, mask)`, which
in optax 0.2.6 passes the masked-out leaves' updates through unchanged:
the raw gradient is added to the frozen leaves every step (ROADMAP
Queue 3).  Here the frozen leaves have no grad and are never handed to
the optimiser, so they stay bit for bit as they were.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models import objective as obj
from vap_realtime_tpu_torch.models.vap import forward_waveform
from vap_realtime_tpu_torch.weights.convert import tree_items

Params = Dict[str, Any]
Tensors = Dict[str, torch.Tensor]


def loss_from_outputs(outs: Tensors, batch: Tensors, cfg: VapConfig
                      ) -> Tuple[torch.Tensor, Tensors]:
    """The loss of `forward_waveform`'s outputs on a batch (see
    `compute_loss`); returns (loss, metrics)."""
    labels = obj.get_labels(batch["vad"], cfg.bin_frames())
    l_vap = obj.loss_vap(outs["logits"], labels)
    vad_logits = torch.cat([outs["vad1"], outs["vad2"]], dim=-1)
    l_vad = obj.loss_vad(vad_logits, batch["vad"])
    loss = l_vap + l_vad
    metrics = {"loss_vap": l_vap, "loss_vad": l_vad}
    # the bc / nod heads' terms (rvap/vap_bc/objective.py:216-308): each
    # label track present in the batch adds its head's loss
    extra = []
    if cfg.mode == "bc" and "bc_class" in batch:
        extra.append(("loss_bc", obj.loss_lid(outs["bc_logits"],
                                              batch["bc_class"])))
    elif cfg.mode == "nod":
        if "nod_class" in batch:
            extra.append(("loss_nod", obj.loss_lid(outs["nod_logits"],
                                                   batch["nod_class"])))
        if "bc_frame" in batch:
            bc_labels = obj.get_labels_bc(batch["bc_frame"], cfg.frame_hz)
            extra.append(("loss_bc", obj.loss_bc(
                outs["bc_logits"].squeeze(-1), bc_labels)))
    if cfg.lid_classify > 0 and "lid_class" in batch:
        # both lid heads write "lid_logits" (the JAX step reads
        # "lid_middle_logits" for lid 2, a key no head writes)
        extra.append(("loss_lid", obj.loss_lid(outs["lid_logits"],
                                               batch["lid_class"])))
    for name, term in extra:
        loss = loss + term
        metrics[name] = term
    metrics["loss"] = loss
    return loss, metrics


def compute_loss(params: Params, batch: Tensors, cfg: VapConfig,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Tensors]:
    """batch: {"waveform": (B, 2, L), "vad": (B, Tv, 2)} with Tv reaching
    `horizon` frames past the audio frames (train/README.md:44-55), plus
    optional "bc_class", "nod_class", "bc_frame", "lid_class".
    generator: dropout (None: none).  Returns (loss, metrics)."""
    outs = forward_waveform(params, batch["waveform"], cfg, generator)
    return loss_from_outputs(outs, batch, cfg)


def freeze_encoder_mask(params: Params) -> Params:
    """Trainability tree: the encoder's conv, norm and LSTM leaves False,
    every other leaf (the downsample included) True (reference freeze:
    rvap/vap_main/encoder.py:48-51)."""

    def fill(tree, value):
        if isinstance(tree, dict):
            return {k: fill(v, value) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [fill(v, value) for v in tree]
        return value

    mask = {k: fill(v, True) for k, v in params.items()}
    mask["encoder"] = {
        k: fill(v, not (k.startswith(("conv", "norm")) or k == "lstm"))
        for k, v in params["encoder"].items()}
    return mask


def make_optimizer(params: Params, lr: float = 3.63e-4,
                   weight_decay: float = 1e-3,
                   betas=(0.9, 0.999)) -> torch.optim.AdamW:
    """AdamW, lr 3.63e-4, wd 1e-3, betas (0.9, 0.999), eps 1e-8
    (reference OptConfig, train/train.py:27-64) over the trainable leaves
    of `params` only.  Switches grad on for those leaves and off for the
    frozen ones, which the optimiser never sees."""
    trainable = []
    for (name, leaf), (_, m) in zip(tree_items(params),
                                    tree_items(freeze_encoder_mask(params))):
        if not (isinstance(leaf, torch.Tensor) and leaf.is_leaf):
            raise TypeError(f"{name}: the params must be leaf tensors")
        leaf.requires_grad_(m)
        if m:
            trainable.append(leaf)
    return torch.optim.AdamW(trainable, lr=lr, betas=tuple(betas), eps=1e-8,
                             weight_decay=weight_decay)


def train_step(params: Params, optimizer: torch.optim.Optimizer,
               batch: Tensors, cfg: VapConfig,
               generator: Optional[torch.Generator] = None) -> Tensors:
    """One optimiser step on `params` in place (the optimiser from
    `make_optimizer(params)`); returns the step's metrics, detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = compute_loss(params, batch, cfg, generator)
    loss.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}
