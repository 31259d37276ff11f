"""The first steps of a training run, in float64.

The forward over whole clips (rvap/vap_main train/model.py): both
channels through the frozen encoder (the conv stack with its padding,
the first and last CPC frame trimmed, the LSTM from zero state, the
trainable downsample), the channel GPT per channel and the stereo GPT
over all frames with causal AliBi, the heads; the loss is the CE of the
projection labels plus the BCE of the VAD (objective.py:40-76, 211-275).
The encoder's conv, norm and LSTM leaves are frozen; AdamW (decoupled
weight decay, bias-corrected moments) updates every other leaf.

Dropout (rate `dropout`) draws its masks as the training step does, so
both sides drop the same units: a step's generator G gives the channel
GPT of channel c the stream fold(G, c) and the stereo GPT fold(G, 2);
layer i of a channel GPT draws from fold(stream, i), tower t of stereo
layer i from fold(stream, 2 i + t); within a layer the masks come in
call order (attention weights, projected output, residual, for the self
then the cross attention; the FFN's hidden layer, its residual), each a
`torch.rand` of the tensor's shape on the device, kept where < 1 - rate.
fold(g, i) is a generator on g's device seeded with
`SeedSequence([g.initial_seed(), i]).generate_state(1, uint64)[0] >> 1`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vapbench.reference import ops

FROZEN = ("encoder/conv", "encoder/norm", "encoder/lstm")


def fold(g: torch.Generator, i: int) -> torch.Generator:
    seed = np.random.SeedSequence([g.initial_seed(), i])
    s = int(seed.generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=g.device).manual_seed(s)


def dropper(g: Optional[torch.Generator], rate: float):
    if g is None or rate <= 0:
        return None
    keep = 1.0 - rate

    def drop(x):
        m = torch.rand(x.shape, generator=g, device=x.device) < keep
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return drop


def labels(vad, bin_frames: List[int]):
    """VAD (B, N, 2) -> class labels (B, N - horizon): the next frames'
    activity averaged per bin, thresholded at 0.5, encoded with bit
    4c + b for speaker c, bin b."""
    horizon = sum(bin_frames)
    v = vad[:, 1:]
    T = v.shape[1] - horizon + 1
    bits = []
    start = 0
    for bf in bin_frames:
        win = v.unfold(1, bf, 1)[:, start:start + T]       # (B, T, 2, bf)
        bits.append((win.mean(-1) >= 0.5).long())
        start += bf
    b = torch.stack(bits, dim=-1)                          # (B, T, 2, n)
    w = 2 ** torch.arange(2 * len(bin_frames), device=vad.device)
    return (b.reshape(*b.shape[:2], -1) * w).sum(-1)


def forward_loss(p, batch, model: Dict, gen: Optional[torch.Generator]):
    wav = batch["waveform"].to(torch.float64)
    B = wav.shape[0]
    H = model["num_heads"]
    kd = 100 // model["frame_hz"]
    rate = model["dropout"]
    enc = p["encoder"]
    with torch.no_grad():
        z = ops.conv_stack(enc, torch.cat([wav[:, 0], wav[:, 1]]),
                           streaming=False)[:, 1:-1]
        y = ops.lstm(z, enc["lstm"])
    e = ops.downsample(enc, y, kd)
    T = e.shape[1]
    bias = ops.alibi(T, H, None, e.device, torch.float64)
    o = []
    for c, x in enumerate((e[:B], e[B:])):
        g = fold(gen, c) if gen is not None else None
        for i, lp in enumerate(p["ar_channel"]["layers"]):
            x = ops.layer(lp, x, bias, H, drop=dropper(
                fold(g, i) if g is not None else None, rate))
        o.append(x)
    x1, x2 = o
    g = fold(gen, 2) if gen is not None else None
    for i, lp in enumerate(p["ar"]["layers"]):
        d1 = dropper(fold(g, 2 * i) if g is not None else None, rate)
        d2 = dropper(fold(g, 2 * i + 1) if g is not None else None, rate)
        x1, x2 = (ops.layer(lp, x1, bias, H, src=x2, drop=d1),
                  ops.layer(lp, x2, bias, H, src=x1, drop=d2))
    xc = ops.combinator(p["ar"]["combinator"], x1, x2)
    logits = xc @ p["vap_head"]["w"].T + p["vap_head"]["b"]
    va = p["va_classifier"]
    vad_logits = torch.cat([o[0] @ va["w"].T + va["b"],
                            o[1] @ va["w"].T + va["b"]], dim=-1)
    hz = model["frame_hz"]
    bins = [int(t * hz) for t in model.get("bin_times",
                                           (0.2, 0.4, 0.6, 0.8))]
    vad = batch["vad"].to(torch.float64)
    lab = labels(vad, bins)
    n = min(lab.shape[1], logits.shape[1])
    l_vap = F.cross_entropy(logits[:, :n].reshape(-1, logits.shape[-1]),
                            lab[:, :n].reshape(-1))
    nv = vad_logits.shape[1]
    l_vad = F.binary_cross_entropy_with_logits(vad_logits, vad[:, :nv])
    return l_vap + l_vad


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}#/")
    else:
        yield prefix[:-1], tree


def run_steps(params_np, model: Dict, opt: Dict, batches, gens,
              device) -> Dict:
    """len(batches) AdamW steps from `params_np`, batch i with dropout
    generator gens[i].  Returns {"loss": [...], "grad1": {leaf: first
    gradient}, "delta": {leaf: params after the steps - before}}, the
    tensors on `device`, float64, trainable leaves only."""
    p = ops.to_tensors(params_np, device)
    train = {n: t for n, t in leaves(p) if not n.startswith(FROZEN)}
    start = {n: t.clone() for n, t in train.items()}
    for t in train.values():
        t.requires_grad_(True)
    b1, b2 = opt["betas"]
    lr, wd, eps = opt["learning_rate"], opt["weight_decay"], 1e-8
    m = {n: torch.zeros_like(t) for n, t in train.items()}
    v = {n: torch.zeros_like(t) for n, t in train.items()}
    losses, grad1 = [], None
    for step, (batch, gen) in enumerate(zip(batches, gens), start=1):
        loss = forward_loss(p, batch, model, gen)
        grads = torch.autograd.grad(loss, list(train.values()))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in zip(train, grads)}
        with torch.no_grad():
            for (n, t), g in zip(train.items(), grads):
                t.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[n] / (1 - b1 ** step)
                vh = v[n] / (1 - b2 ** step)
                t.sub_(lr * mh / (vh.sqrt() + eps))
    delta = {n: (t.detach() - start[n]) for n, t in train.items()}
    return {"loss": losses, "grad1": grad1, "delta": delta}
