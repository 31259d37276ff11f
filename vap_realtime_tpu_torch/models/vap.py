"""VAP output heads and their probability transforms.

- `vap_head` Linear(dim, 256), `va_classifier` Linear(dim, 1)
  (rvap/vap_main/vap_main.py:87-142); `bc` adds `bc_head` Linear(dim, 3)
  (vap_bc_main.py:137); `nod` adds `nod_head` Linear(dim, 4) and
  `bc_head` Linear(dim, 1) (vap_nod_main.py:137-138).
- The va tap follows `VapConfig.vad_tap`: realtime reads the channel-GPT
  streams o1/o2 (vap_main.py:292-293), training the stereo towers x1/x2.
- `trunk_forward` / `forward_context`: the whole-sequence trunk (both
  channels folded into one (2B, T, D) batch through the shared channel
  GPT); with a generator, the training form: dropout at `cfg.dropout`,
  each channel through the channel GPT on its own stream.
- `forward_waveform`: the training / offline-batch forward over whole
  stereo waveforms, both channels through the one shared encoder as a
  (2B, L) batch (train/model.py:192-206).
- `init_vap_params`: the JAX package's tree, shapes and distributions,
  drawn from a `torch.Generator`; `VapModel` holds a params tree as the
  parameters of one module (what the trainer optimises and
  `DistributedDataParallel` wraps).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models import objective as obj
from vap_realtime_tpu_torch.models.encoder import (
    encode_sequence, encode_sequence_limited, init_cpc_encoder_params,
)
from vap_realtime_tpu_torch.models.transformer import (
    fold_in, gpt_forward, gpt_stereo_forward, init_gpt_params, init_linear,
)
from vap_realtime_tpu_torch.ops.basic import linear
from vap_realtime_tpu_torch.utils.spans import span, traced
from vap_realtime_tpu_torch.weights.convert import _unflatten, tree_items

Tensors = Dict[str, torch.Tensor]
Params = Dict[str, Any]
Gen = Optional[torch.Generator]


def init_vap_params(generator: torch.Generator, cfg: VapConfig,
                    dtype=torch.float32, device=None) -> Params:
    """Random parameters in the JAX package's tree (`init_vap_params`):
    the encoder (torch-default uniform), both GPTs and the heads
    (normal(0, 0.02), zero biases) for the configured mode and lid head,
    drawn from `generator` in that order."""
    p: Params = {
        "encoder": init_cpc_encoder_params(
            generator, cfg.encoder_dim, cfg.downsample_kernel, dtype,
            device),
        "ar_channel": init_gpt_params(
            generator, cfg.dim, cfg.ffn_dim, cfg.channel_layers,
            cross=False, dtype=dtype, device=device),
        "ar": init_gpt_params(
            generator, cfg.dim, cfg.ffn_dim, cfg.cross_layers, cross=True,
            with_combinator=True, dtype=dtype, device=device),
    }

    def head(n_out, n_in=cfg.dim):
        return {"w": init_linear(generator, n_out, n_in, dtype=dtype,
                                 device=device),
                "b": torch.zeros(n_out, dtype=dtype, device=device)}

    p["vap_head"] = head(cfg.n_classes)
    p["va_classifier"] = head(1)
    if cfg.mode == "bc":
        p["bc_head"] = head(3)
    elif cfg.mode == "nod":
        p["nod_head"] = head(4)
        p["bc_head"] = head(1)
    if cfg.lid_classify == 1:
        p["lid_classifier"] = head(cfg.lid_classify_num_class)
    elif cfg.lid_classify == 2:
        p["lid_classifier_middle"] = head(cfg.lid_classify_num_class,
                                          2 * cfg.dim)
    return p


def trunk_forward(params, e1: torch.Tensor, e2: torch.Tensor,
                  cfg: VapConfig, generator: Gen = None) -> Tensors:
    """Transformer trunk over per-channel embeddings e1, e2 (B, T, D) ->
    {"x", "x1", "x2", "o1", "o2"} (B, T, D), the reference hot loop
    (vap_main.py:285-287).  The channels share `ar_channel`, so without a
    generator they run as one (2B, T, D) batch; with one, dropout at
    `cfg.dropout`, and each channel takes its own masks (streams
    `fold_in(generator, 0)` and `1`; the stereo GPT `2`)."""
    if generator is None:
        B = e1.shape[0]
        o = gpt_forward(params["ar_channel"], torch.cat([e1, e2]),
                        cfg.num_heads, cfg.context_limit)
        o1, o2 = o[:B], o[B:]
    else:
        o1, o2 = (gpt_forward(params["ar_channel"], e, cfg.num_heads,
                              cfg.context_limit, cfg.dropout,
                              fold_in(generator, i))
                  for i, e in enumerate((e1, e2)))
    drop = cfg.dropout if generator is not None else 0.0
    x, x1, x2 = gpt_stereo_forward(params["ar"], o1, o2, cfg.num_heads,
                                   cfg.context_limit, drop,
                                   fold_in(generator, 2))
    return {"x": x, "x1": x1, "x2": x2, "o1": o1, "o2": o2}


def forward_context(params, e1: torch.Tensor, e2: torch.Tensor,
                    cfg: VapConfig, generator: Gen = None) -> Tensors:
    """Embeddings (B, T, D) x2 -> all head outputs (full recompute);
    generator: the training form's dropout (see `trunk_forward`)."""
    return heads_forward(params, trunk_forward(params, e1, e2, cfg,
                                               generator), cfg)


def forward_waveform(params, waveform: torch.Tensor, cfg: VapConfig,
                     generator: Gen = None) -> Tensors:
    """Training / offline-batch forward over whole stereo waveforms.

    waveform: (B, 2, L) at 16 kHz.  Both channels run through the single
    shared encoder as one (2B, L) batch (`encode_sequence`, or
    `encode_sequence_limited` when `cfg.context_limit_cpc_sec` > 0).
    Returns the head outputs over (B, (L // 160 - 2) // k) frames.
    """
    B = waveform.shape[0]
    wav = torch.cat([waveform[:, 0], waveform[:, 1]])
    with span("vap.encode"):
        if cfg.context_limit_cpc_sec > 0:
            e = encode_sequence_limited(params["encoder"], wav,
                                        cfg.downsample_kernel,
                                        cfg.context_limit_cpc_sec,
                                        cfg.sample_rate)
        else:
            e = encode_sequence(params["encoder"], wav,
                                cfg.downsample_kernel)
    return forward_context(params, e[:B], e[B:], cfg, generator)


class VapModel(torch.nn.Module):
    """A params tree as the parameters of one module.

    Every leaf is a `torch.nn.Parameter` named by its checkpoint path
    ("ar/layers/0#/attn/q"), created without grad; the optimiser
    (`train.step.make_optimizer`) switches grad on for the trainable
    leaves.  `params` gives the tree back with these very tensors as
    leaves, so the functional API and the module share storage.
    params: a tree of numpy arrays or tensors (copied to `device` /
    `dtype`), or None for `init_vap_params(generator)`.
    """

    def __init__(self, cfg: Optional[VapConfig] = None, params=None,
                 generator: Gen = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg or VapConfig()
        if params is None:
            params = init_vap_params(
                generator or torch.Generator().manual_seed(0), self.cfg,
                dtype)
        leaves = {}
        for name, leaf in tree_items(params):
            t = (leaf.detach().clone() if isinstance(leaf, torch.Tensor)
                 else torch.from_numpy(np.array(leaf)))
            if t.is_floating_point():
                t = t.to(dtype)
            leaves[name] = torch.nn.Parameter(t.to(device),
                                              requires_grad=False)
        self.leaves = torch.nn.ParameterDict(leaves)

    @property
    def params(self) -> Params:
        return _unflatten(dict(self.leaves.items()))

    def forward(self, waveform: torch.Tensor,
                generator: Gen = None) -> Tensors:
        return forward_waveform(self.params, waveform, self.cfg, generator)


@traced("vap.heads")
def heads_forward(params, trunk: Tensors, cfg: VapConfig) -> Tensors:
    """All output heads for the configured mode.

    trunk: {"x", "x1", "x2", "o1", "o2"} each (B, T, D).  Returns
    `logits` (B, T, 256), `vad1`/`vad2` (B, T, 1), plus `bc_logits` /
    `nod_logits` / `lid_logits` for the variants.
    """
    v1_src = trunk["o1"] if cfg.vad_tap == "channel" else trunk["x1"]
    v2_src = trunk["o2"] if cfg.vad_tap == "channel" else trunk["x2"]
    va = params["va_classifier"]
    out: Tensors = {
        "logits": linear(trunk["x"], params["vap_head"]["w"],
                         params["vap_head"]["b"]),
        "vad1": linear(v1_src, va["w"], va["b"]),
        "vad2": linear(v2_src, va["w"], va["b"]),
    }
    if cfg.lid_classify == 1:
        p = params["lid_classifier"]
        out["lid_logits"] = linear(trunk["x"], p["w"], p["b"])
    elif cfg.lid_classify == 2:
        p = params["lid_classifier_middle"]
        mid = torch.cat([trunk["o1"], trunk["o2"]], dim=-1)
        out["lid_logits"] = linear(mid, p["w"], p["b"])
    if cfg.mode == "bc":
        out["bc_logits"] = linear(trunk["x"], params["bc_head"]["w"],
                                  params["bc_head"]["b"])
    elif cfg.mode == "nod":
        out["nod_logits"] = linear(trunk["x"], params["nod_head"]["w"],
                                   params["nod_head"]["b"])
        out["bc_logits"] = linear(trunk["x"], params["bc_head"]["w"],
                                  params["bc_head"]["b"])
    return out


@traced("vap.probs")
def probs_from_outputs(outputs: Tensors, cfg: VapConfig) -> Tensors:
    """Head logits -> the mode's probability outputs.

    vap: p_now/p_future (vap_main.py:295-307), sigmoid vad, and the
    bit-entropy H over the 256 states; bc: p_bc_react / p_bc_emo =
    softmax(bc)[..., 1/2]; nod: p_bc = sigmoid(bc), p_nod_short/long/
    long_p = softmax(nod)[..., 1/2/3].
    """
    res: Tensors = {
        "vad": torch.stack([torch.sigmoid(outputs["vad1"][..., 0]),
                            torch.sigmoid(outputs["vad2"][..., 0])], dim=-1),
    }
    probs = torch.softmax(outputs["logits"], dim=-1)
    res["p_now"] = obj.p_now(probs, cfg.n_bins)
    res["p_future"] = obj.p_future(probs, cfg.n_bins)
    res["H"] = -(probs * torch.log2(probs + 1e-20)).sum(dim=-1)
    if cfg.mode == "bc":
        bc = torch.softmax(outputs["bc_logits"], dim=-1)
        res["p_bc_react"] = bc[..., 1]
        res["p_bc_emo"] = bc[..., 2]
    elif cfg.mode == "nod":
        nod = torch.softmax(outputs["nod_logits"], dim=-1)
        res["p_bc"] = torch.sigmoid(outputs["bc_logits"][..., 0])
        res["p_nod_short"] = nod[..., 1]
        res["p_nod_long"] = nod[..., 2]
        res["p_nod_long_p"] = nod[..., 3]
    return res
