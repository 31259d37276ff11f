"""VAP output heads and their probability transforms.

- `vap_head` Linear(dim, 256), `va_classifier` Linear(dim, 1)
  (rvap/vap_main/vap_main.py:87-142); `bc` adds `bc_head` Linear(dim, 3)
  (vap_bc_main.py:137); `nod` adds `nod_head` Linear(dim, 4) and
  `bc_head` Linear(dim, 1) (vap_nod_main.py:137-138).
- The va tap follows `VapConfig.vad_tap`: realtime reads the channel-GPT
  streams o1/o2 (vap_main.py:292-293), training the stereo towers x1/x2.
- `trunk_forward` / `forward_context`: the whole-sequence trunk (both
  channels folded into one (2B, T, D) batch through the shared channel
  GPT), inference form.
"""

from __future__ import annotations

from typing import Dict

import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models import objective as obj
from vap_realtime_tpu_torch.models.transformer import (
    gpt_forward, gpt_stereo_forward,
)
from vap_realtime_tpu_torch.ops.basic import linear

Tensors = Dict[str, torch.Tensor]


def trunk_forward(params, e1: torch.Tensor, e2: torch.Tensor,
                  cfg: VapConfig) -> Tensors:
    """Transformer trunk over per-channel embeddings e1, e2 (B, T, D) ->
    {"x", "x1", "x2", "o1", "o2"} (B, T, D), the reference hot loop
    (vap_main.py:285-287).  The channels share `ar_channel`, so they run
    as one (2B, T, D) batch."""
    B = e1.shape[0]
    o = gpt_forward(params["ar_channel"], torch.cat([e1, e2]),
                    cfg.num_heads, cfg.context_limit)
    o1, o2 = o[:B], o[B:]
    x, x1, x2 = gpt_stereo_forward(params["ar"], o1, o2, cfg.num_heads,
                                   cfg.context_limit)
    return {"x": x, "x1": x1, "x2": x2, "o1": o1, "o2": o2}


def forward_context(params, e1: torch.Tensor, e2: torch.Tensor,
                    cfg: VapConfig) -> Tensors:
    """Embeddings (B, T, D) x2 -> all head outputs (full recompute)."""
    return heads_forward(params, trunk_forward(params, e1, e2, cfg), cfg)


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
