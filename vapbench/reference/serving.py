"""A stream's served outputs, frame by frame, from its whole audio.

The realtime step's semantics: frame f's embedding comes from one
seamless conv stack over the stream's audio so far (a (k - s) zero pad
per conv), the LSTM carried from the stream's start, and the downsample
over the frame's CPC frames; every layer's attention at frame f reads
the keys and values of the last T frames, f included, as each was
computed at its own frame (a causal band of width T over the whole
sequence, AliBi by age); the heads run on frame f's trunk outputs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from vapbench.reference import ops

# the fields each mode serves, in wire order (README.md:160-219)
FIELDS = {
    "vap": ("p_now", "p_future", "vad"),
    "bc": ("p_bc_react", "p_bc_emo"),
    "nod": ("p_bc", "p_nod_short", "p_nod_long", "p_nod_long_p"),
}


def heads(p, mode: str, x, o1, o2) -> Dict[str, torch.Tensor]:
    """All of the mode's served fields from the trunk's (N, F, D) outputs:
    the combined stream x and the channel GPT's o1 / o2."""
    out = {}
    if mode == "vap":
        h, va = p["vap_head"], p["va_classifier"]
        probs = ops.out(torch.softmax(ops.mm(x, h["w"].T) + h["b"], dim=-1))
        out["p_now"] = ops.next_speaker(probs, 0, 1)
        out["p_future"] = ops.next_speaker(probs, 2, 3)
        out["vad"] = torch.sigmoid(torch.cat(
            [ops.mm(o, va["w"].T) + va["b"] for o in (o1, o2)], dim=-1))
    elif mode == "nod":
        h = p["nod_head"]
        nod = torch.softmax(ops.mm(x, h["w"].T) + h["b"], dim=-1)
        out["p_bc"] = torch.sigmoid(ops.mm(x, p["bc_head"]["w"].T)
                                    + p["bc_head"]["b"])[..., 0]
        out["p_nod_short"] = nod[..., 1]
        out["p_nod_long"] = nod[..., 2]
        out["p_nod_long_p"] = nod[..., 3]
    else:
        bc = torch.softmax(ops.mm(x, p["bc_head"]["w"].T) + p["bc_head"]["b"],
                           dim=-1)
        out["p_bc_react"] = bc[..., 1]
        out["p_bc_emo"] = bc[..., 2]
    return out


def flat_fields(out: Dict[str, torch.Tensor], mode: str) -> torch.Tensor:
    """The served fields of (N, F) frames as one (N, F, n) array, in
    wire order."""
    N, Fr = next(iter(out.values())).shape[:2]
    return torch.cat([ops.out(out[k]).reshape(N, Fr, -1)
                      for k in FIELDS[mode]], dim=-1)


@torch.no_grad()
def stream_outputs(params_np, model: Dict, audio: np.ndarray, device,
                   block: int = 16) -> np.ndarray:
    """audio (S, 2, L) int16, L a whole number of frames -> (S, L / hop,
    n_fields) float64: each stream's served fields at every frame.
    Runs `block` streams at a time."""
    p = ops.to_tensors(params_np, device)
    hz = model["frame_hz"]
    kd = 100 // hz
    T = int(model["context_len_sec"] * hz)
    H = model["num_heads"]
    outs: List[np.ndarray] = []
    for at in range(0, audio.shape[0], block):
        a = torch.as_tensor(audio[at:at + block], device=device)
        n = a.shape[0]
        wav = a.to(torch.float64).reshape(n * 2, -1) / 32768.0
        z = ops.conv_stack(p["encoder"], wav, streaming=True)
        y = ops.lstm(z, p["encoder"]["lstm"])
        e = ops.downsample(p["encoder"], y, kd)             # (2n, F, D)
        Fr = e.shape[1]
        # channels of one stream are adjacent rows: make them two halves
        e = e.reshape(n, 2, Fr, -1).transpose(0, 1).reshape(2 * n, Fr, -1)
        bias = ops.alibi(Fr, H, T, device, torch.float64)
        x = e
        for lp in p["ar_channel"]["layers"]:
            x = ops.layer(lp, x, bias, H)
        o1, o2 = x[:n], x[n:]
        x1, x2 = o1, o2
        for lp in p["ar"]["layers"]:
            x1, x2 = (ops.layer(lp, x1, bias, H, src=x2),
                      ops.layer(lp, x2, bias, H, src=x1))
        xc = ops.combinator(p["ar"]["combinator"], x1, x2)
        out = heads(p, model["mode"], xc, o1, o2)
        outs.append(flat_fields(out, model["mode"]).cpu().numpy())
    return np.concatenate(outs)
