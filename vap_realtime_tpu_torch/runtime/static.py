"""Static stateless-step formulation — the `VAPRealTimeStatic` analogue.

Reference contract (tools/vap_static.py:170-304): a traceable, stateless
graph ``forward(x1, x2, e1_context, e2_context) -> (p_now_last,
p_future_last, vad1, vad2, e1, e2)`` whose embedding ring buffer is
external: the caller re-feeds the context each frame.  The reference
exports it to ONNX with a fixed 99-frame context.

Port of `vap_realtime_tpu/runtime/static.py`.  The LSTM state (h, c) is
external too, so the step has no state of its own and exports as one
graph with `torch.export` (`vap_realtime_tpu_torch/tools/
export_static.py`): every shape follows from the inputs' shapes, and
nothing reads a tensor's value on the host.  The step runs where its
inputs lie; `make_static_fn` puts its example inputs on the card unless
asked for the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.encoder import encode_chunk
from vap_realtime_tpu_torch.models.vap import (
    forward_context, probs_from_outputs,
)
from vap_realtime_tpu_torch.runtime.arena import resolve_device

Params = Dict
Tensor = torch.Tensor


def static_step(params: Params, x1: Tensor, x2: Tensor, e1_context: Tensor,
                e2_context: Tensor, h: Tensor, c: Tensor,
                cfg: VapConfig) -> Tuple[Tensor, ...]:
    """One frame with fully external state.

    x1, x2:             (1, frame_samples) audio chunks
    e1_context/e2_...:  (1, T_CTX, D) previous embeddings (zero-padded on
                        the LEFT for a cold start, like the reference's
                        zero-initialised deque)
    h, c:               (2, D) LSTM state of the two channel encoders

    Returns (p_now, p_future, vad1, vad2, e1, e2, h_new, c_new): p_* are
    the LAST frame's (2,) probabilities, vad1 / vad2 (T_CTX,), and e1 /
    e2 (1, D) this frame's new embeddings for the caller to append.
    """
    wav = torch.cat([x1, x2], dim=0)                    # (2, S)
    e, h_new, c_new = encode_chunk(params["encoder"], wav, h, c,
                                   cfg.downsample_kernel)
    e1 = e[0:1][:, None, :]                             # (1, 1, D)
    e2 = e[1:2][:, None, :]
    ctx1 = torch.cat([e1_context, e1], dim=1)[:, 1:]
    ctx2 = torch.cat([e2_context, e2], dim=1)[:, 1:]
    outs = forward_context(params, ctx1, ctx2, cfg)
    probs = probs_from_outputs(outs, cfg)
    return (probs["p_now"][0, -1], probs["p_future"][0, -1],
            probs["vad"][0, :, 0], probs["vad"][0, :, 1],
            e1[0], e2[0], h_new, c_new)


class StaticStep(torch.nn.Module):
    """`static_step` with its configuration bound, as a module
    `torch.export` takes: forward(params, x1, x2, e1_context, e2_context,
    h, c)."""

    def __init__(self, cfg: VapConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, params: Params, x1: Tensor, x2: Tensor,
                e1_context: Tensor, e2_context: Tensor, h: Tensor,
                c: Tensor) -> Tuple[Tensor, ...]:
        return static_step(params, x1, x2, e1_context, e2_context, h, c,
                           self.cfg)


def make_static_fn(cfg: VapConfig, context_frames: Optional[int] = None,
                   device="cuda"):
    """Bind shapes and return (fn, example_args) for export.

    fn: a `StaticStep`, called as fn(params, *example_args);
    example_args: zero (x1, x2, e1_context, e2_context, h, c) float32 on
    `device` (raises without CUDA unless device="cpu").  context_frames
    defaults to CALC_PROCESS_TIME_INTERVAL - 1 = 99, the reference's
    static export size (tools/export_vap_onnx.py:77-79).
    """
    T = context_frames if context_frames is not None else 99
    D = cfg.dim
    S = cfg.frame_samples
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return StaticStep(cfg), (z(1, S), z(1, S), z(1, T, D), z(1, T, D),
                             z(2, D), z(2, D))
