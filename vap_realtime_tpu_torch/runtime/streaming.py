"""Full-recompute streaming step over a per-stream state (the
parity-exact path).

Port of `vap_realtime_tpu/runtime/streaming.py`.  Reference behaviour
(rvap/vap_main/vap_main.py:249-335): each model frame (16000//frame_hz +
320 samples, 320 of them overlap) is encoded to ONE embedding per
channel, appended to a context buffer of at most
`context_len_sec * frame_hz` embeddings, and the whole transformer re-runs
over the buffered context; the outputs are the last frame's p_now /
p_future / vad.  Cold start attends only over the frames seen so far,
which the fixed-shape buffer reproduces with a validity mask.

- The embedding buffer is right-aligned (newest at index T-1), so
  "append" is a roll and a write of the newest row, and window order is
  buffer order.
- A leading stream axis batches many dialogues; nothing is per-stream
  Python.
- While the window still grows, this path and the incremental `kv_step`
  (runtime/incremental.py) give the same outputs; after it slides the kv
  path deviates boundedly.

Unlike the fast path's in-place state, `stream_step` returns a new
state: the append rewrites the whole buffer anyway.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.encoder import encode_chunk
from vap_realtime_tpu_torch.models.transformer import (
    alibi_bias, combinator, transformer_layer,
)
from vap_realtime_tpu_torch.models.vap import heads_forward, probs_from_outputs

Tensor = torch.Tensor


@dataclass
class StreamState:
    """Per-stream carried state (leading axis = streams).

    lstm_h / lstm_c: (B, 2, D) CPC context-net state of both channels.
    e_ctx: (B, 2, T, D) right-aligned embedding context buffer.
    count: (B,) int32 frames seen so far.
    """

    lstm_h: Tensor
    lstm_c: Tensor
    e_ctx: Tensor
    count: Tensor


def init_stream_state(cfg: VapConfig, batch: int = 1, dtype=torch.float32,
                      device=None) -> StreamState:
    D, T = cfg.encoder_dim, cfg.context_frames
    kw = dict(dtype=dtype, device=device)
    return StreamState(
        lstm_h=torch.zeros((batch, 2, D), **kw),
        lstm_c=torch.zeros((batch, 2, D), **kw),
        e_ctx=torch.zeros((batch, 2, T, D), **kw),
        count=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _encode_and_append(params, state: StreamState, chunk: Tensor,
                       cfg: VapConfig) -> StreamState:
    """chunk: (B, 2, frame_samples) -> the state with the embeddings
    appended."""
    B = chunk.shape[0]
    e, h_new, c_new = encode_chunk(
        params["encoder"], chunk.reshape(B * 2, -1),
        state.lstm_h.reshape(B * 2, -1), state.lstm_c.reshape(B * 2, -1),
        cfg.downsample_kernel)
    # append right-aligned: shift left, write the newest at T-1
    e_ctx = torch.roll(state.e_ctx, -1, dims=2)
    e_ctx[:, :, -1] = e.reshape(B, 2, -1)
    return StreamState(lstm_h=h_new.reshape(B, 2, -1),
                       lstm_c=c_new.reshape(B, 2, -1), e_ctx=e_ctx,
                       count=state.count + 1)


def _masked_bias(cfg: VapConfig, valid: Tensor, dtype=torch.float32
                 ) -> Tuple[Tensor, Tensor]:
    """AliBi + causal bias and the per-stream key mask, kept FACTORED as
    (base (H, T, T), key_ok (B, T)): the combined (B, H, T, T) tensor is
    rank-1 information.

    valid: (B,) number of real frames in the right-aligned buffer; slot j
    is a real frame iff j >= T - valid.  Slot indices for the AliBi ramp
    are exact: per query row they differ from window positions by a
    constant, which softmax cancels.  The attention keeps the diagonal
    allowed (`key_ok | eye`), so pre-history query rows have one finite
    score and no NaN reaches the valid rows."""
    T = cfg.context_frames
    base = alibi_bias(T, cfg.num_heads, cfg.context_limit, dtype,
                      valid.device)
    j = torch.arange(T, device=valid.device)
    return base, j[None, :] >= (T - valid)[:, None]


def _masked_layer(layer, x: Tensor, base: Tensor, key_ok: Tensor,
                  cfg: VapConfig, src: Optional[Tensor] = None) -> Tensor:
    """`transformer_layer` with the factored (H, T, T) bias + (B, T) key
    mask (the diagonal always allowed)."""
    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device)
    allowed = key_ok[:, None, None, :] | eye[None, None]      # (B,1,T,T)
    return transformer_layer(layer, x, base, cfg.num_heads, src, allowed)


def trunk_full(params, e1: Tensor, e2: Tensor, bias: Tuple[Tensor, Tensor],
               cfg: VapConfig) -> Dict[str, Tensor]:
    """Stereo trunk over fixed-size buffers with the factored masking:
    `models.vap.trunk_forward` with per-stream validity for the growing
    cold-start context."""
    B = e1.shape[0]
    base, key_ok = bias
    x = torch.cat([e1, e2])
    key_ok2 = torch.cat([key_ok, key_ok])
    for layer in params["ar_channel"]["layers"]:
        x = _masked_layer(layer, x, base, key_ok2, cfg)
    o1, o2 = x[:B], x[B:]
    x1, x2 = o1, o2
    for layer in params["ar"]["layers"]:
        x1, x2 = (_masked_layer(layer, x1, base, key_ok, cfg, src=x2),
                  _masked_layer(layer, x2, base, key_ok, cfg, src=x1))
    xc = combinator(params["ar"]["combinator"], x1, x2)
    return {"x": xc, "x1": x1, "x2": x2, "o1": o1, "o2": o2}


def stream_step(params, state: StreamState, chunk: Tensor, cfg: VapConfig,
                active: Optional[Tensor] = None
                ) -> Tuple[StreamState, Dict[str, Tensor]]:
    """One streaming frame for a batch of streams (full recompute).

    chunk: (B, 2, frame_samples).  Returns (new_state, results); every
    result has leading dim B and is the LAST frame's value
    (VAPRealTime.process_vap's `result_*`, vap_main.py:295-320).

    active: optional (B,) bool — streams without a fresh frame this tick
    are FROZEN (state unchanged, outputs to be ignored).
    """
    new = _encode_and_append(params, state, chunk, cfg)
    if active is not None:
        a = active.view(-1, 1, 1)
        new = StreamState(
            lstm_h=torch.where(a, new.lstm_h, state.lstm_h),
            lstm_c=torch.where(a, new.lstm_c, state.lstm_c),
            e_ctx=torch.where(a[..., None], new.e_ctx, state.e_ctx),
            count=torch.where(active, new.count, state.count))
    valid = torch.clamp(new.count, max=cfg.context_frames)
    bias = _masked_bias(cfg, valid, new.e_ctx.dtype)
    trunk = trunk_full(params, new.e_ctx[:, 0], new.e_ctx[:, 1], bias, cfg)
    probs = probs_from_outputs(heads_forward(params, trunk, cfg), cfg)
    # the newest frame only (the buffer is right-aligned)
    return new, {k: v[:, -1] for k, v in probs.items()}


def run_frames(params, state: StreamState, frames: Tensor, cfg: VapConfig
               ) -> Tuple[StreamState, Dict[str, Tensor]]:
    """`stream_step` over pre-framed audio (F, B, 2, frame_samples) in
    time order (see `frame_audio`); returns the final state and the
    results stacked over frames, each (F, B, ...) (the offline path;
    reference vap_offline.py:51-63)."""
    return scan_frames(stream_step, params, state, frames, cfg)


def scan_frames(step, params, state, frames: Tensor, cfg: VapConfig):
    """`step(params, state, frame, cfg) -> (state, outputs)` over the
    frames in order, the outputs stacked over frames (F, B, ...), like
    the JAX package's lax.scan."""
    outs: Dict[str, List[Tensor]] = {}
    for f in range(frames.shape[0]):
        state, o = step(params, state, frames[f], cfg)
        for k, v in o.items():
            outs.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in outs.items()}


def frame_audio(audio: np.ndarray, cfg: VapConfig) -> np.ndarray:
    """(C, N) waveform -> (F, C, frame_samples) overlapping frames that
    advance by `frame_shift` and overlap by 320 samples, the reference
    windowing (vap_offline.py:47-63).  numpy in and out."""
    frame, shift = cfg.frame_samples, cfg.frame_shift
    starts = [i for i in range(0, audio.shape[-1], shift)
              if i + frame <= audio.shape[-1]]
    return np.stack([audio[..., i:i + frame] for i in starts])
