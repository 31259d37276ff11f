"""The KV cache's data format, decided here and nowhere else in the
runtime.  `KVState.quant` is False (rows in the state dtype), "row"
(`quant=True` too: int8 codes, per-row float32 max-abs/127 scales (B, P,
T) beside the ring and (S, B, P) beside the stage) or "global" (int8
codes, per-(stream, phase, k/v column group) float32 scales (B, P, 1, 4)
frozen at the stream's first active frame, 0 = not yet set).  Here: the
allocation, a frame's encode into the planes a slot write fills, a
ring's re-encode on a resync, the decode for the plain attends, the
attend kernel's call and a slot's reset.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor
# a slot write's (value (B, P', X'), ring (B, P', T[, X']), stage or None)
Plane = Tuple[Tensor, Tensor, Optional[Tensor]]

QUANT_MODES = (False, True, "row", "global")

# quant="global" headroom: the per-stream scale freezes at MARGIN x the
# first active frame's max-abs (per phase x k/v column group); later rows
# that exceed it saturate at +-127 instead of rescaling history.
QG_MARGIN = 1.5


def quantize_rows(rows: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 quantisation over the last axis (quant="row"):
    rows (..., 4D) -> (int8 rows, (...,) float32 max-abs/127 scales).
    torch.round rounds half to even, as jnp.round does."""
    f = rows.float()
    sc = torch.clamp(f.abs().amax(-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(f / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc


def _quantize_global(f: Tensor, gscale: Tensor, active: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """f (B, P', T', 4, D/4) float32 rows, gscale (B, P', 4): unset scales
    (0) of active (B,) streams take QG_MARGIN x the group's max-abs over
    the T' rows / 127, set ones stay.  Returns (int8 codes, the scales)."""
    fresh = torch.clamp(f.abs().amax((2, 4)) * (QG_MARGIN / 127.0), min=1e-8)
    gs = torch.where((gscale == 0) & active[:, None, None], fresh, gscale)
    sc = torch.where(gs == 0, 1.0, gs)[:, :, None, :, None]  # safe divide
    return torch.clamp(torch.round(f / sc), -127, 127).to(torch.int8), gs


def quantize_rows_global(rows: Tensor, gscale: Tensor, active: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """int8 quantisation with per-(stream, phase, k/v group) FROZEN scales
    (quant="global"); the attend folds them outside the kernel.

    rows (B, P, 4D) fresh K/V rows; gscale (B, P, 1, 4) current scales
    (0 = not yet set; slot resets zero them); active (B,) bool; every write
    clamps.  Returns (int8 rows (B, P, 4D), updated gscale)."""
    B, P, D4 = rows.shape
    q, gs = _quantize_global(rows.float().view(B, P, 1, 4, D4 // 4),
                             gscale.view(B, P, 4), active)
    return q.view(B, P, D4), gs.view(B, P, 1, 4)


def quantize_ring_global(rows: Tensor, gscale: Tensor, active: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """The same over one phase's whole ring (the resync): rows (B, T, 4D),
    gscale (B, 4); unset scales calibrate from ALL T rows."""
    B, T, D4 = rows.shape
    q, gs = _quantize_global(rows.float().view(B, 1, T, 4, D4 // 4),
                             gscale.view(B, 1, 4), active)
    return q.view(B, T, D4), gs.view(B, 4)


def alloc(quant: Any, batch: int, P: int, T: int, D: int, S: int,
          staged: bool, dtype, device) -> Dict[str, Any]:
    """A fresh state's quant (False, "row" or "global"), cache, stage (None
    unless `staged`) and scales, as KVState fields."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant {quant!r} not in {QUANT_MODES}")
    mode = "global" if quant == "global" else "row" if quant else False
    codes = dict(dtype=torch.int8 if mode else dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        quant=mode, cache=torch.zeros((batch, P, T, 4 * D), **codes),
        stage=torch.zeros((S, batch, P * 4 * D), **codes) if staged else None,
        scale=(torch.zeros((batch, P, T), **f32) if mode == "row" else
               torch.zeros((batch, P, 1, 4), **f32) if mode else None),
        stage_scale=(torch.zeros((S, batch, P), **f32)
                     if mode == "row" and staged else None))


def encode(kv, rows: Tensor, active: Tensor) -> List[Plane]:
    """A frame's rows (B, P, 4D) as the planes a slot write fills (and the
    "global" scales set on a stream's first active frame)."""
    if kv.quant == "row":
        codes, sc = quantize_rows(rows)                        # (B, P)
        return [(codes, kv.cache, kv.stage), (sc, kv.scale, kv.stage_scale)]
    if kv.quant == "global":
        codes, kv.scale = quantize_rows_global(rows, kv.scale, active)
    else:
        codes = rows.to(kv.lstm_h.dtype)
    return [(codes, kv.cache, kv.stage)]


def encode_ring(kv, ph: int, rows: Tensor, active: Tensor) -> None:
    """Phase ph's whole ring rewritten from rows (B, T, 4D)."""
    if kv.quant == "row":
        kv.cache[:, ph], kv.scale[:, ph] = quantize_rows(rows)
    elif kv.quant == "global":
        kv.cache[:, ph], kv.scale[:, ph, 0] = quantize_ring_global(
            rows, kv.scale[:, ph, 0], active)
    else:
        kv.cache[:, ph] = rows


def load_rows(kv, ph: int, off: int, D: int, staged: bool) -> Tensor:
    """The cached rows of one k or v slot (phase ph, columns [off,
    off + D)), then the staged rows when `staged`: (B, L, D) in the state
    dtype.  An int8 cache is dequantised on load."""
    dtype = kv.lstm_h.dtype
    x = kv.cache[:, ph, :, off:off + D]                       # (B, T, D)
    if kv.quant == "row":
        x = (x.float() * kv.scale[:, ph, :, None]).to(dtype)
    elif kv.quant == "global":
        x = (x.float() * kv.scale[:, ph, 0, off // D, None, None]).to(dtype)
    if staged:
        col = 4 * D * ph + off
        y = kv.stage[:, :, col:col + D]                       # (S, B, D)
        if kv.quant == "row":
            y = (y.float() * kv.stage_scale[:, :, ph, None]).to(dtype)
        elif kv.quant == "global":
            y = (y.float() * kv.scale[None, :, ph, 0, off // D, None]
                 ).to(dtype)
        x = torch.cat([x, y.transpose(0, 1)], dim=1)
    return x


def _fold(op, x: Tensor, c: Tensor, dtype) -> Tensor:
    return op(x, c, out=torch.empty(x.shape, dtype=dtype, device=x.device))


def attend(fn, kv, q2: Tensor, k2: Tensor, v2: Tensor, age: Tensor,
           stage: Optional[Tensor], stage_age: Optional[Tensor], *,
           pair_base: int, **kw) -> Tensor:
    """`fn` (`attend_pair` or its plain version) over the cache with the
    format's arguments: the phase's row scales, or the frozen-scale fold."""
    dtype = kv.lstm_h.dtype
    ph = pair_base // 2
    if kv.quant == "global":
        # the kernel sees a scale-free int8 problem — q rides c_k (scores
        # of dequantised K == scores of codes against q * c_k), k_cur /
        # v_cur ride 1/c so the current position lands in code units, the
        # output scales back by c_v (JAX incremental.py:449-472).  Each
        # fold is one kernel: float32 math (the scales are float32), the
        # result rounded to the state dtype, as the JAX package's casts.
        c = kv.scale[:, ph, 0]                                 # (B, 4)
        c = torch.where(c == 0, 1.0, c)         # 0 (not yet set) reads 1
        ck, cv = c[:, 0::2, None], c[:, 1::2, None]            # (B, 2, 1)
        out = fn(kv.cache, _fold(torch.mul, q2, ck, dtype),
                 _fold(torch.div, k2, ck, dtype),
                 _fold(torch.div, v2, cv, dtype), age, stage, stage_age,
                 pair_base=pair_base, **kw)
        return torch.mul(out, cv, out=out)
    row = kv.quant == "row"
    return fn(kv.cache, q2.to(dtype).contiguous(), k2.to(dtype).contiguous(),
              v2.to(dtype).contiguous(), age, stage, stage_age,
              scale=kv.scale[:, ph] if row else None,
              stage_scale=(kv.stage_scale[:, :, ph]
                           if row and stage is not None else None),
              pair_base=pair_base, **kw)


def reset(kv, mask: Tensor) -> None:
    """The frozen scales of the (B,) `mask` slots zeroed in place, so the
    next stream calibrates anew (row scales are read only for live rows)."""
    if kv.quant == "global":
        kv.scale.masked_fill_(mask.view(-1, 1, 1, 1), 0)
