"""Incremental streaming steps — per-frame KV-cache append, single-query
attention, no full-context recompute: `kv_step` (the chunked encoder over
overlapped frames) and `fast_step` (the streaming encoder over fresh
samples, the fast serving path); and their hybrid twins `hybrid_step` /
`fast_hybrid_step`, which every `resync_every` ticks recompute the trunk
over an embedding ring and rewrite the cache drift-free.

Port of `vap_realtime_tpu/runtime/incremental.py`: the same phase-major
cache layout, per-stream stamps, slot policies, staged merge and int8
cache modes, so that states compare one to one with the JAX package.

- ALL per-frame K/V vectors (28 for 1 channel layer + 3 stereo layers)
  live in ONE phase-major cache (B, P=7, T, 4*D): each layer phase's twin
  k/v pairs form one per-stream-contiguous (T, 4D) plane, read by one
  `attend_pair` launch.
- Each attention reads the T cached rows (ages >= 1) plus the current
  position's fresh k/v (age 0); the frame's cache write is deferred to
  the end of the step.
- Ages are `count - stamp` in each stream's own frame timeline, so a
  frozen stream's rows do not age; dead rows carry age DEAD.
- The cache is the state dtype, or int8 codes (half the bytes) with
  per-row scales (`quant="row"`) or per-stream scales frozen at the
  stream's first active frame (`quant="global"`).

PyTorch idiom: the step updates its state IN PLACE and returns it — the
cache and the stage are written with indexed in-place stores (no
cache-sized copy per step), and the small tensors (counts, LSTM and conv
carries) are rebound on the same state object.  `KVState.step`, the
global frame counter, is a host int: the staged-merge cadence and the
"global" write slot are decided on the host with no device sync.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.encoder import (
    check_conv_impl, encode_chunk, encode_chunk_streaming,
    init_conv_stream_state,
)
from vap_realtime_tpu_torch.models.transformer import alibi_slopes, combinator
from vap_realtime_tpu_torch.models.vap import heads_forward, probs_from_outputs
from vap_realtime_tpu_torch.ops.basic import gelu, layer_norm, linear
from vap_realtime_tpu_torch.ops.cuda.attend import (
    DEAD, attend_pair, attend_pair_plain,
)
from vap_realtime_tpu_torch.runtime.streaming import (
    _masked_bias, scan_frames, trunk_full,
)

Params = Dict[str, Any]
Tensor = torch.Tensor

STAGE_S = 8  # staged-slot policy: frames buffered between ring merges

ATTEND_IMPLS = ("kernel", "kernel3", "plain", "plain3", "grouped", "einsum")
# the compact-softmax attends: ring rows only, no staged form
COMPACT_IMPLS = ("kernel3", "plain3")
QUANT_MODES = (False, True, "row", "global")

# quant="global" headroom: the per-stream scale freezes at MARGIN x the
# first active frame's max-abs (per phase x k/v column group); later rows
# that exceed it saturate at +-127 instead of rescaling history.
QG_MARGIN = 1.5


def cache_layout(cfg: VapConfig) -> List[str]:
    """Fixed slot order of the fused cache's last dim (28 x D for the
    default 1 channel layer + 3 cross layers).  Every k/v pair is
    adjacent and the TWIN pairs of each attend phase form one 4-slot
    phase: slot s maps to cache[:, s // 4, :, (s % 4) * D:]."""
    names = []
    for li in range(cfg.channel_layers):
        for ch in (0, 1):
            names += [f"ch{li}.{ch}.k", f"ch{li}.{ch}.v"]
    for li in range(cfg.cross_layers):
        for tw in (0, 1):
            names += [f"x{li}.{tw}.sk", f"x{li}.{tw}.sv"]
        for tw in (0, 1):
            names += [f"x{li}.{tw}.ck", f"x{li}.{tw}.cv"]
    return names


def quantize_rows(rows: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 quantisation over the last axis (quant="row"):
    rows (..., 4D) -> (int8 rows, (...,) float32 max-abs/127 scales).
    torch.round rounds half to even, as jnp.round does."""
    f = rows.float()
    sc = torch.clamp(f.abs().amax(-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(f / sc[..., None]), -127, 127)
    return q.to(torch.int8), sc


def quantize_rows_global(rows: Tensor, gscale: Tensor, active: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """int8 quantisation with per-(stream, phase, k/v group) FROZEN scales
    (quant="global"); the attend folds them outside the kernel.

    rows (B, P, 4D) fresh K/V rows; gscale (B, P, 1, 4) current scales
    (0 = not yet set); active (B,) bool.  A stream's scales are set once,
    on its first active frame (slot resets zero them), at QG_MARGIN x
    that frame's per-group max-abs / 127; every write clamps.  Returns
    (int8 rows (B, P, 4D), updated gscale)."""
    B, P, D4 = rows.shape
    f = rows.float().reshape(B, P, 4, D4 // 4)
    amax = f.abs().amax(-1)[:, :, None, :]                 # (B, P, 1, 4)
    fresh = torch.clamp(amax * (QG_MARGIN / 127.0), min=1e-8)
    gs = torch.where((gscale == 0) & active[:, None, None, None], fresh,
                     gscale)
    sc = torch.where(gs == 0, 1.0, gs)                     # safe divide
    q = torch.clamp(torch.round(f / sc.transpose(2, 3)), -127, 127)
    return q.to(torch.int8).reshape(B, P, D4), gs


@dataclass
class KVState:
    """Fused-KV streaming state (see the module docstring).

    cache:  (B, P, T, 4*D) phase-major K/V rows (int8 codes when
            quantised).
    lstm_h/lstm_c: (B, 2, D) encoder context-net state.
    count:  (B,) int32 frames seen per stream.
    stamp:  (B, T) int32 `count` at which each ring row was written,
            -1 = invalid row.
    step:   host int, global frame counter (tick index).
    stage / stage_stamp: "staged" policy only (else None) — stage
            (S, B, P*4D) frame-major staged rows (stage[i] holds tick
            g = i mod S); stage_stamp (S, B) the stream's `count` at
            staging, -1 = invalid (frozen tick, or merged).
    scale:  int8 cache only (else None); its ndim names the mode.
            quant="row": (B, P, T) float32 per-row max-abs/127 scales;
            quant="global": (B, P, 1, 4) float32 per-(stream, phase,
            k/v column group) scales frozen at the stream's first active
            frame, 0 = not yet set.
    stage_scale: (S, B, P) row scales of the staged rows, quant="row"
            with the staged policy only (else None).
    """

    cache: Tensor
    lstm_h: Tensor
    lstm_c: Tensor
    count: Tensor
    stamp: Tensor
    step: int
    stage: Optional[Tensor] = None
    stage_stamp: Optional[Tensor] = None
    scale: Optional[Tensor] = None
    stage_scale: Optional[Tensor] = None

    @property
    def quant(self) -> Any:
        """False, "row" or "global", read from the scales' ndim."""
        if self.scale is None:
            return False
        return "global" if self.scale.dim() == 4 else "row"


def init_kv_state(cfg: VapConfig, batch: int = 1, dtype=torch.float32,
                  staged: bool = False, device=None, *,
                  quant: Any = False) -> KVState:
    """staged=True adds the (S, B, P*4D) stage that slots="staged" needs.

    quant: False (a `dtype` cache) | True / "row" (int8 cache, per-row
    scales) | "global" (int8 cache, per-stream frozen scales)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant {quant!r} not in {QUANT_MODES}")
    D, T = cfg.dim, cfg.context_frames
    P = len(cache_layout(cfg)) // 4
    S = STAGE_S
    if staged and S > T:
        # the merge targets stamp % T and relies on the S staged stamps
        # being distinct mod T
        raise ValueError(
            f"staged slots need context_frames >= {S} (got {T}); use "
            f"slots='stream' for tiny-context configs")
    kw = dict(dtype=dtype, device=device)
    ckw = dict(dtype=torch.int8 if quant else dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    scale = stage_scale = None
    if quant == "global":
        scale = torch.zeros((batch, P, 1, 4), **f32)
    elif quant:
        scale = torch.zeros((batch, P, T), **f32)
        if staged:
            stage_scale = torch.zeros((S, batch, P), **f32)
    return KVState(
        cache=torch.zeros((batch, P, T, 4 * D), **ckw),
        lstm_h=torch.zeros((batch, 2, D), **kw),
        lstm_c=torch.zeros((batch, 2, D), **kw),
        count=torch.zeros((batch,), **i32),
        stamp=torch.full((batch, T), -1, **i32),
        step=0,
        stage=torch.zeros((S, batch, P * 4 * D), **ckw) if staged else None,
        stage_stamp=torch.full((S, batch), -1, **i32) if staged else None,
        scale=scale,
        stage_scale=stage_scale,
    )


def kv_step(params: Params, state: KVState, chunk: Tensor, cfg: VapConfig,
            active: Optional[Tensor] = None, slots: str = "stream",
            attend_impl: str = "einsum", merge: str = "auto"
            ) -> Tuple[KVState, Dict[str, Tensor]]:
    """One incremental frame: chunk (B, 2, frame_samples), overlapped
    frames as the full-recompute path takes them, -> probabilities.  The
    chunked encoder (`encode_chunk`) feeds `_kv_core`; the trunk order is
    that of VAPRealTime.process_vap (vap_main.py:272-307), touching only
    the newest position.  Updates `state` in place and returns it.

    active: (B,) bool; streams without a fresh frame this tick are
    FROZEN (recurrent state, count and cached rows unchanged; outputs to
    be ignored).  slots, attend_impl, merge: see `_kv_core`.
    """
    active = _all_active(chunk, active)
    e, h_new, c_new = _chunked_encode(params, state, chunk, cfg)
    outs = _kv_core(params, state, e, h_new, c_new, cfg, active, slots,
                    attend_impl, merge)
    return state, outs


def _chunked_encode(params: Params, kv: KVState, chunk: Tensor,
                    cfg: VapConfig):
    """The chunked encoder over overlapped frames (B, 2, frame_samples):
    (e, h_new, c_new), each (B, 2, D); e in the state dtype."""
    B = chunk.shape[0]
    e, h_new, c_new = encode_chunk(
        params["encoder"], chunk.reshape(B * 2, -1),
        kv.lstm_h.reshape(B * 2, -1), kv.lstm_c.reshape(B * 2, -1),
        cfg.downsample_kernel)
    return (e.reshape(B, 2, cfg.dim).to(kv.lstm_h.dtype),
            h_new.reshape(B, 2, -1), c_new.reshape(B, 2, -1))


def run_frames_kv(params: Params, state: KVState, frames: Tensor,
                  cfg: VapConfig, slots: str = "global",
                  attend_impl: str = "einsum"):
    """kv_step over (F, B, 2, frame_samples) frames; returns (state,
    {name: (F, B, ...)}).  Every stream is active every frame, so the
    default "global" slot policy equals "stream" (count == step
    throughout) at the cheapest write."""
    return scan_frames(functools.partial(kv_step, slots=slots,
                                         attend_impl=attend_impl),
                       params, state, frames, cfg)


def _scatter_rows(cache: Tensor, rows: Tensor, idx: Tensor,
                  valid: Tensor) -> None:
    """In place: cache[b, :, idx[b]] = rows[b] for every stream b with
    valid[b]; other streams' rows stay as they are.

    cache (B, P, T, X); rows (B, P, X); idx (B,) int; valid (B,) bool.
    The JAX package writes with `.at[...].set(mode="drop")` and parks
    the invalid streams' targets out of range (T, or T + i); torch's
    index_put_ raises on out-of-range targets instead.  So an invalid
    stream writes its OWN current row at an in-range position (0): one
    target per stream, no duplicates, no change.
    """
    b = torch.arange(cache.shape[0], device=cache.device)
    t = torch.where(valid, idx, 0)
    old = cache[b, :, t]                                   # (B, P, X)
    cache[b, :, t] = torch.where(valid.view(-1, 1, 1), rows, old)


def _scatter_rows_multi(cache: Tensor, vals: Tensor, idx: Tensor,
                        valid: Tensor) -> None:
    """S-row variant of `_scatter_rows` (the staged-merge write), one row
    per stream at a time: vals (S, B, P, X); idx, valid (S, B).  A
    stream's valid targets are distinct, so the order does not matter."""
    for i in range(vals.shape[0]):
        _scatter_rows(cache, vals[i], idx[i], valid[i])


@functools.lru_cache(maxsize=None)
def _alibi(H: int, device: torch.device) -> Tensor:
    """(H,) float32 AliBi slopes, built once per device."""
    return torch.tensor(alibi_slopes(H), dtype=torch.float32, device=device)


def _load_rows(state: KVState, ph: int, off: int, D: int,
               staged: bool) -> Tensor:
    """The cached rows of one k or v slot (phase ph, columns [off,
    off + D)), then the staged rows when `staged`: (B, L, D) in the state
    dtype.  An int8 cache is dequantised on load."""
    dtype = state.lstm_h.dtype
    quant = state.quant
    x = state.cache[:, ph, :, off:off + D]                 # (B, T, D)
    if quant == "row":
        x = (x.float() * state.scale[:, ph, :, None]).to(dtype)
    elif quant == "global":
        x = (x.float() * state.scale[:, ph, 0, off // D, None, None]
             ).to(dtype)
    if staged:
        col = 4 * D * ph + off
        y = state.stage[:, :, col:col + D]                   # (S, B, D)
        if quant == "row":
            y = (y.float() * state.stage_scale[:, :, ph, None]).to(dtype)
        elif quant == "global":
            y = (y.float() * state.scale[None, :, ph, 0, off // D, None]
                 ).to(dtype)
        x = torch.cat([x, y.transpose(0, 1)], dim=1)
    return x


def _einsum_attend(state: KVState, q: Tensor, k_cur: Tensor, v_cur: Tensor,
                   slot_k: int, bias: Tensor, H: int,
                   staged: bool) -> Tensor:
    """Single-query softmax attention over the cached rows (+ the staged
    rows when `staged`) + the current position, in einsum form (the JAX
    package's `attend`, incremental.py:486-576).  q, k_cur, v_cur:
    (B, D); bias: (B, H, L) additive AliBi/validity bias of the L read
    rows.  An int8 cache is dequantised on load to the state dtype."""
    B, D = q.shape
    Dh = D // H
    dtype = state.lstm_h.dtype
    ph, ko = slot_k // 4, (slot_k % 4) * D
    k_old = _load_rows(state, ph, ko, D, staged)
    v_old = _load_rows(state, ph, ko + D, D, staged)
    L = k_old.shape[1]
    scale = 1.0 / math.sqrt(D)
    # bf16 operands, float32 products and sums (JAX: preferred f32)
    qh = q.reshape(B, H, Dh).to(dtype)
    s_old = torch.einsum("bhd,bthd->bht", qh.float(),
                         k_old.reshape(B, L, H, Dh).float())
    s_old = s_old * scale + bias
    s_cur = ((qh * k_cur.reshape(B, H, Dh)).float()
             .sum(-1, keepdim=True) * scale)                # (B, H, 1)
    w = torch.softmax(torch.cat([s_old, s_cur], dim=-1), dim=-1)
    out = (torch.einsum("bht,bthd->bhd", w[:, :, :L].to(dtype).float(),
                        v_old.reshape(B, L, H, Dh).float())
           + w[:, :, L:] * v_cur.reshape(B, H, Dh).float())
    return out.reshape(B, D).to(dtype)


def _grouped_attend(state: KVState, q: Tensor, k_cur: Tensor,
                    v_cur: Tensor, slot_k: int, age: Tensor, slopes: Tensor,
                    H: int, staged: bool) -> Tensor:
    """The JAX package's head-free "grouped" attend (incremental.py:
    521-554) with its rounding points: k * q in the state dtype, head sums
    in float32 times 1/sqrt(D), minus age * slope; a softmax shifted by
    max(max_t s, s_cur); the weights rounded to the state dtype and
    multiplied with v in it, summed in float32; the current weight in
    float32.  age: (B, L) float32 ages of the L read rows, DEAD for dead
    ones."""
    B, D = q.shape
    Dh = D // H
    dtype = state.lstm_h.dtype
    ph, ko = slot_k // 4, (slot_k % 4) * D
    k_old = _load_rows(state, ph, ko, D, staged)              # (B, L, D)
    v_old = _load_rows(state, ph, ko + D, D, staged)
    L = k_old.shape[1]
    scale = 1.0 / math.sqrt(D)
    qd = q.to(dtype)
    s = (k_old * qd[:, None]).float().view(B, L, H, Dh).sum(-1) * scale
    s = s - age[:, :, None] * slopes
    s_cur = (k_cur.to(dtype) * qd).float().view(B, H, Dh).sum(-1) * scale
    mx = torch.maximum(s.amax(1), s_cur)                      # (B, H)
    w = torch.exp(s - mx[:, None])
    w_cur = torch.exp(s_cur - mx)
    denom = w.sum(1) + w_cur
    out = (w.to(dtype)[..., None] * v_old.view(B, L, H, Dh)).float().sum(1)
    out = out + w_cur[..., None] * v_cur.float().view(B, H, Dh)
    return (out / denom[..., None]).reshape(B, D).to(dtype)


def _kv_core(params: Params, state: KVState, e: Tensor, h_new: Tensor,
             c_new: Tensor, cfg: VapConfig, active: Tensor, slots: str,
             attend_impl: str = "einsum", merge: str = "auto"
             ) -> Dict[str, Tensor]:
    """Post-encoder incremental step, in place on `state`: e (B, 2, D)
    fresh embeddings -> single-query attentions over the fused cache +
    one slot write.  Returns the probability outputs (B, ...).

    attend_impl: "kernel" (`attend_pair`: the CUDA kernel on a CUDA
    tensor, its plain version on the CPU), "plain" (`attend_pair_plain`
    on any device), "kernel3" / "plain3" (the same with the compact body,
    K10, the JAX package's "pallas3"; ring rows only, so not with
    slots="staged"), "grouped" or "einsum" (plain PyTorch).
    merge (staged slots): "auto" merges when (step + 1) % STAGE_S == 0,
    "never" / "force" let the caller decide.
    """
    if attend_impl not in ATTEND_IMPLS:
        raise ValueError(f"attend_impl {attend_impl!r} not in "
                         f"{ATTEND_IMPLS}")
    B = e.shape[0]
    D, T, H = cfg.dim, cfg.context_frames, cfg.num_heads
    layout = cache_layout(cfg)
    P = len(layout) // 4
    dtype = state.lstm_h.dtype
    quant = state.quant
    row = quant == "row"
    g = state.step
    staged = slots == "staged"
    if staged and state.stage is None:
        raise ValueError('slots="staged" needs a state built with '
                         'staged=True')
    compact = attend_impl in COMPACT_IMPLS
    if staged and compact:
        raise ValueError(f"staged slots: use attend_impl='kernel' (the "
                         f"compact body of {attend_impl!r} has no staged "
                         f"form)")

    # ages of cached rows relative to the current frame (age 0 = this
    # frame, written at the END of the step) in each stream's own
    # timeline; a row is live iff its stamp is valid AND within the last
    # T-1 own frames.  Dead rows get age DEAD: weight exactly 0.
    age = state.count[:, None] - state.stamp               # (B, T)
    max_age = state.count.clamp(max=T - 1)
    live = (state.stamp >= 0) & (age <= max_age[:, None])
    if cfg.context_limit > 0:
        live = live & (age < cfg.context_limit)
    age_f = torch.where(live, age.float(), DEAD)
    age_st_f = None
    if staged:
        # staged rows: also younger than `count` — a slot reset can leave
        # stale stage stamps >= the new count (incremental.py:404-414)
        age_st = state.count[None, :] - state.stage_stamp  # (S, B)
        live_st = ((state.stage_stamp >= 0) & (age_st >= 1)
                   & (age_st <= max_age[None, :]))
        if cfg.context_limit > 0:
            live_st = live_st & (age_st < cfg.context_limit)
        # (S, B) float32 ages; the TPU kernel took them in the state dtype
        age_st_f = torch.where(live_st, age_st.float(), DEAD)

    if attend_impl in ("einsum", "grouped"):
        slopes = _alibi(H, e.device)
        age_cat, live_cat = age_f, live
        if staged:
            age_cat = torch.cat([age_f, age_st_f.T], dim=1)
            live_cat = torch.cat([live, live_st.T], dim=1)
    if attend_impl == "einsum":
        bias = torch.where(
            live_cat[:, None, :],
            -torch.where(live_cat, age_cat, 0.0)[:, None, :]
            * slopes[None, :, None], float("-inf"))        # (B, H, L)

    if quant == "global":
        # the frozen scales, 0 (not yet set) read as 1
        gscale_safe = torch.where(state.scale == 0, 1.0, state.scale)

    def attend2(q2, k2, v2, pair_base):
        """Twin attentions of one phase; set s reads pair pair_base + s."""
        if attend_impl == "einsum":
            return torch.stack([
                _einsum_attend(state, q2[:, s], k2[:, s], v2[:, s],
                               2 * (pair_base + s), bias, H, staged)
                for s in (0, 1)], dim=1)
        if attend_impl == "grouped":
            return torch.stack([
                _grouped_attend(state, q2[:, s], k2[:, s], v2[:, s],
                                2 * (pair_base + s), age_cat, slopes, H,
                                staged)
                for s in (0, 1)], dim=1)
        fn = functools.partial(
            attend_pair if attend_impl in ("kernel", "kernel3")
            else attend_pair_plain, impl="compact" if compact else "bcast")
        ph = pair_base // 2
        stage = state.stage if staged else None
        if quant == "global":
            # frozen-scale fold: the kernel sees a scale-free int8
            # problem — q rides c_k (scores of dequantised K == scores of
            # codes against q * c_k), k_cur / v_cur ride 1/c so the
            # current position lands in code units, the output scales
            # back by c_v (JAX incremental.py:449-472).  Each fold is one
            # kernel: float32 math (the scales are float32), the result
            # rounded to the state dtype, as the JAX package's casts.
            c = gscale_safe[:, ph, 0]                          # (B, 4)
            ck, cv = c[:, 0::2, None], c[:, 1::2, None]        # (B, 2, 1)
            fold = lambda op, x, c: op(x, c, out=torch.empty(
                x.shape, dtype=dtype, device=x.device))
            out = fn(state.cache, fold(torch.mul, q2, ck),
                     fold(torch.div, k2, ck), fold(torch.div, v2, cv),
                     age_f, stage, age_st_f, pair_base=pair_base,
                     num_heads=H)
            return torch.mul(out, cv, out=out)
        return fn(state.cache, q2.to(dtype).contiguous(),
                  k2.to(dtype).contiguous(), v2.to(dtype).contiguous(),
                  age_f, stage, age_st_f,
                  scale=state.scale[:, ph] if row else None,
                  stage_scale=(state.stage_scale[:, :, ph]
                               if row and staged else None),
                  pair_base=pair_base, num_heads=H)

    def ffn(x, layer):
        h = layer_norm(x, layer["ln_ffn"]["w"], layer["ln_ffn"]["b"])
        return x + linear(gelu(linear(h, layer["ffn"]["w1"])),
                          layer["ffn"]["w2"])

    new_vecs: Dict[str, Tensor] = {}
    # both channels / towers ride a size-2 axis at dim 1 (shared weights)
    x = e
    for li, layer in enumerate(params["ar_channel"]["layers"]):
        z = layer_norm(x, layer["ln_self"]["w"], layer["ln_self"]["b"])
        q = linear(z, layer["attn"]["q"])
        k = linear(z, layer["attn"]["k"])
        v = linear(z, layer["attn"]["v"])
        for ch in (0, 1):
            new_vecs[f"ch{li}.{ch}.k"] = k[:, ch]
            new_vecs[f"ch{li}.{ch}.v"] = v[:, ch]
        a = linear(attend2(q, k, v, 2 * li), layer["attn"]["proj"])
        x = ffn(x + a, layer)
    o1, o2 = x[:, 0], x[:, 1]

    for li, layer in enumerate(params["ar"]["layers"]):
        base = 2 * cfg.channel_layers + 4 * li
        z = layer_norm(x, layer["ln_self"]["w"], layer["ln_self"]["b"])
        q = linear(z, layer["attn"]["q"])
        k = linear(z, layer["attn"]["k"])
        v = linear(z, layer["attn"]["v"])
        for tw in (0, 1):
            new_vecs[f"x{li}.{tw}.sk"] = k[:, tw]
            new_vecs[f"x{li}.{tw}.sv"] = v[:, tw]
        x_mid = x + linear(attend2(q, k, v, base), layer["attn"]["proj"])
        # cross phase: query from LN(x_mid); K/V from the RAW pre-update
        # OTHER tower (modules.py:276-283: src is not normalized).  JAX
        # swaps the twin axis with [:, ::-1]; torch has no negative-stride
        # slice, so flip(1) (a copy).
        zc = layer_norm(x_mid, layer["ln_src"]["w"], layer["ln_src"]["b"])
        qc = linear(zc, layer["attn_cross"]["q"])
        kc = linear(x, layer["attn_cross"]["k"]).flip(1)
        vc = linear(x, layer["attn_cross"]["v"]).flip(1)
        for tw in (0, 1):
            new_vecs[f"x{li}.{tw}.ck"] = kc[:, tw]
            new_vecs[f"x{li}.{tw}.cv"] = vc[:, tw]
        c = linear(attend2(qc, kc, vc, base + 2), layer["attn_cross"]["proj"])
        x = ffn(x_mid + c, layer)
    x1, x2 = x[:, 0], x[:, 1]
    xc = combinator(params["ar"]["combinator"], x1, x2)

    # --- the frame's single cache write: rows (B, P, 4D) phase-major
    rows = torch.stack(
        [torch.cat([new_vecs[n] for n in layout[4 * ph:4 * ph + 4]], dim=-1)
         for ph in range(P)], dim=1)
    if quant == "row":
        rows, scale_new = quantize_rows(rows)                  # (B, P)
    elif quant == "global":
        # frozen scales: no per-row scale state in any slot policy
        rows, state.scale = quantize_rows_global(rows, state.scale, active)
    else:
        rows = rows.to(dtype)
    # stamps and row scales ride the same row writer as (B, 1|P, T, 1)
    # views
    stamp4 = state.stamp.view(B, 1, T, 1)
    if staged:
        S = state.stage.shape[0]
        si = g % S
        state.stage[si] = rows.reshape(B, -1)
        state.stage_stamp[si] = torch.where(active, state.count, -1)
        if row:
            state.stage_scale[si] = scale_new
        do_merge = ((g + 1) % STAGE_S == 0 if merge == "auto"
                    else merge == "force")
        if do_merge:
            # every S ticks: each staged row goes to its stream's own ring
            # position stamp % T (placement identical to "stream")
            valid = state.stage_stamp >= 0                     # (S, B)
            idx = torch.remainder(state.stage_stamp, T)
            _scatter_rows_multi(state.cache,
                                state.stage.view(S, B, P, -1), idx, valid)
            _scatter_rows_multi(stamp4, state.stage_stamp.view(S, B, 1, 1),
                                idx, valid)
            if row:
                _scatter_rows_multi(state.scale[..., None],
                                    state.stage_scale[..., None], idx, valid)
            state.stage_stamp.fill_(-1)
    elif slots == "stream":
        # per-stream ring position; a frozen tick touches nothing
        idx = torch.remainder(state.count, T)
        _scatter_rows(state.cache, rows, idx, active)
        _scatter_rows(stamp4, state.count.view(B, 1, 1), idx, active)
        if row:
            _scatter_rows(state.scale[..., None], scale_new[..., None], idx,
                          active)
    elif slots == "global":
        # one scalar slot for all streams; frozen streams keep their row
        t = g % T
        keep = active.view(B, 1, 1)
        state.cache[:, :, t] = torch.where(keep, rows, state.cache[:, :, t])
        state.stamp[:, t] = torch.where(active, state.count,
                                        state.stamp[:, t])
        if row:
            state.scale[:, :, t] = torch.where(active.view(B, 1), scale_new,
                                               state.scale[:, :, t])
    else:
        raise ValueError(f"unknown slots policy {slots!r}")

    trunk = {"x": xc[:, None], "o1": o1[:, None], "o2": o2[:, None],
             "x1": x1[:, None], "x2": x2[:, None]}
    probs = probs_from_outputs(heads_forward(params, trunk, cfg), cfg)

    a3 = active.view(B, 1, 1)
    state.lstm_h = torch.where(a3, h_new.to(dtype), state.lstm_h)
    state.lstm_c = torch.where(a3, c_new.to(dtype), state.lstm_c)
    state.count = state.count + active.to(torch.int32)
    state.step = g + 1
    return {k: v[:, -1] for k, v in probs.items()}


# ---------------------------------------------------------------------------
# Fast path: seamless streaming conv + incremental KV
# ---------------------------------------------------------------------------

@dataclass
class FastState:
    """KVState plus the streaming-conv input tails (per CHANNEL-stream:
    B*2 leading axis, slot i owns rows 2i and 2i+1)."""

    kv: KVState
    conv: Dict[str, Tensor]


def init_fast_state(cfg: VapConfig, batch: int = 1, dtype=torch.float32,
                    staged: bool = False, device=None, *,
                    quant: Any = False, conv_impl: str = "conv"
                    ) -> FastState:
    """quant: see `init_kv_state`; conv_impl: see `fast_step` (every
    form shares one channels-last conv state layout)."""
    check_conv_impl(conv_impl)
    return FastState(
        kv=init_kv_state(cfg, batch, dtype, staged, device, quant=quant),
        conv=init_conv_stream_state(batch * 2, cfg.encoder_dim, dtype,
                                    device))


def fast_step(params: Params, state: FastState, new: Tensor,
              cfg: VapConfig, active: Optional[Tensor] = None,
              slots: str = "global", attend_impl: str = "einsum",
              conv_impl: str = "conv", conv_chunks: int = 1,
              merge: str = "auto"
              ) -> Tuple[FastState, Dict[str, Tensor]]:
    """One fast-path frame: new (B, 2, 16000//frame_hz) FRESH samples
    (no 320-sample overlap) -> probabilities.  Updates `state` in place
    and returns it with the outputs.

    active: (B,) bool; streams without a fresh frame this tick are FROZEN
    (state untouched; their outputs are to be ignored).  conv_impl:
    "conv" (PyTorch convs + ChannelNorm), "normk" (the ChannelNorm+ReLU
    kernel between the convs), "fused" (the whole stack in one kernel) or
    "blocked" (stride-block matmuls); see `encode_chunk_streaming`.
    conv_chunks > 1 runs the encoder over that many sequential
    sub-batches (smaller transient activations; identical numerics).
    """
    active = _all_active(new, active)
    e, h_new, c_new = _fast_encode(params, state, new, cfg, active,
                                   conv_impl, conv_chunks)
    outs = _kv_core(params, state.kv, e, h_new, c_new, cfg, active, slots,
                    attend_impl, merge)
    return state, outs


def _all_active(x: Tensor, active: Optional[Tensor]) -> Tensor:
    """`active`, or every stream of the (B, ...) frame batch x."""
    if active is not None:
        return active
    return torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)


def _fast_encode(params: Params, state, new: Tensor, cfg: VapConfig,
                 active: Tensor, conv_impl: str, conv_chunks: int):
    """The fast path's streaming encoder over FRESH samples (B, 2, L):
    updates the active streams' conv tails in `state.conv` in place and
    returns (e, h_new, c_new), each (B, 2, D); e in the state dtype."""
    B = new.shape[0]
    D = cfg.dim
    kv = state.kv
    dtype = kv.lstm_h.dtype
    flat = new.reshape(B * 2, -1)
    h0 = kv.lstm_h.reshape(B * 2, -1)
    c0 = kv.lstm_c.reshape(B * 2, -1)
    enc = params["encoder"]
    k = conv_chunks if conv_chunks > 1 and (B * 2) % conv_chunks == 0 else 1
    n = B * 2 // k
    parts = [encode_chunk_streaming(
        enc, flat[i * n:(i + 1) * n],
        {name: c[i * n:(i + 1) * n] for name, c in state.conv.items()},
        h0[i * n:(i + 1) * n], c0[i * n:(i + 1) * n], cfg.downsample_kernel,
        conv_impl)
        for i in range(k)]
    # the embedding enters the trunk in the state dtype (as in JAX)
    e = torch.cat([p[0] for p in parts]).reshape(B, 2, D).to(dtype)
    h_new = torch.cat([p[2] for p in parts]).reshape(B, 2, D)
    c_new = torch.cat([p[3] for p in parts]).reshape(B, 2, D)

    act2 = active.repeat_interleave(2).view(-1, 1, 1)
    for name in state.conv:
        conv2 = torch.cat([p[1][name] for p in parts])
        state.conv[name] = torch.where(act2, conv2.to(dtype),
                                       state.conv[name])
    return e, h_new, c_new


def run_frames_fast(params: Params, state: FastState, frames: Tensor,
                    cfg: VapConfig, slots: str = "global",
                    attend_impl: str = "einsum", conv_impl: str = "conv"):
    """fast_step over (F, B, 2, frame_shift) frames; returns (state,
    {name: (F, B, ...)}) like the JAX package's lax.scan."""
    return scan_frames(functools.partial(
        fast_step, slots=slots, attend_impl=attend_impl,
        conv_impl=conv_impl), params, state, frames, cfg)


# ---------------------------------------------------------------------------
# Hybrid paths: the incremental KV step with a periodic full-trunk resync
# ---------------------------------------------------------------------------

RESYNC_MODES = ("auto", "never", "force")


@dataclass
class HybridState:
    """KVState plus the embedding ring a resync rebuilds the cache from.

    e_ctx: (B, 2, T, D) encoder embeddings in the state dtype.  Frame c of
    a stream sits at slot c % T (the cache's own slot rule), so a tick
    writes one row per active stream in place; the JAX package keeps the
    buffer right-aligned (newest at T-1) and rolls it every tick.
    `right_aligned` gives that order.  Encoder outputs do not depend on
    the path, so a full trunk over the ring reproduces the parity-exact
    (`stream_step`) values and flushes the drift of the cached K/V.
    """

    kv: KVState
    e_ctx: Tensor


@dataclass
class FastHybridState:
    """FastState plus the embedding ring (see `HybridState`): the resync
    trunk recomputes from the FAST encoder's own embeddings, so resync
    frames are exact against a full trunk over them."""

    kv: KVState
    conv: Dict[str, Tensor]
    e_ctx: Tensor


def init_hybrid_state(cfg: VapConfig, batch: int = 1, dtype=torch.float32,
                      staged: bool = False, device=None, *,
                      quant: Any = False) -> HybridState:
    """staged=True: the incremental ticks use the staged slot policy
    (else "stream"); quant: see `init_kv_state`."""
    return HybridState(
        kv=init_kv_state(cfg, batch, dtype, staged, device, quant=quant),
        e_ctx=torch.zeros((batch, 2, cfg.context_frames, cfg.dim),
                          dtype=dtype, device=device))


def init_fast_hybrid_state(cfg: VapConfig, batch: int = 1,
                           dtype=torch.float32, staged: bool = False,
                           device=None, *, quant: Any = False,
                           conv_impl: str = "conv") -> FastHybridState:
    fast = init_fast_state(cfg, batch, dtype, staged, device, quant=quant,
                           conv_impl=conv_impl)
    return FastHybridState(
        kv=fast.kv, conv=fast.conv,
        e_ctx=torch.zeros((batch, 2, cfg.context_frames, cfg.dim),
                          dtype=dtype, device=device))


def right_aligned(e_ctx: Tensor, count: Tensor) -> Tensor:
    """The ring (B, 2, T, D) in the JAX package's right-aligned order for
    streams that have seen `count` (B,) frames: position j holds frame
    count - T + j (slot (count - T + j) % T)."""
    B, _, T, D = e_ctx.shape
    j = torch.arange(T, device=e_ctx.device)
    idx = torch.remainder(count[:, None] - T + j, T)          # (B, T)
    return e_ctx.gather(2, idx[:, None, :, None].expand(B, 2, T, D))


def _trunk_rows(params: Params, e_ctx: Tensor, count: Tensor,
                cfg: VapConfig) -> Tuple[Dict[str, Tensor], Tensor]:
    """The masked full trunk over a RIGHT-ALIGNED embedding buffer (B, 2,
    T, D), capturing every sublayer's K/V (the values `kv_step` would have
    cached had no frame ever left the window).

    Returns (the newest frame's probabilities {name: (B, ...)}, rows (B,
    P, T, 4D) phase-major in cache_layout order, buffer order on the T
    axis).  `streaming.trunk_full` with a K/V capture (JAX
    incremental.py:922)."""
    B, _, T, _ = e_ctx.shape
    valid = torch.clamp(count, max=T)
    bias = _masked_bias(cfg, valid, e_ctx.dtype)
    kv: List[Tuple[Tensor, Tensor]] = []
    trunk = trunk_full(params, e_ctx[:, 0], e_ctx[:, 1], bias, cfg, kv)
    probs = probs_from_outputs(heads_forward(params, trunk, cfg), cfg)
    it = iter(kv)
    named: Dict[str, Tensor] = {}
    for li in range(cfg.channel_layers):
        k, v = next(it)                     # both channels, 2B rows
        for ch in (0, 1):
            named[f"ch{li}.{ch}.k"] = k[ch * B:(ch + 1) * B]
            named[f"ch{li}.{ch}.v"] = v[ch * B:(ch + 1) * B]
    for li in range(cfg.cross_layers):
        for tw in (0, 1):
            for kind in ("s", "c"):         # self, then cross
                (named[f"x{li}.{tw}.{kind}k"],
                 named[f"x{li}.{tw}.{kind}v"]) = next(it)
    layout = cache_layout(cfg)
    rows = torch.stack(
        [torch.cat([named[n] for n in layout[4 * ph:4 * ph + 4]], dim=-1)
         for ph in range(len(layout) // 4)], dim=1)
    return {k: v[:, -1] for k, v in probs.items()}, rows


def _resync(params: Params, kv: KVState, e_ctx: Tensor, h_new: Tensor,
            c_new: Tensor, cfg: VapConfig, active: Tensor
            ) -> Dict[str, Tensor]:
    """The resync tick, in place on `kv`: the full trunk over the ring,
    every cached row rewritten (requantised for an int8 cache) at its own
    stream's slot, the stamps rebuilt and the stage invalidated."""
    B = active.shape[0]
    T = cfg.context_frames
    dtype = kv.lstm_h.dtype
    count2 = kv.count + active.to(torch.int32)
    probs, rows = _trunk_rows(params, right_aligned(e_ctx, count2), count2,
                              cfg)
    # buffer position j holds frame c_j = count2 - T + j; it goes to the
    # stream's OWN slot c_j % T, so later ring writes evict in order
    s = torch.arange(T, device=count2.device)
    jj = torch.remainder(s[None, :] - count2[:, None], T)     # (B, T)
    c_at = count2[:, None] - T + jj
    D4 = rows.shape[-1]
    idx = jj[:, :, None].expand(B, T, D4)
    quant = kv.quant
    for ph in range(rows.shape[1]):
        r = rows[:, ph].gather(1, idx)                        # (B, T, 4D)
        if quant == "row":
            kv.cache[:, ph], kv.scale[:, ph] = quantize_rows(r)
        elif quant == "global":
            # unset scales of active streams calibrate from the WHOLE
            # rebuilt ring; set ones stay frozen and the codes clamp
            f = r.float().view(B, T, 4, D4 // 4)
            fresh = torch.clamp(f.abs().amax((1, 3)) * (QG_MARGIN / 127.0),
                                min=1e-8)                      # (B, 4)
            old = kv.scale[:, ph, 0]
            gs = torch.where((old == 0) & active[:, None], fresh, old)
            kv.scale[:, ph, 0] = gs
            sc = torch.where(gs == 0, 1.0, gs)
            kv.cache[:, ph] = torch.clamp(
                torch.round(f / sc[:, None, :, None]), -127, 127
            ).to(torch.int8).view(B, T, D4)
        else:
            kv.cache[:, ph] = r
    kv.stamp = torch.where(c_at >= 0, c_at, -1).to(torch.int32)
    # the LSTM state stays in its own dtype, never the int8 cache's
    a3 = active.view(B, 1, 1)
    kv.lstm_h = torch.where(a3, h_new.to(dtype), kv.lstm_h)
    kv.lstm_c = torch.where(a3, c_new.to(dtype), kv.lstm_c)
    kv.count = count2
    kv.step += 1
    if kv.stage_stamp is not None:
        # every row now sits in the ring: a staged row and its rewrite
        # share a stamp and would be attended twice
        kv.stage_stamp.fill_(-1)
    return probs


def _hybrid_core(params: Params, kv: KVState, e_ctx: Tensor, e: Tensor,
                 h_new: Tensor, c_new: Tensor, cfg: VapConfig,
                 active: Tensor, resync_every: int,
                 attend_impl: str = "einsum", resync_mode: str = "auto",
                 merge: str = "auto") -> Dict[str, Tensor]:
    """Post-encoder hybrid step, in place on `kv` and `e_ctx`: the ring
    write of the active streams' embeddings, then a resync tick or an
    incremental one (`_kv_core` with the state's slot policy, staged or
    stream).  Shared by `hybrid_step` and `fast_hybrid_step`: the resync
    recomputes from the ring, whichever encoder filled it.

    resync_mode: "auto" resyncs when (step + 1) % resync_every == 0
    (never for resync_every <= 0), decided on the host from `kv.step`;
    "never" / "force" let the caller decide.  A resync tick takes
    precedence over a staged merge (it invalidates the stage).  merge:
    the incremental tick's staged merge (see `_kv_core`)."""
    if resync_mode not in RESYNC_MODES:
        raise ValueError(f"resync_mode {resync_mode!r} not in "
                         f"{RESYNC_MODES}")
    T = cfg.context_frames
    _scatter_rows(e_ctx, e, torch.remainder(kv.count, T), active)
    if resync_mode == "force" or (
            resync_mode == "auto" and resync_every > 0
            and (kv.step + 1) % resync_every == 0):
        return _resync(params, kv, e_ctx, h_new, c_new, cfg, active)
    return _kv_core(params, kv, e, h_new, c_new, cfg, active,
                    "staged" if kv.stage is not None else "stream",
                    attend_impl, merge)


def hybrid_step(params: Params, state: HybridState, chunk: Tensor,
                cfg: VapConfig, active: Optional[Tensor] = None,
                resync_every: int = 0, attend_impl: str = "einsum",
                resync_mode: str = "auto", merge: str = "auto"
                ) -> Tuple[HybridState, Dict[str, Tensor]]:
    """`kv_step` with a full-trunk resync every `resync_every`-th tick
    (global cadence; 0 = never): chunk (B, 2, frame_samples).  A resync
    frame's outputs equal `stream_step`'s and the whole cache is rewritten
    drift-free, so between resyncs the deviation is bounded by at most
    `resync_every` frames of drift.  Updates `state` in place and returns
    it with the outputs."""
    active = _all_active(chunk, active)
    e, h_new, c_new = _chunked_encode(params, state.kv, chunk, cfg)
    outs = _hybrid_core(params, state.kv, state.e_ctx, e, h_new, c_new, cfg,
                        active, resync_every, attend_impl, resync_mode,
                        merge)
    return state, outs


def fast_hybrid_step(params: Params, state: FastHybridState, new: Tensor,
                     cfg: VapConfig, active: Optional[Tensor] = None,
                     resync_every: int = 0, attend_impl: str = "einsum",
                     conv_impl: str = "conv", conv_chunks: int = 1,
                     resync_mode: str = "auto", merge: str = "auto"
                     ) -> Tuple[FastHybridState, Dict[str, Tensor]]:
    """`fast_step` with a full-trunk resync every `resync_every`-th tick:
    new (B, 2, frame_shift) FRESH samples.  A resync frame is exact
    against the full trunk over the fast encoder's embeddings
    (`resync_every=1` is that oracle).  conv_impl / conv_chunks: see
    `fast_step`.  Updates `state` in place and returns it."""
    active = _all_active(new, active)
    e, h_new, c_new = _fast_encode(params, state, new, cfg, active,
                                   conv_impl, conv_chunks)
    outs = _hybrid_core(params, state.kv, state.e_ctx, e, h_new, c_new, cfg,
                        active, resync_every, attend_impl, resync_mode,
                        merge)
    return state, outs


def run_frames_hybrid(params: Params, state: HybridState, frames: Tensor,
                      cfg: VapConfig, resync_every: int,
                      attend_impl: str = "einsum"):
    """hybrid_step over (F, B, 2, frame_samples) frames; returns (state,
    {name: (F, B, ...)})."""
    return scan_frames(functools.partial(
        hybrid_step, resync_every=resync_every, attend_impl=attend_impl),
        params, state, frames, cfg)


def run_frames_fast_hybrid(params: Params, state: FastHybridState,
                           frames: Tensor, cfg: VapConfig,
                           resync_every: int, attend_impl: str = "einsum",
                           conv_impl: str = "conv",
                           host_cadence: bool = False):
    """fast_hybrid_step over (F, B, 2, frame_shift) frames; returns
    (state, {name: (F, B, ...)}).

    host_cadence=True runs the resync-aligned blocked form, as the JAX
    package compiles it: per block of `resync_every` frames, that many
    minus one incremental ticks (resync_mode="never"), then one resync
    tick ("force").  It needs a state at a block boundary (step %
    resync_every == 0) and whole blocks; it gives the same outputs as the
    per-tick cadence."""
    step = functools.partial(fast_hybrid_step, resync_every=resync_every,
                             attend_impl=attend_impl, conv_impl=conv_impl)
    if not host_cadence:
        return scan_frames(step, params, state, frames, cfg)
    R = resync_every
    if R <= 0 or frames.shape[0] % R or state.kv.step % R:
        raise ValueError(f"host_cadence needs whole blocks of resync_every="
                         f"{R} frames from a block boundary (got "
                         f"{frames.shape[0]} frames at step "
                         f"{state.kv.step})")

    def blocked(p, st, frame, c):
        mode = "force" if (st.kv.step + 1) % R == 0 else "never"
        return step(p, st, frame, c, resync_mode=mode)

    return scan_frames(blocked, params, state, frames, cfg)
