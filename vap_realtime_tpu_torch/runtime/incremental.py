"""Incremental streaming steps — per-frame KV-cache append, single-query
attention, no full-context recompute: `kv_step` (the chunked encoder over
overlapped frames) and `fast_step` (the streaming encoder over fresh
samples, the fast serving path); and their hybrid twins `hybrid_step` /
`fast_hybrid_step`, which every `resync_every` ticks recompute the trunk
over an embedding ring and rewrite the cache drift-free.

Port of `vap_realtime_tpu/runtime/incremental.py` (the same cache layout,
stamps, slot policies, staged merge and int8 cache modes, so that states
compare one to one).  ALL per-frame K/V vectors (28 for 1 channel layer +
3 stereo layers) live in ONE phase-major cache (B, P=7, T, 4*D): each
layer phase's twin k/v pairs form one per-stream-contiguous (T, 4D)
plane, read by one `attend_pair` launch.  Each attention reads the T
cached rows (ages >= 1) plus the current position's fresh k/v (age 0);
the frame's cache write is deferred to the end of the step.  Ages are
`count - stamp` in each stream's own frame timeline, so a frozen
stream's rows do not age; dead rows carry age DEAD.  The cache's format
(state dtype or int8) lives in `cache_format`, the slot policies in
`SLOT_WRITERS`, the attends in `ATTENDS`.

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
from typing import Any, Callable, Dict, List, Optional, Tuple

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
from vap_realtime_tpu_torch.ops.cuda.merge import scatter_rows, stage_merge
from vap_realtime_tpu_torch.runtime import cache_format
from vap_realtime_tpu_torch.runtime.cache_format import Plane, load_rows
from vap_realtime_tpu_torch.runtime.streaming import (
    _masked_bias, scan_frames, trunk_full,
)
from vap_realtime_tpu_torch.utils.spans import span, traced

Params = Dict[str, Any]
Tensor = torch.Tensor
Reads = Tuple[Tensor, Optional[Tensor], Optional[Tensor]]

STAGE_S = 8  # staged-slot policy: frames buffered between ring merges

# the compact-softmax attends: ring rows only, no staged form
COMPACT_IMPLS = ("kernel3", "plain3")


def cache_layout(cfg: VapConfig) -> List[str]:
    """Fixed slot order of the fused cache's last dim (28 x D for the
    default 1 channel layer + 3 cross layers).  Every k/v pair is
    adjacent and the TWIN pairs of each attend phase form one 4-slot
    phase: slot s maps to cache[:, s // 4, :, (s % 4) * D:]."""
    return ([f"ch{li}.{ch}.{n}" for li in range(cfg.channel_layers)
             for ch in (0, 1) for n in "kv"]
            + [f"x{li}.{tw}.{ph}{n}" for li in range(cfg.cross_layers)
               for ph in "sc" for tw in (0, 1) for n in "kv"])


@dataclass
class KVState:
    """Fused-KV streaming state (see the module docstring): cache (B, P,
    T, 4*D) phase-major K/V rows (int8 codes when quantised); lstm_h /
    lstm_c (B, 2, D) encoder context-net state; count (B,) int32 frames
    seen per stream; stamp (B, T) int32 `count` at which each ring row was
    written, -1 = invalid; step, a host int, the tick index.  "staged"
    policy only (else None): stage (S, B, P*4D) frame-major staged rows
    (stage[i] holds tick g = i mod S), stage_stamp (S, B) the stream's
    `count` at staging, -1 = invalid (frozen tick, or merged).  quant: the
    cache's format (False, "row" or "global"), whose scales scale /
    stage_scale are (`cache_format`), else None."""

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
    quant: Any = False


def init_kv_state(cfg: VapConfig, batch: int = 1, dtype=torch.float32,
                  staged: bool = False, device=None, *,
                  quant: Any = False) -> KVState:
    """staged=True adds the (S, B, P*4D) stage that slots="staged" needs.

    quant: False (a `dtype` cache) | True / "row" (int8 cache, per-row
    scales) | "global" (int8 cache, per-stream frozen scales)."""
    D, T, S = cfg.dim, cfg.context_frames, STAGE_S
    P = len(cache_layout(cfg)) // 4
    if staged and S > T:
        # the merge targets stamp % T and relies on the S staged stamps
        # being distinct mod T
        raise ValueError(
            f"staged slots need context_frames >= {S} (got {T}); use "
            f"slots='stream' for tiny-context configs")
    i32 = dict(dtype=torch.int32, device=device)
    return KVState(
        **cache_format.alloc(quant, batch, P, T, D, S, staged, dtype, device),
        lstm_h=torch.zeros((batch, 2, D), dtype=dtype, device=device),
        lstm_c=torch.zeros((batch, 2, D), dtype=dtype, device=device),
        count=torch.zeros((batch,), **i32),
        stamp=torch.full((batch, T), -1, **i32), step=0,
        stage_stamp=torch.full((S, batch), -1, **i32) if staged else None)


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


@traced("vap.encode")
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


# --- the slot policies: where a frame's row lands (planes: cache_format) ---

def _write_staged(kv: KVState, planes: List[Plane], active: Tensor,
                  merge: str) -> None:
    """The row staged at tick g % S; a merge (merge="auto": when (g + 1) %
    STAGE_S == 0; "never" / "force": the caller's choice) puts each staged
    row at its stream's own ring position stamp % T, as "stream" would."""
    g = kv.step
    S, B = kv.stage_stamp.shape
    for val, _, stage in planes:
        stage[g % S] = val.reshape(B, -1)
    kv.stage_stamp[g % S] = torch.where(active, kv.count, -1)
    if (g + 1) % STAGE_S == 0 if merge == "auto" else merge == "force":
        # the K/V rows, then the row scales where the format keeps them
        _, rings, stages = zip(*planes)
        with span("vap.merge", n=S * B):      # n: the staged rows examined
            stage_merge(rings[0], kv.stamp, stages[0], kv.stage_stamp,
                        *rings[1:], *stages[1:])


def _write_stream(kv: KVState, planes: List[Plane], active: Tensor,
                  merge: str) -> None:
    """Each active stream's row at its own ring position count % T; a
    frozen tick touches nothing."""
    B, T = kv.stamp.shape
    idx = torch.remainder(kv.count, T)
    # stamps and row scales ride the row writer as (B, 1|P, T, 1) views
    scatter_rows(kv.stamp.view(B, 1, T, 1), kv.count.view(B, 1, 1), idx,
                 active)
    for val, ring, _ in planes:
        r = ring.view(B, ring.shape[1], T, -1)
        scatter_rows(r, val.view_as(r[:, :, 0]), idx, active)


def _write_global(kv: KVState, planes: List[Plane], active: Tensor,
                  merge: str) -> None:
    """One slot g % T for all streams; frozen streams keep their row."""
    B, T = kv.stamp.shape
    t = kv.step % T
    kv.stamp[:, t] = torch.where(active, kv.count, kv.stamp[:, t])
    for val, ring, _ in planes:
        r = ring.view(B, ring.shape[1], T, -1)
        r[:, :, t] = torch.where(active.view(B, 1, 1), val.view_as(r[:, :, t]),
                                 r[:, :, t])


SLOT_WRITERS = {"stream": _write_stream, "global": _write_global,
                "staged": _write_staged}
SLOTS = tuple(SLOT_WRITERS)


def _slot_policy(kv: KVState, slots: Optional[str], attend_impl: str
                 ) -> Tuple[Callable, Optional[Tensor]]:
    """(the writer of `slots`, the stage the attends read or None), once
    the (slots, attend_impl, state) combination is checked.  slots=None:
    the state's own policy, staged when it has a stage, else stream."""
    if attend_impl not in ATTENDS:
        raise ValueError(f"attend_impl {attend_impl!r} not in "
                         f"{ATTEND_IMPLS}")
    if slots is None:
        slots = "stream" if kv.stage is None else "staged"
    if slots == "staged":
        if kv.stage is None:
            raise ValueError('slots="staged" needs a state built with '
                             'staged=True')
        if attend_impl in COMPACT_IMPLS:
            raise ValueError(f"staged slots: use attend_impl='kernel' (the "
                             f"compact body of {attend_impl!r} has no "
                             f"staged form)")
    if slots not in SLOT_WRITERS:
        raise ValueError(f"unknown slots policy {slots!r}")
    return SLOT_WRITERS[slots], kv.stage if slots == "staged" else None


# --- the attends: (state, q2, k2, v2 (B, 2, D), pair_base, reads, H) -> (B,
# 2, D); set s reads pair pair_base + s: phase pair_base // 2, [2sD, 2sD+2D)

def _reads(kv: KVState, cfg: VapConfig, stage: Optional[Tensor]) -> Reads:
    """(ring ages (B, T) float32; the stage or None; its ages (S, B)),
    relative to the current frame (age 0, written at the END of the step)
    in each stream's own timeline.  A row is live iff its stamp is valid
    AND within the last T-1 own frames; dead rows get age DEAD (weight 0)."""
    T = cfg.context_frames
    age = kv.count[:, None] - kv.stamp                        # (B, T)
    max_age = kv.count.clamp(max=T - 1)
    live = (kv.stamp >= 0) & (age <= max_age[:, None])
    if cfg.context_limit > 0:
        live = live & (age < cfg.context_limit)
    age = torch.where(live, age.float(), DEAD)
    if stage is None:
        return age, None, None
    # staged rows: also younger than `count` — a slot reset can leave
    # stale stage stamps >= the new count (incremental.py:404-414)
    age_st = kv.count[None, :] - kv.stage_stamp               # (S, B)
    live_st = ((kv.stage_stamp >= 0) & (age_st >= 1)
               & (age_st <= max_age[None, :]))
    if cfg.context_limit > 0:
        live_st = live_st & (age_st < cfg.context_limit)
    # (S, B) float32 ages; the TPU kernel took them in the state dtype
    return age, stage, torch.where(live_st, age_st.float(), DEAD)


@functools.lru_cache(maxsize=None)
def _alibi(H: int, device: torch.device) -> Tensor:
    """(H,) float32 AliBi slopes, built once per device."""
    return torch.tensor(alibi_slopes(H), dtype=torch.float32, device=device)


@traced("vap.attend")
def _decoded(body, kv, q2, k2, v2, pair_base, reads, H):
    """`body(q, k_cur, v_cur (B, D), k_old, v_old (B, L, D), age (B, L),
    H, dtype)` per twin set over the rows read, decoded by the format."""
    D = q2.shape[-1]
    age, stage, stage_age = reads
    if stage is not None:                       # ring rows, then staged
        age = torch.cat([age, stage_age.T], dim=1)
    outs = []
    for s in (0, 1):
        k_old, v_old = (load_rows(kv, pair_base // 2, (2 * s + i) * D, D,
                                  stage is not None) for i in (0, 1))
        outs.append(body(q2[:, s], k2[:, s], v2[:, s], k_old, v_old, age, H,
                         kv.lstm_h.dtype))
    return torch.stack(outs, dim=1)


def _einsum(q, k_cur, v_cur, k_old, v_old, age, H, dtype):
    """Softmax attention in einsum form (the JAX package's `attend`,
    incremental.py:486-576): bf16 operands, float32 products and sums
    (JAX: preferred f32)."""
    (B, D), L = q.shape, k_old.shape[1]
    Dh = D // H
    scale = 1.0 / math.sqrt(D)
    live = age != DEAD
    bias = torch.where(
        live[:, None, :],
        -torch.where(live, age, 0.0)[:, None, :]
        * _alibi(H, q.device)[None, :, None], float("-inf"))  # (B, H, L)
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


def _grouped(q, k_cur, v_cur, k_old, v_old, age, H, dtype):
    """The JAX package's head-free "grouped" attend (incremental.py:
    521-554) with its rounding points: k * q in the state dtype, head sums
    in float32 times 1/sqrt(D), minus age * slope; a softmax shifted by
    max(max_t s, s_cur); the weights rounded to the state dtype and
    multiplied with v in it, summed in float32; the current weight in
    float32."""
    (B, D), L = q.shape, k_old.shape[1]
    Dh = D // H
    scale = 1.0 / math.sqrt(D)
    qd = q.to(dtype)
    s = (k_old * qd[:, None]).float().view(B, L, H, Dh).sum(-1) * scale
    s = s - age[:, :, None] * _alibi(H, q.device)
    s_cur = (k_cur.to(dtype) * qd).float().view(B, H, Dh).sum(-1) * scale
    mx = torch.maximum(s.amax(1), s_cur)                      # (B, H)
    w = torch.exp(s - mx[:, None])
    w_cur = torch.exp(s_cur - mx)
    denom = w.sum(1) + w_cur
    out = (w.to(dtype)[..., None] * v_old.view(B, L, H, Dh)).float().sum(1)
    out = out + w_cur[..., None] * v_cur.float().view(B, H, Dh)
    return (out / denom[..., None]).reshape(B, D).to(dtype)


@traced("vap.attend")
def _kernel(fn, impl, kv, q2, k2, v2, pair_base, reads, H):
    """`fn` (`attend_pair`: the CUDA kernel on a CUDA tensor, its plain
    version on the CPU; or `attend_pair_plain`); impl="compact": K10."""
    return cache_format.attend(fn, kv, q2, k2, v2, *reads,
                               pair_base=pair_base, num_heads=H, impl=impl)


ATTENDS = {
    "kernel": functools.partial(_kernel, attend_pair, "bcast"),
    "kernel3": functools.partial(_kernel, attend_pair, "compact"),
    "plain": functools.partial(_kernel, attend_pair_plain, "bcast"),
    "plain3": functools.partial(_kernel, attend_pair_plain, "compact"),
    "grouped": functools.partial(_decoded, _grouped),
    "einsum": functools.partial(_decoded, _einsum),
}
ATTEND_IMPLS = tuple(ATTENDS)


def _ffn(x: Tensor, layer: Params) -> Tensor:
    h = layer_norm(x, layer["ln_ffn"]["w"], layer["ln_ffn"]["b"])
    return x + linear(gelu(linear(h, layer["ffn"]["w1"])), layer["ffn"]["w2"])


@traced("vap.trunk")
def _kv_core(params: Params, state: KVState, e: Tensor, h_new: Tensor,
             c_new: Tensor, cfg: VapConfig, active: Tensor,
             slots: Optional[str], attend_impl: str = "einsum",
             merge: str = "auto") -> Dict[str, Tensor]:
    """Post-encoder incremental step, in place on `state`: e (B, 2, D)
    fresh embeddings -> single-query attentions over the fused cache +
    one slot write.  Returns the probability outputs (B, ...).  slots: a
    key of SLOT_WRITERS, or None for the state's own policy; attend_impl:
    a key of ATTENDS; merge: see `_write_staged`."""
    write, stage = _slot_policy(state, slots, attend_impl)
    attend = ATTENDS[attend_impl]
    reads = _reads(state, cfg, stage)
    H = cfg.num_heads
    twins = []      # each phase's (k, v), (B, 2, D) each, in cache order

    # both channels / towers ride a size-2 axis at dim 1 (shared weights)
    x = e
    for li, layer in enumerate(params["ar_channel"]["layers"]):
        p = layer["attn"]
        z = layer_norm(x, layer["ln_self"]["w"], layer["ln_self"]["b"])
        q, k, v = (linear(z, p[n]) for n in "qkv")
        twins.append((k, v))
        a = attend(state, q, k, v, 2 * li, reads, H)
        x = _ffn(x + linear(a, p["proj"]), layer)
    o1, o2 = x[:, 0], x[:, 1]

    for li, layer in enumerate(params["ar"]["layers"]):
        base = 2 * cfg.channel_layers + 4 * li
        p, pc = layer["attn"], layer["attn_cross"]
        z = layer_norm(x, layer["ln_self"]["w"], layer["ln_self"]["b"])
        q, k, v = (linear(z, p[n]) for n in "qkv")
        twins.append((k, v))
        x_mid = x + linear(attend(state, q, k, v, base, reads, H), p["proj"])
        # cross phase: query from LN(x_mid); K/V from the RAW pre-update
        # OTHER tower (modules.py:276-283: src is not normalized).  JAX
        # swaps the twin axis with [:, ::-1]; torch has no negative-stride
        # slice, so flip(1) (a copy).
        zc = layer_norm(x_mid, layer["ln_src"]["w"], layer["ln_src"]["b"])
        qc = linear(zc, pc["q"])
        kc, vc = (linear(x, pc[n]).flip(1) for n in "kv")
        twins.append((kc, vc))
        c = attend(state, qc, kc, vc, base + 2, reads, H)
        x = _ffn(x_mid + linear(c, pc["proj"]), layer)
    x1, x2 = x[:, 0], x[:, 1]
    xc = combinator(params["ar"]["combinator"], x1, x2)

    # the frame's single cache write: rows (B, P, 4D) phase-major
    rows = torch.stack([torch.cat([k[:, 0], v[:, 0], k[:, 1], v[:, 1]], -1)
                        for k, v in twins], dim=1)
    write(state, cache_format.encode(state, rows, active), active, merge)

    trunk = {"x": xc[:, None], "o1": o1[:, None], "o2": o2[:, None],
             "x1": x1[:, None], "x2": x2[:, None]}
    probs = probs_from_outputs(heads_forward(params, trunk, cfg), cfg)
    _advance(state, h_new, c_new, active, state.count + active.to(torch.int32))
    return {k: v[:, -1] for k, v in probs.items()}


def _advance(kv: KVState, h_new: Tensor, c_new: Tensor, active: Tensor,
             count: Tensor) -> None:
    """The tick's end: the active streams' LSTM state (in the state dtype,
    never the int8 cache's), the frame counts, the tick counter."""
    a3 = active.view(-1, 1, 1)
    kv.lstm_h = torch.where(a3, h_new.to(kv.lstm_h.dtype), kv.lstm_h)
    kv.lstm_c = torch.where(a3, c_new.to(kv.lstm_h.dtype), kv.lstm_c)
    kv.count = count
    kv.step += 1


# --- the fast path: seamless streaming conv + incremental KV ---------------

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
              merge: str = "auto", fence=None
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
    fence: None (new is already on the stream) or the events of the
    copies that bring it in pieces (see `encode_chunk_streaming`).
    """
    active = _all_active(new, active)
    e, h_new, c_new = _fast_encode(params, state, new, cfg, active,
                                   conv_impl, conv_chunks, fence)
    outs = _kv_core(params, state.kv, e, h_new, c_new, cfg, active, slots,
                    attend_impl, merge)
    return state, outs


def _all_active(x: Tensor, active: Optional[Tensor]) -> Tensor:
    """`active`, or every stream of the (B, ...) frame batch x."""
    if active is not None:
        return active
    return torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)


@traced("vap.encode")
def _fast_encode(params: Params, state, new: Tensor, cfg: VapConfig,
                 active: Tensor, conv_impl: str, conv_chunks: int,
                 fence=None):
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
        conv_impl, fence)
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


# --- the hybrid paths: the incremental step with a periodic trunk resync ---

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
    cached had no frame ever left the window): (the newest frame's
    probabilities {name: (B, ...)}, rows (B, P, T, 4D) phase-major, buffer
    order on the T axis).  `streaming.trunk_full` with a K/V capture (JAX
    incremental.py:922)."""
    B = e_ctx.shape[0]
    bias = _masked_bias(cfg, torch.clamp(count, max=e_ctx.shape[2]),
                        e_ctx.dtype)
    kv: List[Tuple[Tensor, Tensor]] = []
    trunk = trunk_full(params, e_ctx[:, 0], e_ctx[:, 1], bias, cfg, kv)
    probs = probs_from_outputs(heads_forward(params, trunk, cfg), cfg)
    n = cfg.channel_layers
    # a channel layer's pair holds both channels (2B rows); a stereo
    # layer's four: tower 1's self and cross, then tower 2's
    rows = [torch.cat([k[:B], v[:B], k[B:], v[B:]], -1) for k, v in kv[:n]]
    for i in range(n, len(kv), 4):
        s1, c1, s2, c2 = kv[i:i + 4]
        rows += [torch.cat([*s1, *s2], -1), torch.cat([*c1, *c2], -1)]
    return {k: v[:, -1] for k, v in probs.items()}, torch.stack(rows, 1)


@traced("vap.resync")
def _resync(params: Params, kv: KVState, e_ctx: Tensor, h_new: Tensor,
            c_new: Tensor, cfg: VapConfig, active: Tensor
            ) -> Dict[str, Tensor]:
    """The resync tick, in place on `kv`: the full trunk over the ring,
    every cached row rewritten (re-encoded in the cache's format) at its
    own stream's slot, the stamps rebuilt and the stage invalidated."""
    B = active.shape[0]
    T = cfg.context_frames
    count2 = kv.count + active.to(torch.int32)
    probs, rows = _trunk_rows(params, right_aligned(e_ctx, count2), count2,
                              cfg)
    # buffer position j holds frame c_j = count2 - T + j; it goes to the
    # stream's OWN slot c_j % T, so later ring writes evict in order
    s = torch.arange(T, device=count2.device)
    jj = torch.remainder(s[None, :] - count2[:, None], T)     # (B, T)
    c_at = count2[:, None] - T + jj
    idx = jj[:, :, None].expand(B, T, rows.shape[-1])
    for ph in range(rows.shape[1]):
        cache_format.encode_ring(kv, ph, rows[:, ph].gather(1, idx), active)
    kv.stamp = torch.where(c_at >= 0, c_at, -1).to(torch.int32)
    _advance(kv, h_new, c_new, active, count2)
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
    incremental one (`_kv_core` with the state's own slot policy); shared
    by `hybrid_step` and `fast_hybrid_step`.  resync_mode: "auto" resyncs
    when (step + 1) % resync_every == 0 (never for resync_every <= 0),
    decided on the host; "never" / "force" let the caller decide.  A
    resync tick takes precedence over a staged merge (it invalidates the
    stage); merge: the incremental tick's (see `_write_staged`)."""
    if resync_mode not in RESYNC_MODES:
        raise ValueError(f"resync_mode {resync_mode!r} not in "
                         f"{RESYNC_MODES}")
    T = cfg.context_frames
    scatter_rows(e_ctx, e, torch.remainder(kv.count, T), active)
    if resync_mode == "force" or (
            resync_mode == "auto" and resync_every > 0
            and (kv.step + 1) % resync_every == 0):
        return _resync(params, kv, e_ctx, h_new, c_new, cfg, active)
    return _kv_core(params, kv, e, h_new, c_new, cfg, active, None,
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
                     resync_mode: str = "auto", merge: str = "auto",
                     fence=None
                     ) -> Tuple[FastHybridState, Dict[str, Tensor]]:
    """`fast_step` with a full-trunk resync every `resync_every`-th tick:
    new (B, 2, frame_shift) FRESH samples.  A resync frame is exact
    against the full trunk over the fast encoder's embeddings
    (`resync_every=1` is that oracle).  conv_impl / conv_chunks / fence:
    see `fast_step`.  Updates `state` in place and returns it."""
    active = _all_active(new, active)
    e, h_new, c_new = _fast_encode(params, state, new, cfg, active,
                                   conv_impl, conv_chunks, fence)
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
