"""StreamArena — slot-based multi-stream serving state on the device.

A fixed-capacity arena of stream slots: admission resets a free slot's
recurrent state (its stale cache rows are masked by their stamps, so no
cache clearing is needed); eviction returns the slot to the free list.
Every tick steps the FULL batch once; empty slots are frozen (their
state is untouched and their outputs ignored).

Port of `vap_realtime_tpu/runtime/arena.py` for every path of the JAX
package: "kv" (the default: the chunked encoder over overlapped frames +
the KV step), "fast" (the streaming encoder over fresh samples + the KV
step), "full" (the parity-exact full recompute), and "hybrid" /
"fast_hybrid" (kv / fast with a full-trunk resync every `resync_every`
ticks).  The host decides the staged merge and the resync from the
state's tick counter; a resync tick takes precedence over a merge tick.
The arena runs on the card unless the caller asks for the CPU; without
CUDA it raises instead of falling back.

The upload.  On the card a tick's host arrays (the frame and the active
mask) cross PCIe on a copy stream of the arena's own, into one of two
sets of device buffers (tick k's group of uploads takes set k % 2; a
reset's mask takes the next set too).  Before the copy stream writes a
set it waits on the event the compute stream recorded after the set's
last reader; nothing waits on the host.  The frame crosses in the pieces
the encoder reads it in (`upload_piece`): where the fused conv stack
takes it in several body calls, one 2-D copy a piece (`upload_rows`),
each converted to the compute dtype on the copy stream and fenced by an
event that the compute stream waits on right before the body call that
reads the piece, so body call j overlaps the copy of piece j + 1; in
every other case one piece, waited on before the encoder.  In a closed
loop the next tick's copy runs behind the current tick's kernels.
`StreamArena.upload_pieces` counts the pieces copied on a copy stream.

A difference of form from the JAX arena: its kv and hybrid paths call
their steps without `attend_impl` (so always the einsum attend); this
arena passes `attend_impl` through, so those paths run the attend kernel
on the card.  The outputs agree at 1e-4 either way.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.ops.cuda.encoder import (
    body_fits, piece_samples, wait_all,
)
from vap_realtime_tpu_torch.ops.cuda.upload import upload_rows
from vap_realtime_tpu_torch.runtime import cache_format, incremental, streaming
from vap_realtime_tpu_torch.utils.spans import span
from vap_realtime_tpu_torch.weights.convert import params_to_torch

PATHS = ("kv", "fast", "full", "hybrid", "fast_hybrid")
# the paths that take FRESH samples (frame_shift, no 320-sample overlap);
# the others take whole overlapped frames (frame_samples)
FRESH_PATHS = ("fast", "fast_hybrid")
HYBRID_PATHS = ("hybrid", "fast_hybrid")


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when None; raises when CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def on_device(device: torch.device):
    """A context that makes `device` the calling thread's current CUDA
    device (the kernels launch on the current device, and a thread other
    than the one that built the state starts on device 0); a no-op
    context on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def check_path(path: str) -> None:
    """Raises for a path the port does not serve."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r} (use one of {PATHS})")


def init_path_state(path: str, cfg: VapConfig, batch: int, dtype, device,
                    *, staged: bool, quant=False, conv_impl: str = "conv"):
    """A fresh state of one path's step: StreamState ("full"), KVState
    ("kv"), FastState ("fast"), HybridState ("hybrid") or FastHybridState
    ("fast_hybrid"); staged / quant apply to every path but "full",
    conv_impl to the fresh-sample paths."""
    if path == "full":
        return streaming.init_stream_state(cfg, batch, dtype, device)
    init = {"kv": incremental.init_kv_state,
            "hybrid": incremental.init_hybrid_state,
            "fast": incremental.init_fast_state,
            "fast_hybrid": incremental.init_fast_hybrid_state}[path]
    kw = dict(conv_impl=conv_impl) if path in FRESH_PATHS else {}
    return init(cfg, batch, dtype, staged, device, quant=quant, **kw)


def upload_piece(path: str, conv_impl: str, L: int, dtype, device,
                 fits=None) -> int:
    """The samples of one fenced upload piece of an L-sample frame: the
    body call's piece (`piece_samples`, by the body's own rule `fits`,
    default `body_fits(dtype)`) where the fused conv stack reads the
    frame on the card (a fresh-sample path), else L: one piece."""
    if (path not in FRESH_PATHS or conv_impl != "fused"
            or torch.device(device).type != "cuda"):
        return L
    return piece_samples(L, body_fits(dtype) if fits is None else fits)


def normalise(x: torch.Tensor, dtype, out=None) -> torch.Tensor:
    """Wire samples -> the compute dtype, in one pass (into `out` when
    given): int16 times 2^-15, rounded once (the power-of-two scale
    commutes with the rounding, so the values equal a cast followed by
    the scale); any other wire dtype cast."""
    if out is None:
        if x.dtype == dtype:
            return x
        out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.dtype == torch.int16:
        return torch.mul(x, 1.0 / 32768.0, out=out)
    return out.copy_(x)


class _Uploads:
    """One set of an arena's upload buffers on the card: the frame as it
    crosses (`raw`, keyed by the wire dtype) and converted (`x`), the
    active or reset mask, the events of each piece's and the mask's
    arrival, and `free`, recorded on the compute stream after the set's
    last reader."""

    def __init__(self, capacity: int, L: int, dtype, device, pieces: int):
        self.shape = (capacity, 2, L)
        self.dtype, self.device = dtype, device
        self.raw: Dict[torch.dtype, torch.Tensor] = {}
        self.x = torch.empty(self.shape, dtype=dtype, device=device)
        self.mask = torch.empty((capacity,), dtype=torch.bool, device=device)
        # a one-element target that ties a pinned staging block to the
        # copy stream (`StreamArena._upload_tick`)
        self.tie = torch.empty((1,), dtype=torch.uint8, device=device)
        self.ready = [torch.cuda.Event() for _ in range(pieces)]
        self.mask_ready = torch.cuda.Event()
        self.free = torch.cuda.Event()

    def wire(self, dtype: torch.dtype) -> torch.Tensor:
        """The buffer a frame of wire dtype `dtype` crosses into (the
        converted buffer itself when no conversion is needed)."""
        if dtype == self.dtype:
            return self.x
        if dtype not in self.raw:
            self.raw[dtype] = torch.empty(self.shape, dtype=dtype,
                                          device=self.device)
        return self.raw[dtype]


def path_step(path: str, params, state, chunk: torch.Tensor,
              cfg: VapConfig, active: Optional[torch.Tensor] = None, *,
              slots: str, attend_impl: str, conv_impl: str = "conv",
              conv_chunks: int = 1, merge: str = "auto",
              resync_every: int = 0, resync_mode: str = "auto",
              fence=None):
    """One step of a path: `stream_step` ("full"), `kv_step` ("kv"),
    `fast_step` ("fast"), `hybrid_step` ("hybrid") or `fast_hybrid_step`
    ("fast_hybrid") with the options that path takes (the hybrid paths
    take their slot policy from the state).  fence: None (chunk is on the
    stream) or the events of its upload's pieces: the fresh-sample paths
    hand them to their encoder, the others wait on them first.  Returns
    (state, outputs)."""
    if path not in FRESH_PATHS:
        wait_all(fence)
    if path == "full":
        return streaming.stream_step(params, state, chunk, cfg, active)
    if path == "kv":
        return incremental.kv_step(params, state, chunk, cfg, active,
                                   slots=slots, attend_impl=attend_impl,
                                   merge=merge)
    if path == "fast":
        return incremental.fast_step(params, state, chunk, cfg, active,
                                     slots=slots, attend_impl=attend_impl,
                                     conv_impl=conv_impl,
                                     conv_chunks=conv_chunks, merge=merge,
                                     fence=fence)
    kw = dict(resync_every=resync_every, attend_impl=attend_impl,
              resync_mode=resync_mode, merge=merge)
    if path == "hybrid":
        return incremental.hybrid_step(params, state, chunk, cfg, active,
                                       **kw)
    return incremental.fast_hybrid_step(params, state, chunk, cfg, active,
                                        conv_impl=conv_impl,
                                        conv_chunks=conv_chunks, fence=fence,
                                        **kw)


def tick_index(state) -> Optional[int]:
    """The state's tick counter (`KVState.step`, a host int), or None
    for the full path's state, which keeps none."""
    return getattr(getattr(state, "kv", state), "step", None)


def _reset_slot(state, mask: torch.Tensor) -> None:
    """In place: zero the recurrent state and validity counters of every
    slot where `mask` ((B,) bool) is set, in one fixed-shape pass, for the
    state of any path.  Cache, stage and embedding-buffer rows stay:
    their stamps or the count invalidate them.  Per-row scales stay too
    (read only for live rows); the frozen scales of quant="global" are
    zeroed, so the next stream calibrates anew.

    A reset stream's embedding ring is first rotated into the JAX
    package's right-aligned order (slot j = position j), so later writes
    at slot count % T evict the rows the JAX roll evicts: a resync
    calibrates unset global scales over the whole ring, stale rows
    included."""
    conv = getattr(state, "conv", None)
    if conv is not None:
        m2 = mask.repeat_interleave(2).view(-1, 1, 1)  # conv tails per channel
        for v in conv.values():
            v.masked_fill_(m2, 0)
    if isinstance(state, (incremental.HybridState,
                          incremental.FastHybridState)):
        aligned = incremental.right_aligned(state.e_ctx, state.kv.count)
        state.e_ctx.copy_(torch.where(mask.view(-1, 1, 1, 1), aligned,
                                      state.e_ctx))
    state = getattr(state, "kv", state)
    state.lstm_h.masked_fill_(mask.view(-1, 1, 1), 0)
    state.lstm_c.masked_fill_(mask.view(-1, 1, 1), 0)
    state.count.masked_fill_(mask, 0)
    if isinstance(state, streaming.StreamState):
        return
    kv = state
    kv.stamp.masked_fill_(mask.view(-1, 1), -1)
    if kv.stage_stamp is not None:
        kv.stage_stamp.masked_fill_(mask.view(1, -1), -1)
    cache_format.reset(kv, mask)


class StreamArena:
    """Fixed-capacity batched streaming engine with slot lifecycle."""

    # frame pieces copied on an arena's copy stream, over every arena (4
    # a 5 Hz tick of the fused fast path on the card, 1 a 20 Hz tick, 0
    # on the CPU)
    upload_pieces = 0

    def __init__(self, cfg: VapConfig, params, capacity: int = 64,
                 path: str = "kv", dtype=torch.float32,
                 slots: str = "staged", attend_impl: str = "kernel",
                 quant_cache=False, wire_dtype=np.float32,
                 conv_impl: str = "conv", conv_chunks: int = 1,
                 resync_every: Optional[int] = None, device=None):
        """params: the params pytree with numpy (or array-like) leaves;
        cast to `dtype` on `device` (None = CUDA).  path: one of PATHS
        (see the module docstring); "full" takes no slots, quant_cache,
        attend_impl or conv_impl, "kv" and "hybrid" no conv_impl; the
        hybrid paths take slots "staged" or "stream".  resync_every: the
        hybrid paths' resync cadence in ticks (default
        cfg.context_frames).

        quant_cache: False, True / "row" (int8 cache, per-row scales) or
        "global" (int8 cache, per-stream frozen scales).  conv_impl:
        "conv", "normk" (the ChannelNorm+ReLU kernel in the encoder),
        "fused" (the whole conv stack in one kernel) or "blocked"; every
        form keeps the same conv state, so `_reset_slot` and `warmup`
        serve them all.  attend_impl: one of incremental.ATTEND_IMPLS;
        "kernel3" (the compact attend kernel) needs slots="stream" or
        "global".

        wire_dtype: dtype of the chunks fed to step() — np.float32
        (normalized audio) or np.int16 (raw samples, normalized /32768
        on the device: a quarter of the host->device bytes).
        """
        check_path(path)
        self.cfg = cfg
        self.capacity = capacity
        self.path = path
        self.dtype = dtype
        self.slots = slots
        self.attend_impl = attend_impl
        self.conv_impl = conv_impl
        self.conv_chunks = conv_chunks
        self.wire_dtype = wire_dtype
        self.device = resolve_device(device)
        self.resync_every = (cfg.context_frames if resync_every is None
                             else resync_every)
        self.chunk_samples = (cfg.frame_shift if path in FRESH_PATHS
                              else cfg.frame_samples)
        self.params = params_to_torch(params, self.device, dtype)
        self.state = init_path_state(path, cfg, capacity, dtype, self.device,
                                     staged=slots == "staged",
                                     quant=quant_cache, conv_impl=conv_impl)
        self._free: List[int] = list(range(capacity))
        self._active: Dict[int, bool] = {}
        self._lock = threading.Lock()
        self._zero = np.zeros((capacity, 2, self.chunk_samples), wire_dtype)
        self._piece = upload_piece(path, conv_impl, self.chunk_samples,
                                   dtype, self.device)
        # the copy stream and the two sets of upload buffers (none on the
        # CPU); self._groups counts the upload groups issued
        self._copy: Optional[torch.cuda.Stream] = None
        self._sets: List[_Uploads] = []
        self._groups = 0
        if self.device.type == "cuda":
            with on_device(self.device):
                self._copy = torch.cuda.Stream(self.device, priority=-1)
                self._sets = [_Uploads(
                    capacity, self.chunk_samples, dtype, self.device,
                    self.chunk_samples // self._piece) for _ in range(2)]

    # --- lifecycle ---------------------------------------------------------

    @property
    def n_active(self) -> int:
        return len(self._active)

    def add_stream(self) -> Optional[int]:
        """Claim a slot; returns its id or None when full."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._active[slot] = True
        self.reset_slot(slot)
        return slot

    def remove_stream(self, slot: int) -> None:
        with self._lock:
            if self._active.pop(slot, None) is not None:
                self._free.append(slot)

    def reset_slot(self, slot: int) -> None:
        """Reset a slot's stream state WITHOUT touching the free list
        (for external slot managers such as the native ingest engine)."""
        self.reset_slots([slot])

    def reset_slots(self, slots) -> None:
        """Reset MANY slots in one fixed-shape pass."""
        mask = np.zeros((self.capacity,), bool)
        mask[list(slots)] = True
        with span("vap.reset", n=int(mask.sum()),
                  id=tick_index(self.state)):
            up = self._next_set()
            _reset_slot(self.state, self._upload_mask(mask, up))
            self._release(up)

    # --- stepping ----------------------------------------------------------

    def _next_set(self) -> Optional[_Uploads]:
        """The upload buffers of the next group of uploads (None on the
        CPU); the copy stream waits until their last reader is done."""
        if self._copy is None:
            return None
        up = self._sets[self._groups % 2]
        self._groups += 1
        self._copy.wait_event(up.free)
        return up

    def _release(self, up: Optional[_Uploads]) -> None:
        """Mark `up` free once the compute stream's work so far is done."""
        if up is not None:
            up.free.record(torch.cuda.current_stream(self.device))

    def _upload_mask(self, arr: np.ndarray,
                     up: Optional[_Uploads]) -> torch.Tensor:
        """A (capacity,) bool host mask -> device tensor: a pinned copy,
        then an asynchronous transfer on the copy stream that the compute
        stream waits on (PyTorch's pinned block is not reused before the
        transfer completes)."""
        with span("vap.upload", n=arr.nbytes):
            t = torch.from_numpy(arr)
            if up is None:
                return t
            with torch.cuda.stream(self._copy):
                up.mask.copy_(t.pin_memory(), non_blocking=True)
                up.mask_ready.record(self._copy)
            up.mask_ready.wait(torch.cuda.current_stream(self.device))
            return up.mask

    def _upload_tick(self, frames: np.ndarray, act: np.ndarray,
                     up: Optional[_Uploads]):
        """The tick's host arrays -> (the (capacity, 2, chunk_samples)
        frame in the compute dtype, the active mask, the fence: one event
        a frame piece, None on the CPU) on the device.  The frame crosses
        in `upload_piece` pieces on the copy stream, each converted there
        before its event; the mask right after the first piece, so its
        host work does not delay the frame's first copy, nor the compute
        stream's wait on it the later pieces.  A pinned frame array is
        read in place; any other is first copied into a pinned block,
        which the host never reuses before the transfer completes."""
        if up is None:
            with span("vap.upload", n=frames.nbytes):
                t = torch.from_numpy(np.ascontiguousarray(frames))
            return t, self._upload_mask(act, None), None
        t = torch.from_numpy(np.ascontiguousarray(frames))
        if tuple(t.shape) != up.shape:
            raise ValueError(f"frames {tuple(t.shape)}: the arena takes "
                             f"{up.shape}")
        staged = not t.is_pinned()
        host = t.pin_memory() if staged else t
        L, P = self.chunk_samples, self._piece
        raw = up.wire(host.dtype)
        for j, at in enumerate(range(0, L, P)):
            with span("vap.upload", n=frames.nbytes * P // L), \
                    torch.cuda.stream(self._copy):
                if P == L:
                    raw.copy_(host, non_blocking=True)
                else:
                    upload_rows(raw.view(-1, L)[:, at:at + P],
                                host.view(-1, L)[:, at:at + P], self._copy)
                if raw is not up.x:
                    normalise(raw[..., at:at + P], self.dtype,
                              up.x[..., at:at + P])
                up.ready[j].record(self._copy)
            if j == 0:
                mask = self._upload_mask(act, up)
        if staged and P < L:
            # PyTorch frees a pinned block for reuse once the streams of
            # its non-blocking copies pass them, and knows nothing of a
            # copy made through ctypes: a one-element copy from the block,
            # behind the pieces, ties it to the copy stream
            with torch.cuda.stream(self._copy):
                up.tie.copy_(host.view(-1).view(torch.uint8)[:1],
                             non_blocking=True)
        StreamArena.upload_pieces += L // P
        return up.x, mask, up.ready

    def _run(self, frames: np.ndarray, act: np.ndarray, merge: str = "auto",
             resync_mode: str = "auto"):
        with span("vap.tick", id=tick_index(self.state)):
            up = self._next_set()
            x, mask, fence = self._upload_tick(frames, act, up)
            out = self.step_tensors(x, mask, merge, resync_mode, fence=fence)
            self._release(up)
            return out

    def step_tensors(self, x: torch.Tensor, act: torch.Tensor,
                     merge: str = "auto", resync_mode: str = "auto",
                     fence=None):
        """One tick on a (capacity, 2, chunk_samples) chunk batch and a
        (capacity,) active mask already on the arena's device (int16
        chunks are normalised here); returns the device output dict
        unread.  fence: None, or the events of x's upload pieces
        (`_upload_tick`).  `step`, `step_device` and
        `step_device_batch` call it inside a `vap.tick` span that also
        holds their uploads; a direct call's layer spans have no tick
        around them."""
        with on_device(self.device):
            self.state, out = path_step(
                self.path, self.params, self.state,
                normalise(x, self.dtype), self.cfg, act,
                slots=self.slots, attend_impl=self.attend_impl,
                conv_impl=self.conv_impl, conv_chunks=self.conv_chunks,
                merge=merge, resync_every=self.resync_every,
                resync_mode=resync_mode, fence=fence)
        return out

    def warmup(self) -> None:
        """All-frozen ticks (state-neutral): the first builds the kernels
        and warms the libraries; with staged slots another runs the merge
        path (a frozen empty-stage merge writes nothing) and on the hybrid
        paths another the resync path (a frozen resync rebuilds only rows
        the stamps already mask), as the JAX arena warms its merge and
        resync variants.  Each counts as a tick of the cadence."""
        act = np.zeros((self.capacity,), bool)
        ticks = [("auto", "auto")]
        if self.slots == "staged" and self.path != "full":
            ticks.append(("force", "never"))
        if self.path in HYBRID_PATHS:
            ticks.append(("never", "force"))
        for merge, resync_mode in ticks:
            out = self._run(self._zero, act, merge, resync_mode)
        for v in out.values():
            v.cpu()

    def step(self, chunks: Dict[int, np.ndarray]) -> Dict[int, Dict]:
        """chunks: {slot: (2, chunk_samples)} for streams with a fresh
        frame this tick; all other slots are FROZEN.  With the default
        ``slots="staged"`` (and ``"stream"``) a stream's results depend
        only on its own frame sequence.  Returns {slot: {name: array}}."""
        out = self.step_device(chunks)
        out_np = {k: v.float().cpu().numpy() for k, v in out.items()}
        return {slot: {k: v[slot] for k, v in out_np.items()}
                for slot in chunks}

    def step_device(self, chunks: Dict[int, np.ndarray]):
        """Dispatch one tick; returns the DEVICE output dict unread."""
        batch = self._zero.copy()
        act = np.zeros((self.capacity,), bool)
        for slot, chunk in chunks.items():
            batch[slot] = chunk
            act[slot] = True
        return self._run(batch, act)

    def step_device_batch(self, frames: np.ndarray, slots: np.ndarray):
        """`step_device` for callers holding the FULL (capacity, 2,
        chunk_samples) slot-major frame array (the native ingest poll
        buffer); rows not in `slots` are masked by the active flag.

        The staged merge and the resync are decided on the host from the
        state's tick counter ((step + 1) % STAGE_S == 0, (step + 1) %
        resync_every == 0), so no tick waits on the device to learn its
        cadence."""
        act = np.zeros((self.capacity,), bool)
        act[slots] = True
        return self._run(frames, act)
