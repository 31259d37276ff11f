"""StreamArena — slot-based multi-stream serving state on the device.

A fixed-capacity arena of stream slots: admission resets a free slot's
recurrent state (its stale cache rows are masked by their stamps, so no
cache clearing is needed); eviction returns the slot to the free list.
Every tick steps the FULL batch once; empty slots are frozen (their
state is untouched and their outputs ignored).

Port of `vap_realtime_tpu/runtime/arena.py` for `path="fast"` (the
streaming encoder over fresh samples + the KV step), `"kv"` (the chunked
encoder over overlapped frames + the KV step) and `"full"` (the
parity-exact full recompute).  The arena runs on the card unless the
caller asks for the CPU; without CUDA it raises instead of falling back.

A difference of form from the JAX arena: its kv path calls `kv_step`
without `attend_impl` (so always the einsum attend); this arena passes
`attend_impl` through, so its kv path runs the attend kernel on the card.
The outputs agree at 1e-4 either way.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime import incremental, streaming
from vap_realtime_tpu_torch.weights.convert import params_to_torch

PATHS = ("fast", "kv", "full")
# the JAX package's paths that wait for a later slice of the port
HYBRID = {"hybrid", "fast_hybrid"}
HYBRID_WAITS = "ROADMAP.md Queue 1 item 8 (hybrid paths)"


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when None; raises when CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def check_path(path: str) -> None:
    """Raises for a path the port does not serve (the hybrid paths name
    the ROADMAP item they wait in)."""
    if path in HYBRID:
        raise ValueError(f"path {path!r} is not ported yet (waits in "
                         f"{HYBRID_WAITS}); use 'fast', 'kv' or 'full'")
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r} (use one of {PATHS})")


def init_path_state(path: str, cfg: VapConfig, batch: int, dtype, device,
                    *, staged: bool, quant=False, conv_impl: str = "conv"):
    """A fresh state of one path's step: StreamState ("full"), KVState
    ("kv") or FastState ("fast"); staged / quant apply to kv and fast,
    conv_impl to fast."""
    if path == "full":
        return streaming.init_stream_state(cfg, batch, dtype, device)
    if path == "kv":
        return incremental.init_kv_state(cfg, batch, dtype, staged, device,
                                         quant=quant)
    return incremental.init_fast_state(cfg, batch, dtype, staged, device,
                                       quant=quant, conv_impl=conv_impl)


def path_step(path: str, params, state, chunk: torch.Tensor,
              cfg: VapConfig, active: Optional[torch.Tensor] = None, *,
              slots: str, attend_impl: str, conv_impl: str = "conv",
              conv_chunks: int = 1, merge: str = "auto"):
    """One step of a path: `stream_step` ("full"), `kv_step` ("kv") or
    `fast_step` ("fast") with the options that path takes.  Returns
    (state, outputs)."""
    if path == "full":
        return streaming.stream_step(params, state, chunk, cfg, active)
    if path == "kv":
        return incremental.kv_step(params, state, chunk, cfg, active,
                                   slots=slots, attend_impl=attend_impl,
                                   merge=merge)
    return incremental.fast_step(params, state, chunk, cfg, active,
                                 slots=slots, attend_impl=attend_impl,
                                 conv_impl=conv_impl,
                                 conv_chunks=conv_chunks, merge=merge)


def _reset_slot(state, mask: torch.Tensor) -> None:
    """In place: zero the recurrent state and validity counters of every
    slot where `mask` ((B,) bool) is set, in one fixed-shape pass, for a
    FastState, KVState or StreamState.  Cache, stage and embedding-buffer
    rows stay: their stamps or the count invalidate them.  Per-row scales
    stay too (read only for live rows); the frozen scales of
    quant="global" are zeroed, so the next stream calibrates anew."""
    if isinstance(state, incremental.FastState):
        m2 = mask.repeat_interleave(2).view(-1, 1, 1)  # conv tails per channel
        for v in state.conv.values():
            v.masked_fill_(m2, 0)
        state = state.kv
    state.lstm_h.masked_fill_(mask.view(-1, 1, 1), 0)
    state.lstm_c.masked_fill_(mask.view(-1, 1, 1), 0)
    state.count.masked_fill_(mask, 0)
    if isinstance(state, streaming.StreamState):
        return
    kv = state
    kv.stamp.masked_fill_(mask.view(-1, 1), -1)
    if kv.stage_stamp is not None:
        kv.stage_stamp.masked_fill_(mask.view(1, -1), -1)
    if kv.quant == "global":
        kv.scale.masked_fill_(mask.view(-1, 1, 1, 1), 0)


class StreamArena:
    """Fixed-capacity batched streaming engine with slot lifecycle."""

    def __init__(self, cfg: VapConfig, params, capacity: int = 64,
                 path: str = "fast", dtype=torch.float32,
                 slots: str = "staged", attend_impl: str = "kernel",
                 quant_cache=False, wire_dtype=np.float32,
                 conv_impl: str = "conv", conv_chunks: int = 1,
                 device=None):
        """params: the params pytree with numpy (or array-like) leaves;
        cast to `dtype` on `device` (None = CUDA).  path: "fast", "kv"
        or "full" (see the module docstring); "full" takes no slots,
        quant_cache, attend_impl or conv_impl, "kv" no conv_impl.

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
        # the fast path consumes FRESH samples only (no 320 overlap); the
        # others take whole overlapped frames
        self.chunk_samples = (cfg.frame_shift if path == "fast"
                              else cfg.frame_samples)
        self.params = params_to_torch(params, self.device, dtype)
        self.state = init_path_state(path, cfg, capacity, dtype, self.device,
                                     staged=slots == "staged",
                                     quant=quant_cache, conv_impl=conv_impl)
        self._free: List[int] = list(range(capacity))
        self._active: Dict[int, bool] = {}
        self._lock = threading.Lock()
        self._zero = np.zeros((capacity, 2, self.chunk_samples), wire_dtype)

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
        _reset_slot(self.state, self._upload(mask))

    # --- stepping ----------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without stalling the host: a
        pinned copy, then an asynchronous transfer (the pinned block is
        not reused before the transfer completes)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run(self, frames: np.ndarray, act: np.ndarray, merge: str):
        x = self._upload(frames).to(self.dtype)
        if frames.dtype == np.int16:
            x = x * (1.0 / 32768.0)          # exact power-of-two scale
        self.state, out = path_step(
            self.path, self.params, self.state, x, self.cfg,
            self._upload(act), slots=self.slots,
            attend_impl=self.attend_impl, conv_impl=self.conv_impl,
            conv_chunks=self.conv_chunks, merge=merge)
        return out

    def warmup(self) -> None:
        """All-frozen ticks (state-neutral): the first builds the kernel
        and warms the libraries; with staged slots a second one runs the
        merge path (a frozen empty-stage merge writes nothing), as the
        JAX arena warms its merge variant."""
        act = np.zeros((self.capacity,), bool)
        modes = (["never", "force"]
                 if self.slots == "staged" and self.path != "full"
                 else ["never"])
        for merge in modes:
            out = self._run(self._zero, act, merge)
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
        return self._run(batch, act, "auto")

    def step_device_batch(self, frames: np.ndarray, slots: np.ndarray):
        """`step_device` for callers holding the FULL (capacity, 2,
        chunk_samples) slot-major frame array (the native ingest poll
        buffer); rows not in `slots` are masked by the active flag.

        The staged merge is decided on the host from the state's tick
        counter ("auto": (step + 1) % STAGE_S == 0), so no tick waits on
        the device to learn its cadence."""
        act = np.zeros((self.capacity,), bool)
        act[slots] = True
        return self._run(frames, act, "auto")
