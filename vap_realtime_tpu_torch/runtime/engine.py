"""VapEngine — the user-facing streaming engine (the `VAPRealTime`
analogue): params, one step and the carried state behind `process()`.

Port of `vap_realtime_tpu/runtime/engine.py` for `path="fast"`: the
seamless streaming conv + incremental KV step, which consumes FRESH
samples only (chunk length = frame_shift, no 320-sample overlap).  The
JAX package's other paths ("kv", "full", "hybrid", "fast_hybrid") are
not ported yet (ROADMAP.md Queue 1, items 3, 4 and 8) and raise.  The
engine runs on the card unless the caller passes `device="cpu"`; without
CUDA it raises instead of falling back.

Differences of form from the JAX engine: the default path is "fast" (the
only one here) and the default attend is "kernel" (the hand-written
attend; the JAX engine defaults to "einsum"); the step updates the state
in place, so `warmup` steps a throw-away state.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import FRAME_CONTEXT_PADDING, VapConfig
from vap_realtime_tpu_torch.runtime import incremental
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.weights.convert import (
    load_pytree_npz, params_to_torch,
)

Params = Dict[str, Any]

# the JAX engine's paths that wait for later slices of the port
_UNPORTED = {"kv": "ROADMAP.md Queue 1 item 4 (kv_step)",
             "full": "ROADMAP.md Queue 1 item 3 (runtime/streaming.py)",
             "hybrid": "ROADMAP.md Queue 1 item 8 (hybrid paths)",
             "fast_hybrid": "ROADMAP.md Queue 1 item 8 (hybrid paths)"}


class VapEngine:
    CALC_PROCESS_TIME_INTERVAL = 100  # telemetry cadence (vap_main.py:190)

    def __init__(self, cfg: Optional[VapConfig] = None,
                 params: Optional[Params] = None,
                 checkpoint_npz: Optional[str] = None,
                 path: str = "fast", batch: int = 1,
                 dtype=torch.float32, attend_impl: str = "kernel",
                 quant_cache: Any = False, slots: Optional[str] = None,
                 conv_impl: str = "conv", conv_chunks: int = 1,
                 device="cuda"):
        """params: the params pytree with numpy (or array-like) leaves,
        or checkpoint_npz: a pytree .npz (weights/convert.py); cast to
        `dtype` on `device`.  slots (default "staged"), attend_impl,
        quant_cache, conv_impl and conv_chunks: see incremental.fast_step
        and init_fast_state."""
        if path in _UNPORTED:
            raise ValueError(f"path {path!r} is not ported yet (waits in "
                             f"{_UNPORTED[path]}); use path='fast'")
        if path != "fast":
            raise ValueError(f"unknown path {path!r} (use 'fast')")
        self.cfg = cfg or VapConfig()
        self.batch = batch
        self.path = path
        self.dtype = dtype
        self.attend_impl = attend_impl
        self.quant_cache = quant_cache
        self.conv_impl = conv_impl
        self.conv_chunks = conv_chunks
        # "staged": exact per-stream isolation at global-slot write cost
        self.slots = "staged" if slots is None else slots
        self.device = resolve_device(device)
        if params is None:
            if not checkpoint_npz:
                raise ValueError("provide params or checkpoint_npz")
            params = load_pytree_npz(checkpoint_npz)
        self.params = params_to_torch(params, self.device, dtype)
        self.state = self._init_state()

        # latest results, reference-style fields (vap_main.py:235-241)
        self.result: Dict[str, Any] = {}
        self.result_last_time = -1.0
        self.process_time_abs = -1.0
        self._proc_times: list = []
        self._last_interval_time = time.time()

    def _init_state(self) -> incremental.FastState:
        return incremental.init_fast_state(
            self.cfg, self.batch, self.dtype, self.slots == "staged",
            self.device, quant=self.quant_cache, conv_impl=self.conv_impl)

    def _step(self, state, chunk: torch.Tensor):
        return incremental.fast_step(
            self.params, state, chunk, self.cfg, slots=self.slots,
            attend_impl=self.attend_impl, conv_impl=self.conv_impl,
            conv_chunks=self.conv_chunks)

    @property
    def audio_frame_size(self) -> int:
        return self.chunk_samples

    @property
    def chunk_samples(self) -> int:
        """Samples the engine consumes per frame: frame_shift (fresh
        samples only) on the fast path."""
        return self.cfg.frame_shift

    @property
    def frame_contxt_padding(self) -> int:
        """The fast path takes no left-context overlap (the other paths
        take FRAME_CONTEXT_PADDING samples)."""
        return 0 if self.path == "fast" else FRAME_CONTEXT_PADDING

    def warmup(self) -> None:
        """Build the kernels and warm the libraries ahead of the first
        real frame, on a throw-away state (the step updates its state in
        place)."""
        z = torch.zeros((self.batch, 2, self.chunk_samples), dtype=self.dtype,
                        device=self.device)
        _, out = self._step(self._init_state(), z)
        for v in out.values():
            v.cpu()

    def process_batch(self, chunk: np.ndarray) -> Dict[str, np.ndarray]:
        """chunk: (B, 2, chunk_samples) -> dict of (B, ...) numpy results
        (float32)."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.shape != (self.batch, 2, self.chunk_samples):
            raise ValueError(
                f"expected chunk shape {(self.batch, 2, self.chunk_samples)}"
                f" (batch, channels, samples), got {chunk.shape}")
        t0 = time.time()
        x = torch.from_numpy(chunk).to(self.device).to(self.dtype)
        self.state, out = self._step(self.state, x)
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        self.result = out
        self.result_last_time = time.time()
        self._telemetry(time.time() - t0)
        self.process_time_abs = time.time()
        return out

    def process(self, x1: np.ndarray, x2: np.ndarray) -> Dict[str, Any]:
        """Single-stream convenience (batch must be 1): the reference
        `process_vap(x1, x2)` signature (vap_main.py:249)."""
        if self.batch != 1:
            raise ValueError("use process_batch for batched engines")
        chunk = np.stack([np.asarray(x1, np.float32),
                          np.asarray(x2, np.float32)])[None]
        out = self.process_batch(chunk)
        return {k: v[0] for k, v in out.items()}

    def _telemetry(self, dt: float) -> None:
        self._proc_times.append(dt)
        if len(self._proc_times) > self.CALC_PROCESS_TIME_INTERVAL:
            avg = float(np.mean(self._proc_times))
            rate = len(self._proc_times) / (time.time()
                                            - self._last_interval_time)
            self._last_interval_time = time.time()
            print(f"[VAP] Average processing time: {avg:.5f} [sec], "
                  f"#process/sec: {rate:.3f}")
            self._proc_times = []
