"""VapEngine — the user-facing streaming engine (the `VAPRealTime`
analogue): params, one step and the carried state behind `process()`.

Port of `vap_realtime_tpu/runtime/engine.py` for three paths:
- "full": the parity-exact full recompute per frame (reference
  semantics; runtime/streaming.py);
- "kv":   the chunked encoder + incremental KV step (exact until the
  context window slides);
- "fast": the seamless streaming conv + incremental KV step, which
  consumes FRESH samples only (chunk length = frame_shift, no 320-sample
  overlap).
"full" and "kv" take whole overlapped frames (frame_samples).  The
hybrid paths wait for a later slice (ROADMAP.md Queue 1 item 8) and
raise.  The engine runs on the card unless the caller passes
`device="cpu"`; without CUDA it raises instead of falling back.

Differences of form from the JAX engine: the default path is "fast" and
the default attend is "kernel" (the hand-written attend; the JAX engine
defaults to "kv" and "einsum"); the kv and fast steps update the state in
place, so `warmup` steps a throw-away state.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import FRAME_CONTEXT_PADDING, VapConfig
from vap_realtime_tpu_torch.runtime.arena import (
    check_path, init_path_state, path_step, resolve_device,
)
from vap_realtime_tpu_torch.weights.convert import (
    load_pytree_npz, params_to_torch,
)

Params = Dict[str, Any]


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
        `dtype` on `device`.  path: "fast", "kv" or "full".  slots
        (default "staged"), attend_impl, quant_cache (kv and fast),
        conv_impl and conv_chunks (fast): see incremental.fast_step,
        kv_step and init_fast_state."""
        check_path(path)
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

    def _init_state(self):
        return init_path_state(self.path, self.cfg, self.batch, self.dtype,
                               self.device, staged=self.slots == "staged",
                               quant=self.quant_cache,
                               conv_impl=self.conv_impl)

    def _step(self, state, chunk: torch.Tensor):
        return path_step(self.path, self.params, state, chunk, self.cfg,
                         slots=self.slots, attend_impl=self.attend_impl,
                         conv_impl=self.conv_impl,
                         conv_chunks=self.conv_chunks)

    @property
    def audio_frame_size(self) -> int:
        return self.chunk_samples

    @property
    def chunk_samples(self) -> int:
        """Samples the engine consumes per frame: frame_shift (fresh
        samples only) on the fast path, frame_samples (with the
        320-sample overlap) elsewhere."""
        return (self.cfg.frame_shift if self.path == "fast"
                else self.cfg.frame_samples)

    @property
    def frame_contxt_padding(self) -> int:
        """Samples of left-context overlap per frame: none on the fast
        path, FRAME_CONTEXT_PADDING on the others."""
        return 0 if self.path == "fast" else FRAME_CONTEXT_PADDING

    def warmup(self) -> None:
        """Build the kernels and warm the libraries ahead of the first
        real frame, on a throw-away state (the kv and fast steps update
        their state in place)."""
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
