"""Ring-row writes of the KV cache: the row scatter and the staged merge.

`scatter_rows` writes one row per stream into a ring (the per-stream slot
write, the embedding ring of the hybrid paths); it is plain PyTorch.

`stage_merge` is the staged-slot policy's merge: every STAGE_S ticks the
serving step moves each valid staged row (stage_stamp[i, b] >= 0) to its
stream's own ring position stage_stamp[i, b] % T, with its stamp and, on an
int8 cache with row scales, its scales, and marks the stage empty (-1).
On a CUDA tensor it is ONE launch of the hand-written kernel in
`vap_realtime_tpu_torch/csrc/stage_merge.cu`; it replaces no TPU kernel
(the JAX package's merge is XLA scatters), but the plain version,
`stage_merge_plain` (3 x S row scatters of several PyTorch ops each and a
fill, over a hundred launches a merge), took 12x the byte floor.  The
kernel copies bytes: one body for bf16, float32 and int8 rows, row scales
when given.

Bound on the H100: bytes, each valid staged row read once and written
once (4.70 GB at S = 8, B = 20,480, P = 7, 4D = 1,024 bf16: 1.40 ms at
3.35 TB/s).  The wrapper checks its arguments, launches on the current
stream, allocates nothing and never synchronises; on CPU tensors it runs
`stage_merge_plain`, which chip_smoke.py holds the kernel against on the
card, bit for bit.  `stage_merge.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

Tensor = torch.Tensor

MAX_STAGE = 64  # stage depth the kernel holds in shared memory


def scatter_rows(cache: Tensor, rows: Tensor, idx: Tensor,
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


def scatter_rows_multi(cache: Tensor, vals: Tensor, idx: Tensor,
                       valid: Tensor) -> None:
    """S-row variant of `scatter_rows` (the staged-merge write), one row
    per stream at a time: vals (S, B, P, X); idx, valid (S, B).  A
    stream's valid targets are distinct, so the order does not matter."""
    for i in range(vals.shape[0]):
        scatter_rows(cache, vals[i], idx[i], valid[i])


def stage_merge_plain(cache: Tensor, stamp: Tensor, stage: Tensor,
                      stage_stamp: Tensor, scale: Optional[Tensor] = None,
                      stage_scale: Optional[Tensor] = None) -> None:
    """The merge in plain PyTorch, in place (see `stage_merge`)."""
    S, B = stage_stamp.shape
    P, T = cache.shape[1], cache.shape[2]
    valid = stage_stamp >= 0                                   # (S, B)
    idx = torch.remainder(stage_stamp, T)
    # stamps and row scales ride the same row writer as (B, 1|P, T, 1)
    # views
    scatter_rows_multi(cache, stage.view(S, B, P, -1), idx, valid)
    scatter_rows_multi(stamp.view(B, 1, T, 1), stage_stamp.view(S, B, 1, 1),
                       idx, valid)
    if scale is not None:
        scatter_rows_multi(scale[..., None], stage_scale[..., None], idx,
                           valid)
    stage_stamp.fill_(-1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from vap_realtime_tpu_torch.ops.cuda.build import load

    lib = load("stage_merge")
    fn = lib.stage_merge_launch
    fn.restype = ctypes.c_int
    V = ctypes.c_void_p
    I = ctypes.c_int
    # cache, stamp, stage, stage_stamp, scale, stage_scale, S, B, P, T,
    # row_bytes, stream
    fn.argtypes = [V, V, V, V, V, V, I, I, I, I, ctypes.c_longlong, V]
    return lib


def stage_merge(cache: Tensor, stamp: Tensor, stage: Tensor,
                stage_stamp: Tensor, scale: Optional[Tensor] = None,
                stage_scale: Optional[Tensor] = None) -> None:
    """In place, for every (i, b) with stage_stamp[i, b] >= 0 and
    t = stage_stamp[i, b] % T: cache[b, p, t] = stage[i, b, p*X:(p+1)*X]
    for every phase p, stamp[b, t] = stage_stamp[i, b] and, given row
    scales, scale[b, p, t] = stage_scale[i, b, p]; then stage_stamp = -1.

    cache (B, P, T, X) and stage (S, B, P*X) of one element type; stamp
    (B, T) and stage_stamp (S, B) int32; scale (B, P, T) and stage_scale
    (S, B, P) float32, or neither."""
    if cache.device.type == "cpu":
        stage_merge_plain(cache, stamp, stage, stage_stamp, scale,
                          stage_scale)
        return

    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"stage_merge: {msg}")

    check(cache.device.type == "cuda", f"unsupported device {cache.device}")
    check(cache.dim() == 4, "cache must be (B, P, T, X)")
    Bn, P, T, X = cache.shape
    check(stage_stamp.dim() == 2 and stage_stamp.shape[1] == Bn,
          f"stage_stamp must be (S, {Bn})")
    S = stage_stamp.shape[0]
    check(0 < S <= MAX_STAGE, f"stage depth {S} not in 1..{MAX_STAGE}")
    check(stage.dtype == cache.dtype, f"stage dtype {stage.dtype} != cache "
                                      f"dtype {cache.dtype}")
    check(stage.dim() == 3 and tuple(stage.shape) == (S, Bn, P * X),
          f"stage must be ({S}, {Bn}, {P * X})")
    check(tuple(stamp.shape) == (Bn, T), f"stamp must be ({Bn}, {T})")
    check(stamp.dtype == torch.int32 and stage_stamp.dtype == torch.int32,
          "stamps must be int32")
    check((scale is None) == (stage_scale is None),
          "give both scale and stage_scale or neither")
    ts = [cache, stamp, stage, stage_stamp]
    if scale is not None:
        check(tuple(scale.shape) == (Bn, P, T)
              and tuple(stage_scale.shape) == (S, Bn, P),
              f"scales must be ({Bn}, {P}, {T}) and ({S}, {Bn}, {P})")
        check(scale.dtype == torch.float32
              and stage_scale.dtype == torch.float32,
              "scales must be float32")
        ts += [scale, stage_scale]
    check(all(t.device == cache.device for t in ts),
          "all tensors must be on the cache's device")
    check(all(t.is_contiguous() for t in ts),
          "all tensors must be contiguous")
    row_bytes = X * cache.element_size()
    check(row_bytes % 16 == 0 and cache.data_ptr() % 16 == 0
          and stage.data_ptr() % 16 == 0,
          f"rows of {row_bytes} bytes: the kernel copies 16-byte vectors "
          f"(rows a multiple of 16 bytes, cache and stage 16-byte aligned)")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(cache.device):
        rc = _lib().stage_merge_launch(
            cache.data_ptr(), stamp.data_ptr(), stage.data_ptr(),
            stage_stamp.data_ptr(), ptr(scale), ptr(stage_scale), S, Bn, P,
            T, row_bytes, torch.cuda.current_stream(cache.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage_merge: kernel launch failed, "
                           f"cudaError {rc}")
    stage_merge.launches += 1


stage_merge.launches = 0
