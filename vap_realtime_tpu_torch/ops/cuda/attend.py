"""Twin single-query KV-step attention: CUDA kernel wrapper + plain version.

`attend_pair` replaces the TPU kernel `fused_attend_pair`
(vap_realtime_tpu/ops/pallas/attend.py:454) on the float caches, both of
its bodies: `_kernel_pair` (ring rows only, `slots="stream"/"global"`)
and `_kernel_pair_st` (ring + staged rows, the `slots="staged"` serving
default).  The kernel is `vap_realtime_tpu_torch/csrc/attend_pair.cu`,
hand-written for Hopper; see its header for the design.

Bound on the H100: memory.  At B=4096, T=50, S=8, bf16 one launch reads
~0.49 GB (phase plane 419 MB + stage slice 67 MB): ~0.145 ms at 3.35 TB/s,
~1.0 ms for the 7 launches of a serving step.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `attend_pair_plain`, the same math in plain PyTorch (the
CPU tests use it; chip_smoke.py holds the kernel against it on the card).
`attend_pair.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from vap_realtime_tpu_torch.ops.cuda.build import load

DEAD = 1e9  # age marker of an invalid cache row: its weight is exactly 0
LOG2E = 1.4426950408889634  # scores are kept in log2 units (exp2)

Tensor = torch.Tensor


def _prescale(q2: Tensor) -> Tensor:
    """Fold the 1/sqrt(D) score scale and the exp -> exp2 factor into q,
    with the factor rounded to q's dtype first (as the TPU kernel's
    wrapper does).  A Python scalar: no host-to-device copy."""
    c = LOG2E / math.sqrt(q2.shape[-1])
    return q2 * torch.tensor(c, dtype=q2.dtype).item()


def _slopes(H: int, device) -> Tensor:
    """Per-head AliBi slope in log2 units, m_h = 2^(-8(h+1)/H) * log2(e)
    (closed form for power-of-2 H, as in the TPU kernel)."""
    h = torch.arange(H, dtype=torch.float32, device=device)
    return torch.exp2(-8.0 * (h + 1.0) / H) * LOG2E


def attend_pair_plain(cache: Tensor, q2: Tensor, k_cur2: Tensor,
                      v_cur2: Tensor, age: Tensor,
                      stage: Optional[Tensor] = None,
                      stage_age: Optional[Tensor] = None, *,
                      pair_base: int, num_heads: int = 4) -> Tensor:
    """Plain PyTorch version of the kernel: the v4 softmax of the TPU
    kernel's `_attend_math` (ops/pallas/attend.py:55), with its rounding
    points — `(k - kc) * q` in the state dtype, head sums and softmax in
    float32, `w.to(v.dtype) * v` in the state dtype, value sums in float32.

    cache (B, P, T, 4D); q2/k_cur2/v_cur2 (B, 2, D); age (B, T) float32,
    DEAD for invalid rows; stage (S, B, P*4D) and stage_age (S, B) float32
    for the staged slot policy, or None.  Returns (B, 2, D).
    """
    B, P, T, D4 = cache.shape
    D = q2.shape[-1]
    H = num_heads
    Dh = D // H
    ph = pair_base // 2
    dtype = cache.dtype
    q2 = _prescale(q2)
    m = _slopes(H, cache.device)                            # (H,)
    outs = []
    for s in range(2):
        q, kc, vc = q2[:, s], k_cur2[:, s], v_cur2[:, s]      # (B, D)
        k = cache[:, ph, :, 2 * s * D:(2 * s + 1) * D]      # (B, T, D)
        v = cache[:, ph, :, (2 * s + 1) * D:(2 * s + 2) * D]
        # the current score folds into the shift: (k - kc) . q = s - s_cur
        sc = ((k - kc[:, None]) * q[:, None]).float().view(B, T, H, Dh)
        w = torch.exp2(torch.clamp(sc.sum(-1) - age[:, :, None] * m,
                                   max=86.0))               # (B, T, H)
        denom = w.sum(1) + 1.0                              # (B, H)
        out = (w.to(dtype)[..., None] * v.view(B, T, H, Dh)).float().sum(1)
        out = out + vc.float().view(B, H, Dh)               # w_cur == 1
        if stage is not None:
            S = stage.shape[0]
            col = ph * D4 + 2 * s * D
            ks = stage[:, :, col:col + D]                   # (S, B, D)
            vs = stage[:, :, col + D:col + 2 * D]
            sc2 = ((ks - kc[None]) * q[None]).float().view(S, B, H, Dh)
            w2 = torch.exp2(torch.clamp(
                sc2.sum(-1) - stage_age[:, :, None] * m, max=86.0))
            denom = denom + w2.sum(0)
            out = out + (w2.to(dtype)[..., None]
                         * vs.view(S, B, H, Dh)).float().sum(0)
        outs.append((out / denom[..., None]).reshape(B, D).to(dtype))
    return torch.stack(outs, dim=1)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    lib = load("attend_pair")
    fn = lib.attend_pair_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"attend_pair: {msg}")


def attend_pair(cache: Tensor, q2: Tensor, k_cur2: Tensor, v_cur2: Tensor,
                age: Tensor, stage: Optional[Tensor] = None,
                stage_age: Optional[Tensor] = None, *, pair_base: int,
                num_heads: int = 4) -> Tensor:
    """TWO single-query attentions (the twin channels / towers of one
    layer phase) over ONE contiguous cache plane, in one launch.

    Same argument meaning as the TPU `fused_attend_pair` (float caches):
    set s of q2/k_cur2/v_cur2 reads cache pair `pair_base + s`, i.e. phase
    pair_base // 2, columns [2sD, (2s+2)D).  Stage ages are (S, B) float32
    (the TPU kernel took them lane-broadcast in the state dtype, a Mosaic
    layout constraint).  Ages and liveness are computed by the caller.
    """
    if cache.device.type == "cpu":
        return attend_pair_plain(cache, q2, k_cur2, v_cur2, age, stage,
                                 stage_age, pair_base=pair_base,
                                 num_heads=num_heads)
    _check(cache.device.type == "cuda",
           f"unsupported device {cache.device}")
    B, P, T, D4 = cache.shape
    D = q2.shape[-1]
    H = num_heads
    dtype = cache.dtype
    _check(dtype in _DTYPES, f"cache dtype {dtype} (float32 / bfloat16)")
    _check(D4 == 4 * D and D == 64 * H and 0 < H <= 32,
           f"needs D = 64 * heads and a (.., 4D) cache; got D={D}, H={H}, "
           f"cache {tuple(cache.shape)}")
    _check(pair_base % 2 == 0 and 0 <= pair_base // 2 < P,
           f"pair_base {pair_base} must open one of the {P} phases")
    tensors = [cache, q2, k_cur2, v_cur2, age]
    for t, shape in zip(tensors[1:4], [(B, 2, D)] * 3):
        _check(tuple(t.shape) == shape and t.dtype == dtype,
               f"q/k_cur/v_cur must be {shape} {dtype}")
    _check(tuple(age.shape) == (B, T) and age.dtype == torch.float32,
           "age must be (B, T) float32")
    S = 0
    if stage is not None:
        S = stage.shape[0]
        _check(tuple(stage.shape) == (S, B, P * D4) and stage.dtype == dtype,
               f"stage must be (S, {B}, {P * D4}) {dtype}")
        _check(stage_age is not None and tuple(stage_age.shape) == (S, B)
               and stage_age.dtype == torch.float32,
               "stage_age must be (S, B) float32")
        tensors += [stage, stage_age]
    for t in tensors:
        _check(t.device == cache.device, "all tensors on one device")
        _check(t.is_contiguous(), "all tensors contiguous")
    q2 = _prescale(q2)
    out = torch.empty((B, 2, D), dtype=dtype, device=cache.device)
    with torch.cuda.device(cache.device):
        rc = _lib().attend_pair_launch(
            _DTYPES[dtype], cache.data_ptr(), q2.data_ptr(),
            k_cur2.data_ptr(), v_cur2.data_ptr(), age.data_ptr(),
            stage.data_ptr() if S else None,
            stage_age.data_ptr() if S else None, out.data_ptr(),
            B, P, T, D, H, S, pair_base // 2,
            torch.cuda.current_stream(cache.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attend_pair: kernel launch failed, "
                           f"cudaError {rc}")
    attend_pair.launches += 1
    return out


attend_pair.launches = 0
