"""The attend-lab ablations: CUDA kernel wrapper + plain version.

`attend_lab` replaces the TPU lab kernel `launch` (tools/attend_lab.py:304,
K11) over the ablated bodies of the JAX lab (attend_lab.py:51-262), which
the lab tool times to split the attend kernel's time into parts.  Each
body reads ONE phase plane `cache[:, phase]` of a (B, P, T, 4D) cache and
writes (B, 2D); numerically wrong by design, but each is one function:

  "dma"      `_k_dma` (bf16 / float cache) and `_k_q8dma` (int8 codes):
             the phase plane summed over T, its first 2D columns
  "mxu"      `_k_mxu`: head-summed k * q scores times v, no softmax
  "nomax", "noexp", "f32out", "nodenom", "noout", "bf16exp"
             `_bcast_body` with the softmax ablated per mode
  "q8glb"    `_k_q8glb`: the scale-free int8 body with the constant C_V
  "v5"       `_k_v5`: the age * m product shared by both sets, the s_cur
             shift folded into the bias

The production bodies of the lab are the serving kernels: `bcast`
(`_k_prod(compact=False)`, i.e. `_attend_math`) is K1, `compact` is K10,
`q8_row` (`_k_q8row`) is K4; the lab tool launches `attend_pair` for them.

The kernel (`vap_realtime_tpu_torch/csrc/attend_lab.cu`) has the K1 block
layout of the serving attend, templated on the mode and on the number of
streams per CUDA block (1 or 2: the counterpart of the TPU grid's stream
block Bb), so an ablation removes work from the body that serves.  Bound
on the H100: bytes, the phase plane (bf16 0.42 GB at B=4096, T=50) plus
q, kc, vc, age and out for the modes that read them.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `attend_lab_plain`, the same math in plain PyTorch written
from the JAX bodies with their rounding points.  `attend_lab.launches`
counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vap_realtime_tpu_torch.ops.cuda.build import load

Tensor = torch.Tensor

# in the order of the kernel's `Mode`
MODES = ("dma", "mxu", "nomax", "noexp", "f32out", "nodenom", "noout",
         "bf16exp", "q8glb", "v5")
INT8_MODES = ("dma", "q8glb")   # the modes the lab runs on an int8 cache
C_V = 0.0123                    # `_k_q8glb`'s compile-time value scale
LOG2E = 1.4426950408889634


def _prescaled(q: Tensor, D: int) -> Tensor:
    """q * log2(e) / sqrt(D), the factor rounded to q's dtype first, as
    the JAX body's `q_ref * (scale * 1.4426950408889634)` does."""
    return q * torch.tensor(LOG2E / math.sqrt(D), dtype=q.dtype).item()


def _body_plain(mode: str, q: Tensor, k: Tensor, v: Tensor, kc: Tensor,
                vc: Tensor, age: Tensor, H: int) -> Tensor:
    """One twin set: q, kc, vc (B, D) in q's dtype; k, v (B, T, D) cast
    to it; age (B, T) float32.  Returns (B, D) float32."""
    B, T, D = k.shape
    Dh = D // H
    f32 = torch.float32
    scale = 1.0 / math.sqrt(D)
    m = torch.exp2(-8.0 * (torch.arange(H, dtype=f32, device=k.device) + 1)
                   / H)                                       # (H,)
    heads = lambda x: x.float().view(*x.shape[:-1], H, Dh)
    hsum = lambda x: heads(x).sum(-1)                         # (.., H)

    def weighted(w):
        """sum_t w.astype(v.dtype) * v in v's dtype, summed in float32:
        (B, H, Dh)."""
        return (w.to(v.dtype)[..., None] * v.view(B, T, H, Dh)).float().sum(1)

    def per_lane(x):                                          # (B, H, Dh)
        return x.reshape(B, D)

    if mode == "mxu":
        w = hsum(k * q[:, None])                              # (B, T, H)
        return per_lane((w[..., None] * heads(v)).sum(1))
    if mode in ("q8glb", "v5"):
        q = _prescaled(q, D)
        if mode == "q8glb":
            arg = hsum((k - kc[:, None]) * q[:, None]) - age[..., None] * m
        else:
            arg = hsum(k * q[:, None]) - (age[..., None] * m
                                          + hsum(kc * q)[:, None])
        w = torch.exp2(torch.clamp(arg, max=86.0))
        out = weighted(w)
        if mode == "q8glb":
            out = out * C_V
        out = out + heads(vc)
        return per_lane(out / (w.sum(1) + 1.0)[..., None])
    # the `_bcast_body` modes
    s = hsum(k * q[:, None]) * scale - age[..., None] * m     # (B, T, H)
    s_cur = hsum(kc * q) * scale                              # (B, H)
    if mode == "bf16exp":
        mx = torch.maximum(s.amax(1), s_cur)
        w = torch.exp((s - mx[:, None]).to(torch.bfloat16))
        w_cur = torch.exp(s_cur - mx)
        vb = v.to(torch.bfloat16).view(B, T, H, Dh)
        out = (w[..., None] * vb).float().sum(1)
        out = out + w_cur[..., None] * heads(vc)
        return per_lane(out / (w.float().sum(1) + w_cur)[..., None])
    if mode == "noexp":
        w, w_cur = torch.clamp(s, max=60.0), torch.clamp(s_cur, max=60.0)
    else:
        w = torch.exp(torch.clamp(s, max=60.0))
        w_cur = torch.exp(torch.clamp(s_cur, max=60.0))
    if mode == "nodenom":
        return per_lane(weighted(w) + heads(vc))
    denom = w.sum(1) + w_cur                                  # (B, H)
    if mode == "noout":
        return per_lane((w[:, 0] / denom)[..., None].expand(B, H, Dh))
    if mode == "f32out":
        out = (w[..., None] * heads(v)).sum(1)
    else:                                                     # nomax, noexp
        out = weighted(w)
    out = out + w_cur[..., None] * heads(vc)
    return per_lane(out / denom[..., None])


def attend_lab_plain(mode: str, cache: Tensor, q2: Tensor, kc2: Tensor,
                     vc2: Tensor, age: Tensor, phase: int, *,
                     num_heads: int = 4) -> Tensor:
    """The lab body `mode` in plain PyTorch, with the JAX body's rounding
    points (products in q's dtype where the body takes them so).

    cache (B, P, T, 4D) in q's dtype, or int8 codes for INT8_MODES;
    q2, kc2, vc2 (B, 2D), set s at columns [sD, (s+1)D); age (B, T)
    float32.  Returns (B, 2D) in q's dtype."""
    _check_mode(mode, cache)
    B, P, T, D4 = cache.shape
    D = D4 // 4
    kv = cache[:, phase]                                      # (B, T, 4D)
    if mode == "dma":
        return kv.float().sum(1)[:, :2 * D].to(q2.dtype)
    kv = kv.to(q2.dtype)
    outs = [_body_plain(mode, q2[:, s * D:(s + 1) * D],
                        kv[:, :, 2 * s * D:(2 * s + 1) * D],
                        kv[:, :, (2 * s + 1) * D:(2 * s + 2) * D],
                        kc2[:, s * D:(s + 1) * D], vc2[:, s * D:(s + 1) * D],
                        age, num_heads) for s in (0, 1)]
    return torch.cat(outs, dim=-1).to(q2.dtype)


def _check_mode(mode: str, cache: Tensor) -> None:
    if mode not in MODES:
        raise ValueError(f"attend_lab: mode {mode!r} not in {MODES}")
    if cache.dtype == torch.int8 and mode not in INT8_MODES:
        raise ValueError(f"attend_lab: an int8 cache takes the modes "
                         f"{INT8_MODES}, not {mode!r}")
    if mode == "q8glb" and cache.dtype != torch.int8:
        raise ValueError("attend_lab: q8glb reads int8 codes")


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("attend_lab")
    fn = lib.attend_lab_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    # mode, dtype, int8; cache, q, kc, vc, age, out; B, P, T, D, H, phase;
    # scale; streams; stream
    fn.argtypes = [I, I, I, P, P, P, P, P, P, I, I, I, I, I, I,
                   ctypes.c_float, I, P]
    return lib


def attend_lab(mode: str, cache: Tensor, q2: Tensor, kc2: Tensor,
               vc2: Tensor, age: Tensor, phase: int, *, num_heads: int = 4,
               streams: int = 1) -> Tensor:
    """The lab body `mode` over phase `phase` of the cache (arguments as
    `attend_lab_plain`); streams: streams per CUDA block, 1 or 2."""
    _check_mode(mode, cache)
    if cache.device.type == "cpu":
        return attend_lab_plain(mode, cache, q2, kc2, vc2, age, phase,
                                num_heads=num_heads)

    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"attend_lab: {msg}")

    check(cache.device.type == "cuda", f"unsupported device {cache.device}")
    B, P, T, D4 = cache.shape
    D = D4 // 4
    H = num_heads
    dtype = q2.dtype
    check(dtype in _DTYPES, f"q dtype {dtype} (float32 / bfloat16)")
    int8 = cache.dtype == torch.int8
    check(int8 or cache.dtype == dtype,
          f"cache dtype {cache.dtype}: q's dtype {dtype} or int8")
    check(D4 == 4 * D and D == 64 * H and 0 < H * streams <= 32
          and streams in (1, 2),
          f"needs D = 64 * heads, heads * streams <= 32, streams 1 or 2; "
          f"got D={D}, H={H}, streams={streams}")
    check(0 <= phase < P, f"phase {phase} outside the {P} phases")
    check(mode != "bf16exp" or 4 * streams * H * T <= 48 * 1024,
          f"bf16exp keeps T={T} scores per warp in shared memory")
    for t in (q2, kc2, vc2):
        check(tuple(t.shape) == (B, 2 * D) and t.dtype == dtype,
              f"q/kc/vc must be ({B}, {2 * D}) {dtype}")
    check(tuple(age.shape) == (B, T) and age.dtype == torch.float32,
          "age must be (B, T) float32")
    for t in (cache, q2, kc2, vc2, age):
        check(t.device == cache.device, "all tensors on one device")
        check(t.is_contiguous(), "all tensors contiguous")
    if mode in ("q8glb", "v5"):
        q2 = _prescaled(q2, D)
    out = torch.empty((B, 2 * D), dtype=dtype, device=cache.device)
    with torch.cuda.device(cache.device):
        rc = _lib().attend_lab_launch(
            MODES.index(mode), _DTYPES[dtype], int(int8), cache.data_ptr(),
            q2.data_ptr(), kc2.data_ptr(), vc2.data_ptr(), age.data_ptr(),
            out.data_ptr(), B, P, T, D, H, phase, 1.0 / math.sqrt(D),
            streams, torch.cuda.current_stream(cache.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attend_lab: kernel launch failed, cudaError "
                           f"{rc}")
    attend_lab.launches += 1
    return out


attend_lab.launches = 0
