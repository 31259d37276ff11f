"""Twin single-query KV-step attention: CUDA kernel wrapper + plain version.

`attend_pair` replaces the TPU kernel `fused_attend_pair`
(vap_realtime_tpu/ops/pallas/attend.py:454) in every form the serving
step reaches: the float bodies `_kernel_pair` (K1, ring rows only,
`slots="stream"/"global"`) and `_kernel_pair_st` (K2, ring + staged rows,
the `slots="staged"` serving default); the same bodies on int8 codes (K3,
`quant="global"`: the frozen scales are folded into q, k_cur, v_cur and
the output by the caller); and the per-row-scale bodies `_kernel_pair_q`
/ `_kernel_pair_stq` (K4, `quant="row"`).  With `impl="compact"` it
replaces the compact bodies `_kernel_pair_c` / `_kernel_pair_cq` (K10,
`attend_impl="pallas3"`, the port's `"kernel3"`): a max-shifted softmax
over the ring rows only; on an int8 cache it launches a body built for
Hopper (persistent blocks, one bulk copy of each stream's phase plane
into shared memory, compact per-head scores, one exp per row and head).
The kernels are in `vap_realtime_tpu_torch/csrc/attend_pair.cu`,
hand-written for Hopper; see its header for the design.

Bound on the H100: memory.  At B=4096, T=50, S=8 one launch reads the
phase plane and the stage slice: bf16 ~0.49 GB (~0.145 ms at 3.35 TB/s),
int8 ~0.25 GB (~0.078 ms); 7 launches per serving step.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `attend_pair_plain`, the same math in plain PyTorch (the
CPU tests use it; chip_smoke.py holds the kernel against it on the card).
`attend_pair.launches` counts the launches of the K1-K4 kernel,
`attend_pair.compact_launches` those of K10.

`fused_attend` replaces the TPU kernel `fused_attend`
(vap_realtime_tpu/ops/pallas/attend.py:396, body `_kernel`:311, K8): the
same v4 math for ONE k/v slot pair of one phase, float caches only, as a
one-set instance of the K1 body (B blocks).  Like the JAX package's, the
serving step does not call it.  Its plain version on the CPU is
`attend_reference` (the JAX package's einsum reference, attend.py:583);
`fused_attend_plain` is the v4 math of the kernel in plain PyTorch.
`fused_attend.launches` counts its launches.  Bound: bytes, half of K1's
(one k|v half-plane of the phase).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

DEAD = 1e9  # age marker of an invalid cache row: its weight is exactly 0
LOG2E = 1.4426950408889634  # scores are kept in log2 units (exp2)

Tensor = torch.Tensor


def _prescale(q2: Tensor, impl: str = "bcast") -> Tensor:
    """Fold the 1/sqrt(D) score scale and, for the bcast body's exp2
    softmax, the exp -> exp2 factor into q, with the factor rounded to q's
    dtype first (as the TPU kernel's wrapper does).  A Python scalar: no
    host-to-device copy."""
    c = (1.0 if impl == "compact" else LOG2E) / math.sqrt(q2.shape[-1])
    return q2 * torch.tensor(c, dtype=q2.dtype).item()


def _slopes(H: int, device, unit: float = LOG2E) -> Tensor:
    """Per-head AliBi slope m_h = 2^(-8(h+1)/H) * unit: log2 units by
    default, natural-log units with unit=1 (closed form for power-of-2 H,
    as in the TPU kernel)."""
    h = torch.arange(H, dtype=torch.float32, device=device)
    return torch.exp2(-8.0 * (h + 1.0) / H) * unit


def _fold(k: Tensor, v: Tensor, q: Tensor, kc: Tensor, age: Tensor,
          sc: Optional[Tensor], m: Tensor, H: int):
    """One row sequence of one twin set: k, v (B, L, D) in q's dtype; q,
    kc (B, D); age (B, L); sc (B, L) row scales or None.  Returns the
    sum of the unnormalised weights (B, H) and of the weighted values
    (B, H, Dh), both float32."""
    B, L, D = k.shape
    Dh = D // H
    if sc is None:
        # the current score folds into the shift: (k - kc) . q = s - s_cur
        s = ((k - kc[:, None]) * q[:, None]).float().view(B, L, H, Dh).sum(-1)
        arg = s - age[..., None] * m
    else:
        # row scales dequantise the cached score only: explicit s_cur
        s = (k * q[:, None]).float().view(B, L, H, Dh).sum(-1) * sc[..., None]
        s_cur = (kc * q).float().view(B, H, Dh).sum(-1)
        arg = s - age[..., None] * m - s_cur[:, None]
    w = torch.exp2(torch.clamp(arg, max=86.0))              # (B, L, H)
    denom = w.sum(1)
    if sc is not None:
        w = w * sc[..., None]           # fold the value dequant into w
    out = (w.to(q.dtype)[..., None] * v.view(B, L, H, Dh)).float().sum(1)
    return denom, out


IMPLS = ("bcast", "compact")


def _compact_plain(cache: Tensor, q2: Tensor, k_cur2: Tensor, v_cur2: Tensor,
                   age: Tensor, scale: Optional[Tensor], pair_base: int,
                   H: int) -> Tensor:
    """The compact body (K10) in plain PyTorch, with the rounding points
    of the TPU kernel's `_attend_math_compact` (ops/pallas/attend.py:201):
    q prescaled by 1/sqrt(D) rounded to q's dtype; codes cast to q's
    dtype; k * q in that dtype; per-head sums in float32, times the row
    scale; minus age * m_h (natural-log units); the softmax shifted by
    max(max_t s, s_cur); the denominator over the unscaled weights, the
    row scale folded into the weights after it; w / denom and w_cur /
    denom cast to v's dtype and weighted with v and v_cur in float32."""
    B, P, T, D4 = cache.shape
    D = q2.shape[-1]
    Dh = D // H
    ph = pair_base // 2
    dtype = q2.dtype
    q2 = _prescale(q2, "compact")
    m = _slopes(H, cache.device, 1.0)                       # (H,)
    outs = []
    for s in range(2):
        q, kc, vc = q2[:, s], k_cur2[:, s], v_cur2[:, s]
        k = cache[:, ph, :, 2 * s * D:(2 * s + 1) * D].to(dtype)
        v = cache[:, ph, :, (2 * s + 1) * D:(2 * s + 2) * D].to(dtype)
        sc = (k * q[:, None]).float().view(B, T, H, Dh).sum(-1)  # (B, T, H)
        if scale is not None:
            sc = sc * scale[..., None]
        sc = sc - age[..., None] * m
        s_cur = (kc * q).float().view(B, H, Dh).sum(-1)          # (B, H)
        mx = torch.maximum(sc.amax(1), s_cur)
        w = torch.exp(sc - mx[:, None])
        w_cur = torch.exp(s_cur - mx)
        denom = w.sum(1) + w_cur
        if scale is not None:
            w = w * scale[..., None]
        w = (w / denom[:, None]).to(dtype).float()
        w_cur = (w_cur / denom).to(dtype).float()
        out = (w[..., None] * v.float().view(B, T, H, Dh)).sum(1)
        out = out + w_cur[..., None] * vc.float().view(B, H, Dh)
        outs.append(out.reshape(B, D).to(dtype))
    return torch.stack(outs, dim=1)


def attend_pair_plain(cache: Tensor, q2: Tensor, k_cur2: Tensor,
                      v_cur2: Tensor, age: Tensor,
                      stage: Optional[Tensor] = None,
                      stage_age: Optional[Tensor] = None, *,
                      scale: Optional[Tensor] = None,
                      stage_scale: Optional[Tensor] = None,
                      pair_base: int, num_heads: int = 4,
                      impl: str = "bcast") -> Tensor:
    """Plain PyTorch version of the kernel: the v4 softmax of the TPU
    kernel's `_attend_math` (ops/pallas/attend.py:55), with its rounding
    points — cache codes cast to q's dtype, `(k - kc) * q` (or, with row
    scales, `k * q` and `kc * q`) in that dtype, head sums and softmax in
    float32, the denominator over the UNSCALED weights, `w * scale`
    rounded to q's dtype before `* v`, value sums in float32, v_cur added
    with weight 1.

    cache (B, P, T, 4D) float32 / bf16 / int8; q2/k_cur2/v_cur2 (B, 2, D);
    age (B, T) float32, DEAD for invalid rows; stage (S, B, P*4D) and
    stage_age (S, B) float32 for the staged slot policy, or None.  scale
    (B, T) and stage_scale (S, B) float32: the per-row dequant scales of
    THIS phase (int8 cache, quant="row"), or None.  Returns (B, 2, D) in
    q's dtype.  impl="compact": the compact body (`_compact_plain`), ring
    rows only.
    """
    _check_impl(impl, stage)
    if impl == "compact":
        return _compact_plain(cache, q2, k_cur2, v_cur2, age, scale,
                              pair_base, num_heads)
    B, P, T, D4 = cache.shape
    D = q2.shape[-1]
    H = num_heads
    ph = pair_base // 2
    dtype = q2.dtype
    q2 = _prescale(q2)
    m = _slopes(H, cache.device)                            # (H,)
    outs = []
    for s in range(2):
        q, kc, vc = q2[:, s], k_cur2[:, s], v_cur2[:, s]      # (B, D)
        k = cache[:, ph, :, 2 * s * D:(2 * s + 1) * D].to(dtype)  # (B, T, D)
        v = cache[:, ph, :, (2 * s + 1) * D:(2 * s + 2) * D].to(dtype)
        w_sum, out = _fold(k, v, q, kc, age, scale, m, H)
        denom = w_sum + 1.0                                 # w_cur == 1
        out = out + vc.float().view(B, H, -1)
        if stage is not None:
            col = ph * D4 + 2 * s * D
            ks = stage[:, :, col:col + D].transpose(0, 1).to(dtype)
            vs = stage[:, :, col + D:col + 2 * D].transpose(0, 1).to(dtype)
            w_sum, out_st = _fold(
                ks, vs, q, kc, stage_age.T, None if stage_scale is None
                else stage_scale.T, m, H)
            denom = denom + w_sum
            out = out + out_st
        outs.append((out / denom[..., None]).reshape(B, D).to(dtype))
    return torch.stack(outs, dim=1)


def _single_slot(cache: Tensor, slot_k: int, slot_v: int) -> int:
    """Checks the single-pair API's contract (a float cache, k and v in
    adjacent slots of one pair) and returns the pair's phase."""
    if cache.dtype == torch.int8:
        raise ValueError("fused_attend has no int8 dequant path; use "
                         "attend_pair(scale=...)")
    if slot_v != slot_k + 1 or slot_k % 2:
        raise ValueError(f"fused_attend: slots ({slot_k}, {slot_v}) must be "
                         f"a k/v pair (2p, 2p + 1): cache_layout stores k "
                         f"and v adjacently")
    return slot_k // 4


def attend_reference(cache: Tensor, q: Tensor, k_cur: Tensor, v_cur: Tensor,
                     age: Tensor, *, slot_k: int, slot_v: int,
                     num_heads: int = 4) -> Tensor:
    """Single-query attention over one k/v slot pair in einsum form (the
    JAX package's `attend_reference`, attend.py:583): scores in float32
    over q and k in their dtype, times 1/sqrt(D), plus -age * m_h (-inf
    for rows aged DEAD/2 or more), a softmax over the T rows and the
    current position, the weights cast to the cache dtype before the value
    sum.  cache (B, P, T, 4D); q, k_cur, v_cur (B, D); age (B, T) float32.
    Returns (B, D) in q's dtype."""
    B, P, T, _ = cache.shape
    D = q.shape[-1]
    H = num_heads
    Dh = D // H
    ck, cv = (slot_k % 4) * D, (slot_v % 4) * D
    k_old = cache[:, slot_k // 4, :, ck:ck + D]
    v_old = cache[:, slot_v // 4, :, cv:cv + D]
    qh = q.reshape(B, H, Dh)
    scale = 1.0 / math.sqrt(D)
    slopes = _slopes(H, cache.device, 1.0)
    s_old = torch.einsum("bhd,bthd->bht", qh.float(),
                         k_old.reshape(B, T, H, Dh).float()) * scale
    bias = torch.where((age < DEAD / 2)[:, None, :],
                       -age[:, None, :] * slopes[None, :, None],
                       float("-inf"))
    s_cur = (qh * k_cur.reshape(B, H, Dh)).float().sum(-1, keepdim=True)
    w = torch.softmax(torch.cat([s_old + bias, s_cur * scale], -1), -1)
    out = (torch.einsum("bht,bthd->bhd", w.to(cache.dtype)[:, :, :T].float(),
                        v_old.reshape(B, T, H, Dh).float())
           + w[:, :, T:] * v_cur.reshape(B, H, Dh).float())
    return out.reshape(B, D).to(q.dtype)


def fused_attend_plain(cache: Tensor, q: Tensor, k_cur: Tensor,
                       v_cur: Tensor, age: Tensor, *, slot_k: int,
                       slot_v: int, num_heads: int = 4) -> Tensor:
    """The kernel's v4 math for one k/v slot pair in plain PyTorch, with
    its rounding points (those of `attend_pair_plain` for one set)."""
    ph = _single_slot(cache, slot_k, slot_v)
    B, D = q.shape
    off = (slot_k % 4) * D
    dtype = q.dtype
    k = cache[:, ph, :, off:off + D].to(dtype)
    v = cache[:, ph, :, off + D:off + 2 * D].to(dtype)
    w_sum, out = _fold(k, v, _prescale(q), k_cur, age, None,
                       _slopes(num_heads, cache.device), num_heads)
    out = out + v_cur.float().view(B, num_heads, -1)
    return (out / (w_sum + 1.0)[..., None]).reshape(B, D).to(dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2  # cache / stage element code of an int8 cache


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    from vap_realtime_tpu_torch.ops.cuda.build import load

    return bind(load("attend_pair"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of attend_pair.cu."""
    fn = lib.attend_pair_launch
    fn.restype = ctypes.c_int
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, I, P, P, P, P, P, P, L, P, P, P, L, L, P,
                   I, I, I, I, I, I, I, P]
    fc = lib.attend_compact_launch
    fc.restype = ctypes.c_int
    fc.argtypes = [I, I, P, P, P, P, P, P, L, P, I, I, I, I, I, I, P]
    f1 = lib.attend_single_launch
    f1.restype = ctypes.c_int
    # dtype; cache, q, k_cur, v_cur, age, out; B, P, T, D, H, phase,
    # half; stream
    f1.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
    return lib


def _check(cond: bool, msg: str, who: str = "attend_pair") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_impl(impl: str, stage: Optional[Tensor]) -> None:
    _check(impl in IMPLS, f"impl {impl!r} not in {IMPLS}")
    _check(impl == "bcast" or stage is None,
           "staged rows: the bcast body only (the compact body has no "
           "staged form)")


def attend_pair(cache: Tensor, q2: Tensor, k_cur2: Tensor, v_cur2: Tensor,
                age: Tensor, stage: Optional[Tensor] = None,
                stage_age: Optional[Tensor] = None, *,
                scale: Optional[Tensor] = None,
                stage_scale: Optional[Tensor] = None, pair_base: int,
                num_heads: int = 4, impl: str = "bcast") -> Tensor:
    """TWO single-query attentions (the twin channels / towers of one
    layer phase) over ONE contiguous cache plane, in one launch.

    Same argument meaning as the TPU `fused_attend_pair`: set s of
    q2/k_cur2/v_cur2 reads cache pair `pair_base + s`, i.e. phase
    pair_base // 2, columns [2sD, (2s+2)D).  A float cache has q's dtype;
    an int8 cache holds codes, read as they are (quant="global", scales
    folded by the caller) or dequantised by `scale` (B, T) and, with a
    stage, `stage_scale` (S, B): float32 row scales of this phase, which
    may be strided views (the last dim of `scale` contiguous).  Stage ages
    are (S, B) float32 (the TPU kernel took them lane-broadcast in the
    state dtype, a Mosaic layout constraint).  Ages and liveness are
    computed by the caller.  impl="compact" launches the compact body
    (K10): ring rows only, a stage raises.
    """
    _check_impl(impl, stage)
    if cache.device.type == "cpu":
        return attend_pair_plain(cache, q2, k_cur2, v_cur2, age, stage,
                                 stage_age, scale=scale,
                                 stage_scale=stage_scale,
                                 pair_base=pair_base, num_heads=num_heads,
                                 impl=impl)
    _check(cache.device.type == "cuda",
           f"unsupported device {cache.device}")
    B, P, T, D4 = cache.shape
    D = q2.shape[-1]
    H = num_heads
    dtype = q2.dtype
    _check(dtype in _DTYPES, f"q dtype {dtype} (float32 / bfloat16)")
    int8 = cache.dtype == torch.int8
    _check(int8 or cache.dtype == dtype,
           f"cache dtype {cache.dtype}: q's dtype {dtype} or int8")
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
        _check(tuple(stage.shape) == (S, B, P * D4)
               and stage.dtype == cache.dtype,
               f"stage must be (S, {B}, {P * D4}) {cache.dtype}")
        _check(stage_age is not None and tuple(stage_age.shape) == (S, B)
               and stage_age.dtype == torch.float32,
               "stage_age must be (S, B) float32")
        tensors += [stage, stage_age]
    for t in tensors:
        _check(t.device == cache.device, "all tensors on one device")
        _check(t.is_contiguous(), "all tensors contiguous")
    strides = [0, 0, 0]
    if scale is not None:
        _check(int8, "row scales need an int8 cache")
        _check(tuple(scale.shape) == (B, T) and scale.dtype == torch.float32
               and scale.stride(1) == 1 and scale.device == cache.device,
               "scale must be (B, T) float32, last dim contiguous")
        _check((stage_scale is not None) == bool(S),
               "row scales with a stage need stage_scale, and only then")
        strides[0] = scale.stride(0)
        if S:
            _check(tuple(stage_scale.shape) == (S, B)
                   and stage_scale.dtype == torch.float32
                   and stage_scale.device == cache.device,
                   "stage_scale must be (S, B) float32")
            strides[1:] = stage_scale.stride()
    else:
        _check(stage_scale is None, "stage_scale needs scale")
    out = torch.empty((B, 2, D), dtype=dtype, device=cache.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    q2 = _prescale(q2, impl)
    if impl == "compact":
        if int8:  # the bulk-copy body
            _check(H & (H - 1) == 0, f"the int8 compact body needs a "
                                     f"power-of-2 head count, got {H}")
            _check(all(t.data_ptr() % 16 == 0 for t in
                       (cache, q2, k_cur2, v_cur2)),
                   "the int8 compact body needs cache, q, k_cur and v_cur "
                   "16-byte aligned")
        with torch.cuda.device(cache.device):
            rc = _lib().attend_compact_launch(
                _DTYPES[dtype], _INT8 if int8 else _DTYPES[dtype],
                cache.data_ptr(), q2.data_ptr(), k_cur2.data_ptr(),
                v_cur2.data_ptr(), age.data_ptr(), ptr(scale), strides[0],
                out.data_ptr(), B, P, T, D, H, pair_base // 2,
                torch.cuda.current_stream(cache.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"attend_pair: compact kernel launch failed, "
                               f"cudaError {rc}")
        attend_pair.compact_launches += 1
        return out
    with torch.cuda.device(cache.device):
        rc = _lib().attend_pair_launch(
            _DTYPES[dtype], _INT8 if int8 else _DTYPES[dtype],
            cache.data_ptr(), q2.data_ptr(), k_cur2.data_ptr(),
            v_cur2.data_ptr(), age.data_ptr(), ptr(scale), strides[0],
            ptr(stage) if S else None, ptr(stage_age) if S else None,
            ptr(stage_scale) if S else None, strides[1], strides[2],
            out.data_ptr(), B, P, T, D, H, S, pair_base // 2,
            torch.cuda.current_stream(cache.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attend_pair: kernel launch failed, "
                           f"cudaError {rc}")
    attend_pair.launches += 1
    return out


attend_pair.launches = 0
attend_pair.compact_launches = 0


def fused_attend(cache: Tensor, q: Tensor, k_cur: Tensor, v_cur: Tensor,
                 age: Tensor, *, slot_k: int, slot_v: int,
                 num_heads: int = 4) -> Tensor:
    """Single-query attention over ONE k/v slot pair of the phase-major
    cache (the TPU `fused_attend`): global slot s lives in phase s // 4,
    column (s % 4) * D.  cache (B, P, T, 4D) in q's dtype (an int8 cache
    raises: this API has no dequant path); q, k_cur, v_cur (B, D); age
    (B, T) float32, DEAD for invalid rows.  Returns (B, D)."""
    ph = _single_slot(cache, slot_k, slot_v)
    check = functools.partial(_check, who="fused_attend")
    if cache.device.type == "cpu":
        return attend_reference(cache, q, k_cur, v_cur, age, slot_k=slot_k,
                                slot_v=slot_v, num_heads=num_heads)
    check(cache.device.type == "cuda", f"unsupported device {cache.device}")
    B, P, T, D4 = cache.shape
    D = q.shape[-1]
    H = num_heads
    dtype = q.dtype
    check(dtype in _DTYPES and cache.dtype == dtype,
           f"q and cache: one dtype, float32 / bfloat16 (got {dtype}, "
           f"{cache.dtype})")
    check(D4 == 4 * D and D == 64 * H and 0 < H <= 32,
           f"needs D = 64 * heads and a (.., 4D) cache; got D={D}, H={H}, "
           f"cache {tuple(cache.shape)}")
    check(ph < P, f"slot {slot_k} outside the {P} phases")
    for t in (q, k_cur, v_cur):
        check(tuple(t.shape) == (B, D) and t.dtype == dtype,
               f"q/k_cur/v_cur must be ({B}, {D}) {dtype}")
    check(tuple(age.shape) == (B, T) and age.dtype == torch.float32,
           "age must be (B, T) float32")
    for t in (q, k_cur, v_cur, age):
        check(t.device == cache.device, "all tensors on one device")
    for t in (cache, q, k_cur, v_cur, age):
        check(t.is_contiguous(), "all tensors contiguous")
    out = torch.empty((B, D), dtype=dtype, device=cache.device)
    qs = _prescale(q)
    with torch.cuda.device(cache.device):
        rc = _lib().attend_single_launch(
            _DTYPES[dtype], cache.data_ptr(), qs.data_ptr(),
            k_cur.data_ptr(), v_cur.data_ptr(), age.data_ptr(),
            out.data_ptr(), B, P, T, D, H, ph, (slot_k % 4) // 2,
            torch.cuda.current_stream(cache.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_attend: kernel launch failed, "
                           f"cudaError {rc}")
    fused_attend.launches += 1
    return out


fused_attend.launches = 0
