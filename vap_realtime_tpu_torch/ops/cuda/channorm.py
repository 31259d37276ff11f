"""One-pass ChannelNorm + ReLU: CUDA kernel wrapper + plain version.

`channel_norm_relu` replaces the TPU kernel `channel_norm_relu`
(vap_realtime_tpu/ops/pallas/channorm.py:43, body `_kernel`:29), reached
through `conv_impl="normk"`: relu(ChannelNorm(x)) between the CPC convs,
reading each NCW activation once and writing it once.  The kernel is
`vap_realtime_tpu_torch/csrc/channel_norm_relu.cu`, hand-written for
Hopper; see its header for the design.

Bound on the H100: memory.  At N = 8192 channel-streams (B = 4096),
bf16, the five conv outputs (T = 160, 40, 20, 10, 5) are read and
written once: 1.97 GB, ~0.59 ms per step at 3.35 TB/s.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `channel_norm_relu_plain`.  `channel_norm_relu.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vap_realtime_tpu_torch.ops.basic import channel_norm

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHANNELS = (64, 128, 256)


def channel_norm_relu_plain(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """relu(channel_norm(x, w, b)) with the affine in x's dtype, as the
    TPU kernel casts w and b: float32 sum / sum of squares, unbiased
    clamped variance, eps 1e-5, normalised in float32 and cast to x's
    dtype before the affine.  x (N, C, T); w, b (C, 1)."""
    return torch.relu(channel_norm(x, w.to(x.dtype), b.to(x.dtype)))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    from vap_realtime_tpu_torch.ops.cuda.build import load

    lib = load("channel_norm_relu")
    fn = lib.channel_norm_relu_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, I, I, I, P]
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"channel_norm_relu: {msg}")


def channel_norm_relu(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """relu(ChannelNorm(x)) in one read and one write of x.

    x: (N, C, T) NCW activation, float32 or bf16, contiguous, C in
    (64, 128, 256); w, b: the (C, 1) ChannelNorm affine (cast to x's
    dtype).  Returns a new (N, C, T) tensor of x's dtype.
    """
    if x.device.type == "cpu":
        return channel_norm_relu_plain(x, w, b)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(x.dim() == 3, f"x must be (N, C, T), got {tuple(x.shape)}")
    N, C, T = x.shape
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} (float32 / bfloat16)")
    _check(C in _CHANNELS, f"C = {C} not in {_CHANNELS}")
    _check(N > 0 and T > 0, "empty input")
    _check(x.is_contiguous(), "x must be contiguous")
    _check(w.numel() == C and b.numel() == C, "w, b must hold C values")
    _check(w.device == x.device and b.device == x.device,
           "all tensors on one device")
    w = w.to(x.dtype).reshape(C).contiguous()
    b = b.to(x.dtype).reshape(C).contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().channel_norm_relu_launch(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), N, C, T,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"channel_norm_relu: kernel launch failed, "
                           f"cudaError {rc}")
    channel_norm_relu.launches += 1
    return out


channel_norm_relu.launches = 0
