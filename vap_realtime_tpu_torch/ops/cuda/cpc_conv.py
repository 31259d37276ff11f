"""The chunked CPC encoder's conv tail (conv1..conv4, each followed by
ChannelNorm + ReLU): CUDA kernel wrapper + plain version.

`cpc_conv_tail` replaces the TPU kernel `cpc_conv_tail`
(vap_realtime_tpu/ops/pallas/cpc_conv.py:108, body `_tail_kernel`:89):
the padded, non-streaming conv1-4 of the chunked encoder
(`models.encoder.cpc_conv_stack`) on conv0's normalised and ReLU'd output,
time-major, everything in float32 inside.  Like the JAX package's, the
serving paths do not call it: it is the drop-in for conv1-4 of
`cpc_conv_stack`.  The kernel is
`vap_realtime_tpu_torch/csrc/cpc_conv_tail.cu`, hand-written for Hopper:
one launch per layer, each an implicit GEMM on the tensor cores in
3xTF32 (float32 accuracy from three TF32 MMAs, `ops/cuda/tf32.py`), a
block holding whole channel-streams over all 256 output channels so the
ChannelNorm + ReLU epilogue stays in the block; see its header.

Bound on the H100: operations.  At 2B = 8192 channel-streams and L0 = 224
(20 Hz): 0.69 TFLOP of float32 products, 10.3 ms at 67 TFLOP/s on the
CUDA cores; as 3xTF32 2.07 TFLOP of TF32, 4.19 ms at 495 TFLOP/s (3.22
ms with a bf16 x0, whose conv1 needs two passes); x0 is 1.88 GB in
float32 (0.56 ms at 3.35 TB/s).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `cpc_conv_tail_plain`.  `cpc_conv_tail.launches` counts
calls (four kernel launches each).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# (kernel, stride, padding) of conv1..conv4 (encoder_components.py:85-92)
TAIL_SPECS = ((8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tail_out_len(L0: int) -> List[int]:
    """Output lengths after each tail conv given conv0's output length."""
    lens = []
    L = L0
    for k, s, p in TAIL_SPECS:
        L = (L + 2 * p - k) // s + 1
        lens.append(L)
    return lens


def pack_tail_params(enc_params: Dict[str, Any]) -> Tuple[Tensor, ...]:
    """Encoder params -> the flat tail tuple (w1..w4, b1..b4, nw1..nw4,
    nb1..nb4) of `cpc_conv_tail`: conv weights (C_out, C_in, k) become
    tap-major (k, C_in, C_out), ChannelNorm affines (C, 1) become (C,)."""
    ws, bs, nws, nbs = [], [], [], []
    for li in range(1, 5):
        ws.append(enc_params[f"conv{li}"]["w"].permute(2, 1, 0).contiguous())
        bs.append(enc_params[f"conv{li}"]["b"])
        nws.append(enc_params[f"norm{li}"]["w"][:, 0])
        nbs.append(enc_params[f"norm{li}"]["b"][:, 0])
    return tuple(ws + bs + nws + nbs)


def _phase_conv(x: Tensor, w_taps: Tensor, b: Tensor, k: int, s: int,
                p: int, L_out: int, matmul=torch.matmul) -> Tensor:
    """One padded strided conv, time-major: x (B, L, C) -> (B, L_out, C)
    = b + sum_i x[s t + i - p] @ w_taps[i], the taps summed in order as
    the TPU kernel's `_phase_conv`."""
    xp = F.pad(x, (0, 0, p, p + s))            # zero rows outside [0, L)
    out = b.expand(x.shape[0], L_out, -1)
    for i in range(k):
        out = out + matmul(xp[:, i:i + s * (L_out - 1) + 1:s], w_taps[i])
    return out


def _channel_norm_relu(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """ChannelNorm over the last (channel) axis, the centred two-pass
    unbiased variance, eps 1e-5, the affine in float32, then ReLU."""
    mean = x.mean(-1, keepdim=True)
    cent = x - mean
    var = (cent * cent).sum(-1, keepdim=True) / (x.shape[-1] - 1)
    return torch.relu(cent * torch.rsqrt(var + 1e-5) * w + b)


def cpc_conv_tail_plain(x0: Tensor, tail_params: Tuple[Tensor, ...],
                        matmul=torch.matmul) -> Tensor:
    """Plain PyTorch version of the kernel, with its rounding points: x0
    and the weights cast to float32, float32 products and sums, the
    activations between layers in float32, the output cast to x0's dtype.
    A float64 x0 runs everything in float64 (a reference for the
    rounding); `matmul` takes each tap's product (the tests pass
    `tf32.matmul_3xtf32`).  x0 (B, L0, C); returns (B, L4, C)."""
    ct = torch.float64 if x0.dtype == torch.float64 else torch.float32
    f = [t.to(ct) for t in tail_params]
    ws, bs, nws, nbs = f[0:4], f[4:8], f[8:12], f[12:16]
    x = x0.to(ct)
    for li, ((k, s, p), L) in enumerate(zip(TAIL_SPECS,
                                            tail_out_len(x0.shape[1]))):
        x = _phase_conv(x, ws[li], bs[li], k, s, p, L, matmul)
        x = _channel_norm_relu(x, nws[li], nbs[li])
    return x.to(x0.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    from vap_realtime_tpu_torch.ops.cuda.build import load

    lib = load("cpc_conv_tail")
    fn = lib.cpc_conv_tail_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    # dtype; x0, W, aux, out; y1, y2, y3 (scratch); N, L0, C; stream
    fn.argtypes = [I, P, P, P, P, P, P, P, I, I, I, P]
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"cpc_conv_tail: {msg}")


def cpc_conv_tail(x0: Tensor, tail_params: Tuple[Tensor, ...]) -> Tensor:
    """conv1..conv4 (+ ChannelNorm + ReLU each), one kernel launch per
    layer.

    x0: (B, L0, 256) conv0's normalised and ReLU'd output, time-major,
    float32 or bf16; tail_params: `pack_tail_params`'s tuple (any float
    dtype; used in float32).  Returns (B, L4, 256) in x0's dtype."""
    _check(len(tail_params) == 16, "tail_params: 16 tensors "
           "(w1..w4, b1..b4, nw1..nw4, nb1..nb4)")
    if x0.device.type == "cpu":
        return cpc_conv_tail_plain(x0, tail_params)
    _check(x0.device.type == "cuda", f"unsupported device {x0.device}")
    _check(x0.dim() == 3 and x0.shape[2] == 256 and x0.shape[0] > 0,
           f"x0 must be (B, L0, 256), got {tuple(x0.shape)}")
    _check(x0.dtype in _DTYPES, f"x0 dtype {x0.dtype} (float32 / bfloat16)")
    B, L0, C = x0.shape
    lens = tail_out_len(L0)
    _check(lens[-1] > 0, f"L0 = {L0} is too short for four convs")
    for li, (k, _, _) in enumerate(TAIL_SPECS):
        _check(tuple(tail_params[li].shape) == (k, C, C),
               f"w{li + 1} must be ({k}, {C}, {C})")
        for j in (4, 8, 12):
            _check(tail_params[j + li].numel() == C,
                   f"bias / norm parameters of layer {li + 1} must be ({C},)")
    for t in tail_params:
        _check(t.device == x0.device, "all tensors on one device")
    # the taps of conv1..4, input channels in pairs: (20, C / 2, C, 2)
    W = (torch.cat([w.float().reshape(-1, C, C) for w in tail_params[:4]])
         .reshape(-1, C // 2, 2, C).transpose(2, 3).contiguous())
    aux = torch.stack([t.float().reshape(C) for li in range(4)
                       for t in tail_params[4 + li::4]])
    x = x0.contiguous()
    out = torch.empty((B, lens[-1], C), dtype=x0.dtype, device=x0.device)
    # conv1..conv3's outputs stay float32 between the launches
    ys = [torch.empty((B, L, C), dtype=torch.float32, device=x0.device)
          for L in lens[:3]]
    with torch.cuda.device(x0.device):
        rc = _lib().cpc_conv_tail_launch(
            _DTYPES[x0.dtype], x.data_ptr(), W.data_ptr(), aux.data_ptr(),
            out.data_ptr(), *(y.data_ptr() for y in ys), B, L0, C,
            torch.cuda.current_stream(x0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cpc_conv_tail: kernel launch failed, "
                           f"cudaError {rc}")
    cpc_conv_tail.launches += 1
    return out


cpc_conv_tail.launches = 0
