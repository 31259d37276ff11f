"""Fused short-sequence LSTM scan: CUDA kernel wrapper + plain version.

`lstm_scan` replaces the TPU kernel `lstm_scan`
(vap_realtime_tpu/ops/pallas/lstm.py:48, body `_lstm_kernel`:26): the
recurrence of the CPC context net's 1-layer LSTM over precomputed input
gates, T = 100 // frame_hz steps (5 at 20 Hz), gates i, f, g, o, float32
math.  `lstm_fused` is the drop-in for `ops.basic.lstm` (the counterpart
of `lstm_pallas`:95); like the JAX package's, the serving step does not
call it.  The kernel is `vap_realtime_tpu_torch/csrc/lstm_scan.cu`,
hand-written for Hopper: 64 streams a block, the step's product h W_hh^T
on the tensor cores in 3xTF32 (float32 accuracy from three TF32 MMAs,
`ops/cuda/tf32.py`), W_hh^T streamed through shared memory with its gate
columns interleaved by `pack_w_hh` so one shuffle gives a lane all four
gates of its cells; see its header.

Bound on the H100: operations.  At 2B = 8192 channel-streams, T = 5,
H = 256: 21.5 GFLOP of float32 recurrent matmuls (0.32 ms at 67 TFLOP/s
on the CUDA cores; as 3xTF32 64.4 GFLOP of TF32, 0.13 ms at 495
TFLOP/s); the bytes (gates in, outputs, 1 MB of weights) are ~0.12 GB
(0.036 ms at 3.35 TB/s).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `lstm_scan_plain`.  `lstm_scan.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lstm_scan_plain(gi_seq: Tensor, h0: Tensor, c0: Tensor, w_hh_t: Tensor,
                    b_hh: Tensor, matmul=torch.matmul):
    """Plain PyTorch version of the kernel, with its rounding points:
    h, c, W_hh^T and the bias in float32; g = (gi[t] + b_hh) + h @ W_hh^T;
    c = f c + i gg, h = o tanh(c); ys in gi's dtype, h_T and c_T in
    h0's.  A float64 h0 runs everything in float64 (a reference for the
    rounding); `matmul` takes the step's product (the tests pass
    `tf32.matmul_3xtf32`).  gi_seq (B, T, 4H); h0, c0 (B, H); w_hh_t
    (H, 4H); b_hh (4H,).  Returns (ys (B, T, H), h_T, c_T)."""
    H = h0.shape[-1]
    ct = torch.float64 if h0.dtype == torch.float64 else torch.float32
    h, c = h0.to(ct), c0.to(ct)
    w, b = w_hh_t.to(ct), b_hh.to(ct)
    ys = []
    for t in range(gi_seq.shape[1]):
        g = gi_seq[:, t].to(ct) + b
        g = g + matmul(h, w)
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        gg = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        ys.append(h.to(gi_seq.dtype))
    return torch.stack(ys, dim=1), h.to(h0.dtype), c.to(c0.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    from vap_realtime_tpu_torch.ops.cuda.build import load

    lib = load("lstm_scan")
    fn = lib.lstm_scan_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    # gi dtype, h dtype; gi, h0, c0, w_packed, b_hh; ys, h_T, c_T; hx; B,
    # T, H; stream
    fn.argtypes = [I, I, P, P, P, P, P, P, P, P, P, I, I, I, P]
    return lib


@functools.lru_cache(maxsize=None)
def _pass_columns(H: int, device: torch.device) -> Tensor:
    """(4, H) on `device`, made once (a copy to the card on every call
    would stall the host): the W_hh^T column (gate * H + unit) of column
    j of pass p in the kernel's order.  Column j = 32 w + 8 nt + 2 q + e
    of a pass is what the MMA puts in lane q's accumulator e of column
    tile nt of warp group w: gate 2 (q & 1) + e of unit 64 p + 8 w + 4 (q
    >> 1) + nt.  So lanes q and q ^ 1 share a unit (one shuffle gives a
    lane all four gates) and a lane's four column tiles are four
    consecutive units."""
    cols = []
    for p in range(4):
        for j in range(H):
            w, r = divmod(j, 32)
            nt, r = divmod(r, 8)
            q, e = divmod(r, 2)
            unit = 64 * p + 8 * w + 4 * (q >> 1) + nt
            cols.append((2 * (q & 1) + e) * H + unit)
    return torch.tensor(cols, device=device).view(4, H)


def pack_w_hh(w_hh_t: Tensor) -> Tensor:
    """W_hh^T (H, 4H), gate-major columns (i, f, g, o) -> the kernel's
    four column passes (4, H / 2, H, 2) float32 (H = 256): pass p holds
    the four gates of units 64 p .. 64 p + 63 in `_pass_columns` order,
    and its K rows go in pairs (row k at [p, k // 2, :, k % 2]) so a
    lane's two B values are one load."""
    H = w_hh_t.shape[0]
    cols = _pass_columns(H, w_hh_t.device).reshape(-1)
    w = w_hh_t.float()[:, cols].reshape(H // 2, 2, 4, H)  # (k//2, k%2, p, j)
    return w.permute(2, 0, 3, 1).contiguous()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lstm_scan: {msg}")


def lstm_scan(gi_seq: Tensor, h0: Tensor, c0: Tensor, w_hh_t: Tensor,
              b_hh: Tensor):
    """Fused LSTM over precomputed input gates.

    gi_seq: (B, T, 4H) = x @ W_ih.T + b_ih; h0, c0: (B, H); w_hh_t:
    (H, 4H), the TRANSPOSED recurrent weights; b_hh: (4H,).  gi and h0/c0
    are float32 or bf16 (each its own); H = 256.  Returns (ys (B, T, H)
    in gi's dtype, h_T, c_T in h0's)."""
    if gi_seq.device.type == "cpu":
        return lstm_scan_plain(gi_seq, h0, c0, w_hh_t, b_hh)
    _check(gi_seq.device.type == "cuda", f"unsupported device "
           f"{gi_seq.device}")
    B, T, H4 = gi_seq.shape
    H = H4 // 4
    _check(H == 256 and H4 == 4 * H, f"needs H = 256, got gates {H4}")
    _check(B > 0 and T > 0, "empty input")
    _check(gi_seq.dtype in _DTYPES and h0.dtype in _DTYPES
           and c0.dtype == h0.dtype, "gi, h0, c0: float32 or bfloat16 "
           "(c0 as h0)")
    _check(tuple(h0.shape) == (B, H) and tuple(c0.shape) == (B, H),
           f"h0, c0 must be ({B}, {H})")
    _check(tuple(w_hh_t.shape) == (H, H4) and b_hh.numel() == H4,
           f"w_hh_t must be ({H}, {H4}), b_hh ({H4},)")
    w = pack_w_hh(w_hh_t)
    b = b_hh.float().reshape(H4).contiguous()
    gi, h0c, c0c = gi_seq.contiguous(), h0.contiguous(), c0.contiguous()
    for t in (h0c, c0c, w, b):
        _check(t.device == gi.device, "all tensors on one device")
    ys = torch.empty((B, T, H), dtype=gi.dtype, device=gi.device)
    h_t = torch.empty_like(h0c)
    c_t = torch.empty_like(c0c)
    hx = torch.empty((B, H), dtype=torch.float32, device=gi.device)  # h_t
    with torch.cuda.device(gi.device):
        rc = _lib().lstm_scan_launch(
            _DTYPES[gi.dtype], _DTYPES[h0c.dtype], gi.data_ptr(),
            h0c.data_ptr(), c0c.data_ptr(), w.data_ptr(), b.data_ptr(),
            ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), hx.data_ptr(),
            B, T, H,
            torch.cuda.current_stream(gi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_scan: kernel launch failed, cudaError {rc}")
    lstm_scan.launches += 1
    return ys, h_t, c_t


lstm_scan.launches = 0


def lstm_fused(x: Tensor, h0: Tensor, c0: Tensor, w_ih: Tensor,
               w_hh: Tensor, b_ih: Tensor, b_hh: Tensor):
    """Drop-in for ops.basic.lstm through the fused scan: the input
    projection x @ W_ih.T + b_ih runs once outside the kernel.  x
    (B, T, in); h0, c0 (B, H).  Returns (ys (B, T, H), h_T, c_T)."""
    gi = torch.matmul(x, w_ih.T) + b_ih
    return lstm_scan(gi, h0, c0, w_hh.T, b_hh)
