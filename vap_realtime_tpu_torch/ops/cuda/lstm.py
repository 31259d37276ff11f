"""Fused LSTM scan: CUDA kernel wrapper + plain version.

`lstm_scan` replaces the TPU kernel `lstm_scan`
(vap_realtime_tpu/ops/pallas/lstm.py:48, body `_lstm_kernel`:26): the
recurrence of the CPC context net's 1-layer LSTM over precomputed input
gates, gates i, f, g, o, float32 math.  `lstm_fused` is the drop-in for
`ops.basic.lstm` (the counterpart of `lstm_pallas`:95); like the JAX
package's, the serving step does not call it (it takes `lstm_serve`,
below); the training encoder (`models/encoder.py` `encode_sequence`)
does, at (16, 1998, 256) for 8 stereo 20 s clips.  The kernel is
`vap_realtime_tpu_torch/csrc/lstm_scan.cu`, hand-written for Hopper, the
step's product h W_hh^T on the tensor cores in 3xTF32 (float32 accuracy
from three TF32 MMAs, `ops/cuda/tf32.py`), with two bodies (see its
header):

- the serving body: 64 streams a block, W_hh^T streamed from L2 through
  shared memory every step, its gate columns interleaved by `pack_w_hh`
  so one shuffle gives a lane all four gates of its cells;
- the sequence body, for long sequences at small batch: 16 streams a
  thread-block cluster of 16 blocks (8 at larger B, `_cluster`), each
  block owning 256 / cluster units' four gates (`pack_w_hh_seq`) with its
  slice of W_hh^T resident in shared memory for all T steps, h_t sent to
  every block of the cluster through distributed shared memory
  (`st.async`), each block waiting on its own mbarrier.

`_body(B, at_once)` picks the body from the batch and how many blocks or
clusters the card runs at once (`_at_once`), by the crossover measured on
the card (PERF.md); there is no option for it.  Each body has its own
launch function (`_launch_serving`, `_launch_sequence`), which
`chip_smoke.py` also calls to hold both against the plain version.

Bound on the H100: operations, 2 T B H 4H float32 FLOP (as 3xTF32, three
times that in TF32 at 495 TFLOP/s): 0.13 ms at (8192, 5, 256), 0.10 ms at
(16, 1998, 256); the sequence body is bound in practice by the latency of
its ~2,000 dependent steps, not by either.

On a CUDA tensor the wrapper launches a body or raises (a cluster that
does not fit raises too; nothing falls back); on a CPU tensor it runs
`lstm_scan_plain`.  `lstm_scan.launches` counts kernel launches,
`lstm_scan.serving_launches` and `lstm_scan.sequence_launches` each
body's.

`lstm_serve` is the serving LSTM in bf16 (the CPC context net of
`models/encoder.py` `cpc_context` on CUDA bf16 tensors: 100 / frame_hz
steps a frame), one launch of `vap_realtime_tpu_torch/csrc/lstm_serve.cu`
for all T steps.  It replaces no TPU kernel (the JAX serving step runs
the LSTM as XLA ops).  Input projection and recurrence are one product
G = [x_t | h] [W_ih | W_hh]^T + (b_ih + b_hh) a step on the tensor cores
(wgmma, bf16 operands, float32 accumulation); gates and c stay float32 in
registers, h is rounded to bf16 once a step.  `pack_w_serve` packs the
weights so a thread holds all four gates of its cells.  Bound on the
H100: operations, 2 T B 512 1024 bf16 FLOP at 989 TFLOP/s (1.78 ms at
(83,968, 20), 0.27 ms at (51,200, 5)).  On a CUDA tensor it launches or
raises; on a CPU tensor it runs `lstm_serve_plain`.
`lstm_serve.launches` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Any, Dict

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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a built `lstm_scan.cu` (or a variant of
    it, `tools/k5_ablate.py`) on `lib`; returns it."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.lstm_scan_launch
    fn.restype = ctypes.c_int
    # gi dtype, h dtype; gi, h0, c0, w_packed, b_hh; ys, h_T, c_T; hx; B,
    # T, H; stream
    fn.argtypes = [I, I, P, P, P, P, P, P, P, P, P, I, I, I, P]
    seq = lib.lstm_seq_launch
    seq.restype = ctypes.c_int
    # the same without hx, then cluster; stream; max_clusters
    seq.argtypes = [I, I, P, P, P, P, P, P, P, P, I, I, I, I, P, P]
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    from vap_realtime_tpu_torch.ops.cuda.build import load

    return bind(load("lstm_scan"))


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


# The sequence body: streams a cluster; per cluster size, the K slices of
# a block's product (csrc `SeqShape::kKSplit`: the reduction order the
# tests replay).
SEQ_ROWS = 16
SEQ_K_SPLITS = {8: 4, 16: 8}
# Each body's time a step for one wave, measured on an H100 (NVIDIA H100
# 80GB HBM3, 700 W; `tools/lstm_bodies.py`, PERF.md): key ("serving", or
# the sequence body's cluster size) -> (microseconds a step, streams a
# block or cluster).  How many blocks or clusters run at once is the
# card's (`_at_once`).
_STEP_MODEL = {"serving": (104.0, 64), 8: (4.2, SEQ_ROWS),
               16: (2.55, SEQ_ROWS)}


def _waves_us(key, B: int, at_once: dict) -> float:
    """Microseconds a step of body `key` at B streams on a card that runs
    at_once[key] of its blocks (serving) or clusters together: a wave's
    step x waves."""
    step, rows = _STEP_MODEL[key]
    units = -(-B // rows)
    return step * -(-units // at_once[key])


def _body(B: int, at_once: dict) -> str:
    """"serving" or "sequence": the faster body at B streams (`_waves_us`;
    the sequence length scales both alike, so it does not enter)."""
    best = min(_STEP_MODEL, key=lambda k: _waves_us(k, B, at_once))
    return "serving" if best == "serving" else "sequence"


def _cluster(B: int, at_once: dict) -> int:
    """The sequence body's cluster size at B streams: 16 blocks (W_hh^T's
    TF32 parts resident, a shorter step, fewer clusters at once) or 8
    (W_hh^T raw, more at once), whichever needs less time."""
    return min((8, 16), key=lambda c: _waves_us(c, B, at_once))


@functools.lru_cache(maxsize=None)
def _at_once(device: torch.device) -> dict:
    """{"serving": blocks, 8 / 16: clusters} that run together on
    `device`: the serving body takes one SM a block (197 KB of shared
    memory), the sequence body's clusters `max_active_clusters`."""
    with torch.cuda.device(device):
        out = {c: max_active_clusters(c) for c in (8, 16)}
    out["serving"] = torch.cuda.get_device_properties(
        device).multi_processor_count
    return out


@functools.lru_cache(maxsize=None)
def _seq_columns(H: int, cluster: int, device: torch.device) -> Tensor:
    """(cluster, 4H / cluster) on `device`: the W_hh^T column (gate * H
    + unit) of block r's local column j = 8 nt + 2 q + e, which the MMA
    puts in lane q's accumulator e of column tile nt: gate 2 (q & 1) + e
    of unit (H / cluster) r + 2 nt + (q >> 1).  Lanes q and q ^ 1 share a
    unit, so one shuffle gives a lane all four gates of its cell."""
    n = 4 * H // cluster
    j = torch.arange(n)
    nt, q, e = j // 8, (j % 8) // 2, j % 2
    r = torch.arange(cluster)[:, None]
    unit = (H // cluster) * r + 2 * nt + (q >> 1)
    return ((2 * (q & 1) + e) * H + unit).to(device)


def pack_w_hh_seq(w_hh_t: Tensor, cluster: int) -> Tensor:
    """W_hh^T (H, 4H), gate-major columns -> the sequence body's blocks'
    slices (cluster, H / 2, 4H / cluster, 2) float32: block r holds its
    units' four gates in `_seq_columns` order, K rows in pairs (row k at
    [r, k // 2, :, k % 2]) as in `pack_w_hh`."""
    H = w_hh_t.shape[0]
    cols = _seq_columns(H, cluster, w_hh_t.device).reshape(-1)
    n = 4 * H // cluster
    w = w_hh_t.float()[:, cols].reshape(H // 2, 2, cluster, n)
    return w.permute(2, 0, 3, 1).contiguous()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lstm_scan: {msg}")


def _outputs(gi: Tensor, h0: Tensor, c0: Tensor):
    B, T, H4 = gi.shape
    return (torch.empty((B, T, H4 // 4), dtype=gi.dtype, device=gi.device),
            torch.empty_like(h0), torch.empty_like(c0))


def _raise(rc: int, body: str) -> None:
    if rc != 0:
        raise RuntimeError(f"lstm_scan: {body} body launch failed, "
                           f"cudaError {rc}")


def _launch_serving(gi: Tensor, h0: Tensor, c0: Tensor, w_hh_t: Tensor,
                    b: Tensor):
    """The serving body on checked, contiguous CUDA tensors (b float32)."""
    B, T, H4 = gi.shape
    H = H4 // 4
    w = pack_w_hh(w_hh_t)
    ys, h_t, c_t = _outputs(gi, h0, c0)
    hx = torch.empty((B, H), dtype=torch.float32, device=gi.device)  # h_t
    with torch.cuda.device(gi.device):
        rc = _lib().lstm_scan_launch(
            _DTYPES[gi.dtype], _DTYPES[h0.dtype], gi.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), w.data_ptr(), b.data_ptr(),
            ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), hx.data_ptr(),
            B, T, H,
            torch.cuda.current_stream(gi.device).cuda_stream)
    _raise(rc, "serving")
    lstm_scan.launches += 1
    lstm_scan.serving_launches += 1
    return ys, h_t, c_t


def _launch_sequence(gi: Tensor, h0: Tensor, c0: Tensor, w_hh_t: Tensor,
                     b: Tensor, cluster: int):
    """The sequence body on checked, contiguous CUDA tensors (b float32):
    ceil(B / 16) clusters of `cluster` blocks (8, or 16 where the card
    allows it).  Raises where no such cluster fits."""
    B, T, H4 = gi.shape
    w = pack_w_hh_seq(w_hh_t, cluster)
    ys, h_t, c_t = _outputs(gi, h0, c0)
    with torch.cuda.device(gi.device):
        rc = _lib().lstm_seq_launch(
            _DTYPES[gi.dtype], _DTYPES[h0.dtype], gi.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), w.data_ptr(), b.data_ptr(),
            ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), B, T, H4 // 4,
            cluster, torch.cuda.current_stream(gi.device).cuda_stream, None)
    _raise(rc, "sequence")
    lstm_scan.launches += 1
    lstm_scan.sequence_launches += 1
    return ys, h_t, c_t


def max_active_clusters(cluster: int) -> int:
    """cudaOccupancyMaxActiveClusters of the sequence body (float32) on
    the current card; raises where none fits."""
    n = ctypes.c_int(0)
    rc = _lib().lstm_seq_launch(0, 0, None, None, None, None, None, None,
                                None, None, SEQ_ROWS, 1, 256, cluster, None,
                                ctypes.byref(n))
    _raise(rc, "sequence")
    return n.value


def lstm_scan(gi_seq: Tensor, h0: Tensor, c0: Tensor, w_hh_t: Tensor,
              b_hh: Tensor):
    """Fused LSTM over precomputed input gates.

    gi_seq: (B, T, 4H) = x @ W_ih.T + b_ih; h0, c0: (B, H); w_hh_t:
    (H, 4H), the TRANSPOSED recurrent weights; b_hh: (4H,).  gi and h0/c0
    are float32 or bf16 (each its own); H = 256.  The body follows from
    B and the card (`_body`).  Returns (ys (B, T, H) in gi's dtype, h_T,
    c_T in h0's)."""
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
    b = b_hh.float().reshape(H4).contiguous()
    gi, h0c, c0c = gi_seq.contiguous(), h0.contiguous(), c0.contiguous()
    for t in (h0c, c0c, w_hh_t, b):
        _check(t.device == gi.device, "all tensors on one device")
    at_once = _at_once(gi.device)
    if _body(B, at_once) == "sequence":
        return _launch_sequence(gi, h0c, c0c, w_hh_t, b,
                                _cluster(B, at_once))
    return _launch_serving(gi, h0c, c0c, w_hh_t, b)


lstm_scan.launches = 0
lstm_scan.serving_launches = 0
lstm_scan.sequence_launches = 0


def lstm_fused(x: Tensor, h0: Tensor, c0: Tensor, w_ih: Tensor,
               w_hh: Tensor, b_ih: Tensor, b_hh: Tensor):
    """Drop-in for ops.basic.lstm through the fused scan: the input
    projection x @ W_ih.T + b_ih runs once outside the kernel.  x
    (B, T, in); h0, c0 (B, H).  Returns (ys (B, T, H), h_T, c_T)."""
    gi = torch.matmul(x, w_ih.T) + b_ih
    return lstm_scan(gi, h0, c0, w_hh.T, b_hh)


# --- the serving LSTM in bf16 (csrc/lstm_serve.cu) ---------------------

SERVE_H = 256
# gate columns a chunk of the kernel's step: 32 units x 4 gates
SERVE_CHUNK = 128


def lstm_serve_plain(x: Tensor, h0: Tensor, c0: Tensor, w_ih: Tensor,
                     w_hh: Tensor, b_ih: Tensor, b_hh: Tensor):
    """Plain PyTorch version of the serving kernel, with its rounding
    points: a step's gates G = [x_t | h] [W_ih | W_hh]^T + (b_ih + b_hh)
    from x's and h's values and the weights' (bf16 on the card), the bias
    sum, the gates and c in float32; h rounded to x's dtype once a step
    (ys, and the next step's operand).  A float64 h0 runs everything in
    float64 (a reference).  x (B, T, H); h0, c0 (B, H); w_ih, w_hh
    (4H, H), gates i, f, g, o.  Returns (ys (B, T, H) in x's dtype, h_T
    in h0's, c_T in c0's)."""
    H = h0.shape[-1]
    ct = torch.float64 if h0.dtype == torch.float64 else torch.float32
    w = torch.cat([w_ih, w_hh], dim=1).to(ct)
    b = b_ih.to(ct) + b_hh.to(ct)
    h, c = h0.to(ct), c0.to(ct)
    ys = []
    for t in range(x.shape[1]):
        g = torch.cat([x[:, t].to(ct), h], dim=-1) @ w.T + b
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        gg = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * gg
        y = (o * torch.tanh(c)).to(x.dtype)
        h = y.to(ct)
        ys.append(y)
    return torch.stack(ys, dim=1), ys[-1].to(h0.dtype), c.to(c0.dtype)


@functools.lru_cache(maxsize=None)
def _serve_rows(H: int, device: torch.device) -> Tensor:
    """(4H,) on `device`: the gate-major row (gate * H + unit) of the
    stacked [W_ih | W_hh] behind packed row n = 128 j + 32 m + 8 gate + r,
    unit 32 j + 8 m + r.  In wgmma m64n128's accumulator a lane holds
    columns 8 i + 2 (lane % 4) + {0, 1} of the chunk, i = 4 m + gate: the
    four gates of units 32 j + 8 m + 2 (lane % 4) + {0, 1}."""
    n = torch.arange(4 * H)
    j, m = n // SERVE_CHUNK, (n % SERVE_CHUNK) // 32
    gate, r = (n % 32) // 8, n % 8
    return (gate * H + 32 * j + 8 * m + r).to(device)


# kernel-private packing per w_ih tensor: id -> (weak references to the
# four weight tensors, (W, bias))
_SERVE_PACKED: Dict[int, Any] = {}


def pack_w_serve(w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor):
    """The kernel's weights: (W (4H, 2H) bf16, its rows the stacked
    [W_ih | W_hh] rows in `_serve_rows` order; bias (4H,) float32 = b_ih
    + b_hh in the same order), contiguous.  Cached per weight tensors
    (read-only in inference)."""
    key = id(w_ih)
    refs, packed = _SERVE_PACKED.get(key, (None, None))
    if refs is None or any(r() is not t for r, t in
                           zip(refs, (w_ih, w_hh, b_ih, b_hh))):
        rows = _serve_rows(w_hh.shape[1], w_ih.device)
        packed = (torch.cat([w_ih, w_hh], dim=1)[rows].to(
            torch.bfloat16).contiguous(),
            (b_ih.float() + b_hh.float())[rows].contiguous())
        refs = [weakref.ref(w_ih, lambda _, k=key: _SERVE_PACKED.pop(k, None))]
        refs += [weakref.ref(t) for t in (w_hh, b_ih, b_hh)]
        _SERVE_PACKED[key] = (refs, packed)
    return packed


@functools.lru_cache(maxsize=None)
def _serve_lib() -> ctypes.CDLL:
    """The serving kernel's library, built on first use, with its C
    signature."""
    from vap_realtime_tpu_torch.ops.cuda.build import load

    lib = load("lstm_serve")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.lstm_serve_launch
    fn.restype = I
    # x, h0, c0, w, bias; ys, h_T, c_T; B, T; stream
    fn.argtypes = [P, P, P, P, P, P, P, P, I, I, P]
    return lib


def _serve_check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lstm_serve: {msg}")


def lstm_serve(x: Tensor, h0: Tensor, c0: Tensor, w_ih: Tensor,
               w_hh: Tensor, b_ih: Tensor, b_hh: Tensor):
    """The serving LSTM over one frame in bf16: x (B, T, 256), h0, c0
    (B, 256), contiguous; w_ih, w_hh (1024, 256), b_ih, b_hh (1024,); x,
    h0, c0 and the weights bfloat16.  Returns (ys (B, T, 256), h_T,
    c_T), bf16.  CUDA tensors: one kernel launch; CPU tensors:
    `lstm_serve_plain`; anything else raises."""
    H = SERVE_H
    _serve_check(x.dim() == 3 and x.shape[2] == H and x.shape[0] > 0
                 and x.shape[1] > 0, f"x must be (B, T, {H}), got "
                 f"{tuple(x.shape)}")
    B, T = x.shape[:2]
    _serve_check(tuple(h0.shape) == (B, H) and tuple(c0.shape) == (B, H),
                 f"h0, c0 must be ({B}, {H})")
    _serve_check(tuple(w_ih.shape) == (4 * H, H)
                 and tuple(w_hh.shape) == (4 * H, H)
                 and tuple(b_ih.shape) == (4 * H,)
                 and tuple(b_hh.shape) == (4 * H,),
                 f"w_ih, w_hh must be ({4 * H}, {H}), b_ih, b_hh "
                 f"({4 * H},)")
    bf = torch.bfloat16
    _serve_check(all(t.dtype == bf for t in (x, h0, c0, w_ih, w_hh)),
                 "x, h0, c0, w_ih and w_hh must be bfloat16")
    _serve_check(x.is_contiguous() and h0.is_contiguous()
                 and c0.is_contiguous(), "x, h0 and c0 must be contiguous")
    _serve_check(all(t.device == x.device
                     for t in (h0, c0, w_ih, w_hh, b_ih, b_hh)),
                 "all tensors on one device")
    if x.device.type == "cpu":
        return lstm_serve_plain(x, h0, c0, w_ih, w_hh, b_ih, b_hh)
    _serve_check(x.device.type == "cuda", f"unsupported device {x.device}")
    _serve_check(x.data_ptr() % 16 == 0 and h0.data_ptr() % 16 == 0,
                 "x and h0 must be 16-byte aligned")
    w, bias = pack_w_serve(w_ih, w_hh, b_ih, b_hh)
    ys = torch.empty((B, T, H), dtype=bf, device=x.device)
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    with torch.cuda.device(x.device):
        rc = _serve_lib().lstm_serve_launch(
            x.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            w.data_ptr(), bias.data_ptr(), ys.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr(), B, T,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_serve: kernel launch failed, cudaError "
                           f"{rc}")
    lstm_serve.launches += 1
    return ys, h_t, c_t


lstm_serve.launches = 0
