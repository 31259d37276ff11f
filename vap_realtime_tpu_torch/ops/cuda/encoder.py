"""The whole streaming CPC conv stack: kernel wrapper + plain version.

`conv_stack_fused` replaces the TPU kernel `conv_stack_fused_call`
(vap_realtime_tpu/ops/pallas/encoder.py:291, bodies `_kernel`:190 and
`_kernel_v3`:89), reached through `conv_impl="fused"`: conv0..conv4 of
the CPC encoder, each followed by ChannelNorm + ReLU, over one frame's
fresh samples with the per-layer streaming carries in and out.  The
kernels are `vap_realtime_tpu_torch/csrc/conv_stack_fused.cu`,
hand-written for Hopper; see its header for the design.  The TPU kernel's
`mode` values (merge8, cat8, taps20, v3) are VMEM layouts of one
function, so the port computes that function once; its lab-only `ablate`
truncations are not ported.

Numerics (as the TPU kernel): conv0 as patch rows P[t] = xc0[5t:5t+10]
times the (10, C) weight, conv1-4 (kernel = 2 * stride) as the two
stride-block matmuls y[t] = xm[t] W0 + xm[t+1] W1, products of the
activation dtype accumulated in float32, a float32 bias; `_cnorm_relu`:
float32 stats (unbiased, clamped), normalised in float32, cast to the
activation dtype BEFORE the affine, the affine rounded op by op in that
dtype.  In float32 this is the `conv` stack's math to float noise; in
bf16 it is more precise than the `conv` path (no bf16 rounding of the
conv outputs), so bf16 results are compared with the plain version here.

Two bodies.  bf16 (the serving dtype): five launches a call: conv0 on
mma.sync, then conv1..conv4 each an implicit GEMM on `wgmma` whose M runs
over the stride-block rows of all channel-streams at once
(`layer_geometry`), with the transposed weights (`hopper_weights`, a
kernel-private repack cached beside `pack_fused_params`) fed by TMA.
conv0 writes only each of its rows' ChannelNorm (mean, rstd), a (B, T0)
float2 buffer, and the carries: conv1's input X1 = [c1 | conv0 rows] is
never stored, since conv1's producer warps build its A tiles from the
samples, the stored statistics and c1 with conv0's own product and
roundings (`conv1_a_rows` writes the indexing out), so the tiles hold
X1's values bit for bit.  Each built 64-column block serves W[0]'s k
slice and, one row up, W[1]'s, so conv1 sums its K in that interleaved
order and its tiles keep 127 rows; z and c2..c4 differ from a body that
read a stored X1 only by that order's roundings.  conv2..conv4 read their
inputs by TMA from scratch buffers the layer before writes.  float32:
one launch, one block per channel-stream on the CUDA cores.

Bound on the H100: operations.  ~63.6 MFLOP per channel-stream in the
stride-block form: 0.50 TFLOP per step at 2B = 8192 (0.51 ms at the bf16
tensor-core peak, 7.5 ms at the 67 TFLOP/s float32 CUDA-core peak); the
bytes (waveform, carries, output, weights) are ~0.13 GB.

Long frames.  One body call takes at most 80 conv1 rows a stream in
bf16 (`kMaxT1`: L <= 1600 samples, 10 Hz) and what fits the float32
body's shared memory (L <= 800).  A longer frame (L = 3200 at 5 Hz) runs
as consecutive body calls over `PIECE`-sample pieces (the 20 Hz frame),
each piece's carries out the next one's carries in (`in_pieces`).  The
stack is causal and every layer's input rows are stored in the
activation dtype in both forms, so the pieces compute the whole frame's
rows from the same operands: the bf16 body's scratch (conv0's statistics
and X2..X4, ~40 KB a channel-stream; ~123 KB while X1 was stored) stays
at the 20 Hz frame's size, where one call over L = 3200 would need
~152 KB.

A frame that arrives over PCIe in pieces (`runtime/arena.py`) comes with
a fence: one event a piece, `fence[j].wait()` made on the current stream
right before body call j (`in_pieces`), or before the one call, so body
call j overlaps the copy of piece j + 1.

On a CUDA tensor the wrapper launches the kernels or raises; on a CPU
tensor it runs `conv_stack_fused_plain` over the whole frame.
`conv_stack_fused.launches` counts body calls (`CUDA_LAUNCHES` kernel
launches each; a frame in pieces makes one a piece) and
`conv_stack_fused.samples` the channel-stream samples they computed.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Any, Dict, List, Tuple

import torch

# (kernel, stride) of conv0 and of conv1..conv4 (encoder_components.py:83-92)
CONV0_K, CONV0_S = 10, 5
TAIL_KS = ((8, 4), (4, 2), (4, 2), (4, 2))
C = 256

Params = Dict[str, Any]
Tensor = torch.Tensor


def tail_lens(T0: int) -> List[Tuple[int, int]]:
    """Per-layer (T_in, T_out) of conv1..4 given conv0's output length
    (T_in includes the (k-s)-row carry; valid conv, stride s)."""
    lens = []
    T = T0
    for k, s in TAIL_KS:
        T_in = T + (k - s)
        if T_in % s:
            raise ValueError(f"conv stack: T_in {T_in} not a multiple of "
                             f"the stride {s} (T0 = {T0})")
        T = T_in // s - 1
        lens.append((T_in, T))
    return lens


def _cnorm_stats(y: Tensor) -> Tuple[Tensor, Tensor]:
    """ChannelNorm's (mean, rstd) over the last axis of y (..., C) float32
    (UNBIASED variance, clamped), each (..., 1)."""
    n = y.shape[-1]
    s1 = y.sum(-1, keepdim=True)
    s2 = (y * y).sum(-1, keepdim=True)
    mean = s1 / n
    var = torch.clamp((s2 - n * mean * mean) / (n - 1), min=0.0)
    return mean, torch.rsqrt(var + 1e-5)


def _cnorm_apply(y: Tensor, mean: Tensor, rstd: Tensor, w: Tensor,
                 b: Tensor, dt) -> Tensor:
    """y normalised with its rows' (mean, rstd), cast to dt BEFORE the
    affine (w, b already in dt), ReLU."""
    return torch.relu(((y - mean) * rstd).to(dt) * w + b)


def _cnorm_relu(y: Tensor, w: Tensor, b: Tensor, dt) -> Tensor:
    """ChannelNorm over the last axis + ReLU, the TPU kernel's
    `_cnorm_relu`: y (..., C) float32; w, b (C,) already in dt.  Returns
    dt."""
    return _cnorm_apply(y, *_cnorm_stats(y), w, b, dt)


# packed operands per encoder params: id(conv0 weight) -> (weak reference
# to that tensor, {dtype: operands}); the reference guards against a
# reused id
_PACKED: Dict[int, Any] = {}


def pack_fused_params(enc: Params, dtype=None):
    """Encoder params -> (w0, wts, aux) kernel operands.

    w0: conv0 weight (C_out, 1, 10) -> (10, C).  wts: per tail layer a
    (2, s*C, C) pair of stride-block matrices: W[b] rows [p*C:(p+1)*C]
    hold tap j = b*s + p, so xm[t] @ W[0] + xm[t+1] @ W[1] equals
    sum_j x[s*t + j] @ w_tap[j] for the lane-merged xm; contiguous, so
    W.reshape(2*s*C, C) stacks all k taps.  aux (15, C) float32 =
    per-layer [bias, norm w, norm b] rows.  w0 and wts are cast to
    `dtype` (default: the weights' own).  The result is cached per params
    tree and dtype (the weights are read-only in inference)."""
    key = enc["conv0"]["w"]
    dtype = key.dtype if dtype is None else dtype
    ref, per = _PACKED.get(id(key), (None, None))
    if ref is None or ref() is not key:
        per = {}
        _PACKED[id(key)] = (weakref.ref(
            key, lambda _, k=id(key): _PACKED.pop(k, None)), per)
    if dtype in per:
        return per[dtype]
    w0 = enc["conv0"]["w"][:, 0, :].T.to(dtype).contiguous()     # (10, C)
    wts = []
    for i, (k, s) in enumerate(TAIL_KS):
        taps = enc[f"conv{i + 1}"]["w"].permute(2, 1, 0)          # (k, Ci, Co)
        wts.append(torch.stack([taps[b * s:(b + 1) * s].reshape(s * C, C)
                                for b in range(2)]).to(dtype).contiguous())
    rows = []
    for i in range(5):
        rows += [enc[f"conv{i}"]["b"], enc[f"norm{i}"]["w"][:, 0],
                 enc[f"norm{i}"]["b"][:, 0]]
    aux = torch.stack([r.float() for r in rows]).contiguous()     # (15, C)
    per[dtype] = (w0, tuple(wts), aux)
    return per[dtype]


# the bf16 body's GEMM tile: output rows a weight tile serves; conv1's
# tiles keep TILE_ROWS - 1 of them (`layer_geometry`)
TILE_ROWS = 128
# CUDA kernel launches per conv_stack_fused call, per activation dtype
CUDA_LAUNCHES = {torch.float32: 1, torch.bfloat16: 5}


def layer_geometry(B: int, L: int) -> List[Dict[str, int]]:
    """The bf16 body's implicit GEMMs of conv1..conv4 for B channel-streams
    of L samples.  Layer l's input X (B, T_in, C), T_in = s (T_out + 1),
    is the matrix xm of stride blocks (B (T_out + 1) rows of s C); output
    row m = xm[m] W[0] + xm[m + 1] W[1] for every m, of which row t of
    stream n is m = n (T_out + 1) + t, and the rows with t = T_out (which
    straddle two streams) are junk, dropped.  M runs over all streams in
    tiles of `rows` output rows; the last tile's rows past M are masked.
    A tile computes TILE_ROWS rows; conv1's keep TILE_ROWS - 1, since its
    A rows are built once for W[0]'s half of K and serve W[1]'s one row
    up (`conv1_a_rows`).  Returns per layer {M, T_out, s, K (2 s C), rows,
    tiles}."""
    out = []
    for li, ((k, s), (_, t_out)) in enumerate(
            zip(TAIL_KS, tail_lens(L // CONV0_S))):
        M = B * (t_out + 1)
        rows = TILE_ROWS - 1 if li == 0 else TILE_ROWS
        out.append(dict(M=M, T_out=t_out, s=s, K=k * C, rows=rows,
                        tiles=-(-M // rows)))
    return out


def conv1_a_rows(B: int, L: int, m0: int, cb: int):
    """The rows the bf16 body's conv1 builds for X1 row block cb (0..3)
    of the tile at xm row m0 (B channel-streams of L samples): built row r
    < TILE_ROWS is X1 row 4 m + cb of xm row m = m0 + r, of which the A
    stage of W[0]'s k slice [256 cb + cc, + 64) takes rows 0 .. 127 and
    that of W[1]'s slice [1024 + 256 cb + cc, + 64) rows 1 .. 127 (its
    last row zero), each over channels [cc, cc + 64).  Stream n = m //
    (T1 + 1)'s stride block tm = m mod (T1 + 1) is c1's rows (tm = 0) or
    conv0's rows 4 (tm - 1) .. + 3.  Returns (kind, n, t), each
    (TILE_ROWS,) int64: kind 1 for conv0 row t of stream n, -1 for c1 row
    t, 0 for a zero row past the last stream (m >= M)."""
    T1 = tail_lens(L // CONV0_S)[0][1]
    m = torch.arange(m0, m0 + TILE_ROWS)
    n, tm = m // (T1 + 1), m % (T1 + 1)
    kind = torch.where(m >= B * (T1 + 1), 0, torch.where(tm == 0, -1, 1))
    t = torch.where(tm == 0, cb, 4 * (tm - 1) + cb)
    return kind, n, t


def weight_l2_bytes(B: int, L: int) -> int:
    """Bytes of bf16 weights the bf16 body streams from L2 into shared
    memory per call: one (K, C) matrix per tile of each layer."""
    return sum(g["tiles"] * g["K"] * C * 2 for g in layer_geometry(B, L))


# kernel-private repack per stride-block weight tensor: id -> (weak
# reference, W^T)
_TRANSPOSED: Dict[int, Any] = {}


def hopper_weights(wts) -> Tuple[Tensor, ...]:
    """`pack_fused_params`' stride-block weights -> the bf16 body's GEMM
    operands: per layer W^T (C, 2 s C), contiguous, W^T[u, b s C + p C +
    c] = W[b][p C + c, u] (tap b s + p, input channel c, output u): the
    K-major B operand whose rows the kernel's TMA map cuts into 64-column
    boxes.  Cached per weight tensor (read-only in inference)."""
    out = []
    for W in wts:
        ref, Wt = _TRANSPOSED.get(id(W), (None, None))
        if ref is None or ref() is not W:
            Wt = W.reshape(-1, C).T.contiguous()
            _TRANSPOSED[id(W)] = (weakref.ref(
                W, lambda _, k=id(W): _TRANSPOSED.pop(k, None)), Wt)
        out.append(Wt)
    return tuple(out)


def conv0_patches(xc0: Tensor) -> Tensor:
    """(B, L+5) carry-prefixed waveform -> (B, L/5, 10) conv0 patch rows,
    P[b, t, :] = xc0[b, 5t : 5t+10]."""
    B, Lp = xc0.shape
    T0 = (Lp - CONV0_S) // CONV0_S
    xr = xc0.reshape(B, T0 + 1, CONV0_S)
    return torch.cat([xr[:, :T0], xr[:, 1:]], dim=-1)


def conv_stack_fused_plain(c0: Tensor, new: Tensor, carries, w0: Tensor,
                           wts, aux: Tensor):
    """Plain PyTorch version of the kernel, with its rounding points.

    c0 (B, 5) conv0 carry; new (B, L) fresh samples (the activation
    dtype); carries (c1 (B, 4, C), c2/c3/c4 (B, 2, C)) channels-last;
    (w0, wts, aux) from `pack_fused_params` in the activation dtype.
    Returns (z (B, L/160, C), (new c0 (B, 5), new c1..c4))."""
    dt = new.dtype
    f32 = torch.float32
    xc0 = torch.cat([c0.to(dt), new], dim=-1)
    P = conv0_patches(xc0)
    # dt x dt products accumulated in float32: the float32 matmul of the
    # exactly widened operands
    y = torch.matmul(P.to(f32), w0.to(f32)) + aux[0]
    x = _cnorm_relu(y, aux[1].to(dt), aux[2].to(dt), dt)
    out_carries = []
    Bn = x.shape[0]
    for li, (k, s) in enumerate(TAIL_KS):
        x = torch.cat([carries[li].to(dt), x], dim=1)
        out_carries.append(x[:, x.shape[1] - (k - s):].contiguous())
        G = x.shape[1] // s
        xm = x.reshape(Bn, G, s * C).to(f32)
        W = wts[li].to(f32)
        y = (torch.matmul(xm, W[0])[:, :G - 1] + torch.matmul(xm, W[1])[:, 1:]
             + aux[3 * (li + 1)])
        x = _cnorm_relu(y, aux[3 * (li + 1) + 1].to(dt),
                        aux[3 * (li + 1) + 2].to(dt), dt)
    return x, (xc0[:, xc0.shape[1] - CONV0_S:].contiguous(),
               *out_carries)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory the kernel may use per block (H100: 227 KB)
SMEM_LIMIT = 232448


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    from vap_realtime_tpu_torch.ops.cuda.build import load

    return bind(load("conv_stack_fused"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of conv_stack_fused.cu."""
    P, I = ctypes.c_void_p, ctypes.c_int
    # new, c0, c1..c4; w0, w1..w4; aux; z, n0, n1..n4; B, L; stream
    lib.conv_stack_fused_f32_launch.restype = I
    lib.conv_stack_fused_f32_launch.argtypes = [P] * 18 + [I, I, P]
    # new, c0, c1..c4; w0, wt1..wt4; aux; z, n0, n1..n4; stats, x2..x4;
    # B, L; stream
    lib.conv_stack_fused_bf16_launch.restype = I
    lib.conv_stack_fused_bf16_launch.argtypes = [P] * 22 + [I, I, P]
    lib.conv_stack_fused_smem.restype = I
    lib.conv_stack_fused_smem.argtypes = [I, I]
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"conv_stack_fused: {msg}")


# the piece a frame longer than one body call takes runs in: the 20 Hz
# frame, which both bodies take
PIECE = 800


def piece_samples(L: int, fits) -> int:
    """The samples a body call takes for a frame of L: L when one call
    fits it (`fits(L)`), else PIECE when L is a whole number of fitting
    pieces; raises otherwise."""
    if fits(L):
        return L
    _check(L > PIECE and L % PIECE == 0 and fits(PIECE),
           f"L = {L}: one body call takes at most 1600 samples in bf16 "
           f"(kMaxT1 = 80 conv1 rows) and 800 in float32 (its shared "
           f"memory), and a longer frame runs in pieces of {PIECE} only "
           f"when L is a multiple of {PIECE}")
    return PIECE


def body_fits(dt):
    """The body call's rule in activation dtype dt: whether one call
    takes an L-sample frame (its shared memory, asked of the library)."""
    _check(dt in _DTYPES, f"dtype {dt} (float32 / bfloat16)")
    return lambda L: 0 < _lib().conv_stack_fused_smem(
        _DTYPES[dt], L // CONV0_S) <= SMEM_LIMIT


def wait_all(fence) -> None:
    """The current stream waits on every event of `fence` (None: the
    frame is already on the stream)."""
    for ev in fence or ():
        ev.wait()


def in_pieces(stack, c0: Tensor, new: Tensor, carries, w0: Tensor, wts,
              aux: Tensor, piece: int = PIECE, fence=None):
    """`stack` (the signature of `conv_stack_fused_plain`) over new (B, L)
    as L / piece consecutive calls, each piece's new carries the next
    one's carries in; z of the pieces concatenated over time.  fence:
    None, or one event a piece, waited on right before that piece's
    call.  Returns what one call over the whole frame returns."""
    zs = []
    for j, at in enumerate(range(0, new.shape[1], piece)):
        if fence is not None:
            fence[j].wait()
        z, (c0, *carries) = stack(c0, new[:, at:at + piece], tuple(carries),
                                  w0, wts, aux)
        zs.append(z)
    return torch.cat(zs, dim=1), (c0, *carries)


def conv_stack_fused(c0: Tensor, new: Tensor, carries, w0: Tensor, wts,
                     aux: Tensor, fence=None):
    """The whole streaming conv stack on the card (a body call: one
    launch in float32, five in bf16; a frame longer than one call takes
    runs in PIECE-sample pieces, a call each): same arguments and results
    as `conv_stack_fused_plain`.  The activation dtype (new's) is float32
    or bf16; every tensor lies on one device.  fence: None, or one event
    a body call (`in_pieces`)."""
    if new.device.type == "cpu":
        wait_all(fence)
        return conv_stack_fused_plain(c0, new, carries, w0, wts, aux)
    _check(new.device.type == "cuda", f"unsupported device {new.device}")
    dt = new.dtype
    _check(dt in _DTYPES, f"dtype {dt} (float32 / bfloat16)")
    _check(new.dim() == 2, f"new must be (B, L), got {tuple(new.shape)}")
    B, L = new.shape
    _check(B > 0 and L % CONV0_S == 0, f"L = {L} not a multiple of 5")
    _check(tail_lens(L // CONV0_S)[-1][1] > 0, f"L = {L} too short")
    c0 = c0.reshape(B, CONV0_S).to(dt).contiguous()
    cs = [c.to(dt).contiguous() for c in carries]
    for c, (k, s) in zip(cs, TAIL_KS):
        _check(tuple(c.shape) == (B, k - s, C), f"carry {tuple(c.shape)}: "
               f"expected ({B}, {k - s}, {C})")
    _check(tuple(w0.shape) == (CONV0_K, C) and w0.dtype == dt,
           f"w0 must be ({CONV0_K}, {C}) {dt}")
    for W, (k, s) in zip(wts, TAIL_KS):
        _check(tuple(W.shape) == (2, s * C, C) and W.dtype == dt
               and W.is_contiguous(), f"stride-block weights must be "
               f"(2, {s * C}, {C}) {dt}, contiguous")
    _check(tuple(aux.shape) == (15, C) and aux.dtype == torch.float32
           and aux.is_contiguous(), "aux must be (15, C) float32")
    for t in (new, c0, *cs, w0, *wts, aux):
        _check(t.device == new.device, "all tensors on one device")
    piece = piece_samples(L, body_fits(dt))
    _check(fence is None or len(fence) == L // piece,
           f"{len(fence or ())} fence events for {L // piece} body calls")
    if piece == L:
        wait_all(fence)
        return _call(c0, new, cs, w0, wts, aux)
    return in_pieces(_call, c0, new, cs, w0, wts, aux, piece, fence)


def _call(c0: Tensor, new: Tensor, cs, w0: Tensor, wts, aux: Tensor):
    """One body call over a frame it takes, on checked operands (c0 and
    the carries contiguous)."""
    new = new.contiguous()
    dt = new.dtype
    B, L = new.shape
    T0 = L // CONV0_S
    lens = tail_lens(T0)
    dev = new.device
    z = torch.empty((B, lens[-1][1], C), dtype=dt, device=dev)
    n0 = torch.empty((B, CONV0_S), dtype=dt, device=dev)
    ns = [torch.empty_like(c) for c in cs]
    ptrs = [new.data_ptr(), c0.data_ptr(), *[c.data_ptr() for c in cs],
            w0.data_ptr()]
    outs = [aux.data_ptr(), z.data_ptr(), n0.data_ptr(),
            *[n.data_ptr() for n in ns]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dt == torch.float32:
            rc = _lib().conv_stack_fused_f32_launch(
                *ptrs, *[W.data_ptr() for W in wts], *outs, B, L, stream)
        else:
            # kernel scratch: conv0 rows' (mean, rstd), float2, and the
            # inputs X2..X4 of conv2..conv4 (carry rows first)
            xs = [torch.empty((B, T0, 2), dtype=torch.float32, device=dev)
                  ] + [torch.empty((B, t_out + 2, C), dtype=dt, device=dev)
                       for _, t_out in lens[:3]]
            rc = _lib().conv_stack_fused_bf16_launch(
                *ptrs, *[W.data_ptr() for W in hopper_weights(wts)], *outs,
                *[x.data_ptr() for x in xs], B, L, stream)
    if rc != 0:
        raise RuntimeError(f"conv_stack_fused: kernel launch failed, "
                           f"cudaError {rc}")
    conv_stack_fused.launches += 1
    conv_stack_fused.samples += B * L
    return z, (n0, *ns)


conv_stack_fused.launches = 0
conv_stack_fused.samples = 0


def cpc_conv_stack_streaming_fused(params: Params, new: Tensor,
                                   state: Params, fence=None):
    """Drop-in for models/encoder.cpc_conv_stack_streaming through the
    fused kernel: new (B, L) fresh samples; state channels-last carries
    {"c0": (B, 1, 5), "c1": (B, 4, C), "c2".."c4": (B, 2, C)}; fence:
    see `conv_stack_fused`.  Returns ((B, L/160, C) features,
    new_state)."""
    dt = new.dtype
    w0, wts, aux = pack_fused_params(params, dt)
    z, tails = conv_stack_fused(
        state["c0"].reshape(new.shape[0], CONV0_S), new,
        tuple(state[f"c{i}"] for i in range(1, 5)), w0, wts, aux, fence)
    new_state = {"c0": tails[0][:, None, :]}
    for i, t in enumerate(tails[1:], start=1):
        new_state[f"c{i}"] = t
    return z, new_state


def init_conv_stream_state_fused(batch: int, dim: int = C,
                                 dtype=torch.float32, device=None) -> Params:
    """Channels-last streaming carries for the fused kernel: the layout of
    models/encoder.init_conv_stream_state, which this returns."""
    # imported here: models/encoder imports this module
    from vap_realtime_tpu_torch.models.encoder import init_conv_stream_state

    return init_conv_stream_state(batch, dim, dtype, device)
