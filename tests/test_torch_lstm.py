"""PyTorch port: the fused LSTM scan (K5) against the JAX package — the
kernel's plain version against the TPU kernel (`lstm_pallas`, Pallas in
interpret mode) and against the port's own `ops.basic.lstm` — and the
serving LSTM kernel's plain version, wrapper and weight packing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu.ops.pallas.lstm import lstm_pallas
from vap_realtime_tpu_torch.ops.basic import lstm
from vap_realtime_tpu_torch.ops.cuda import lstm as k5
from vap_realtime_tpu_torch.ops.cuda.lstm import (
    lstm_fused, lstm_scan, lstm_scan_plain, lstm_serve_plain, pack_w_hh,
    pack_w_hh_seq,
)

T_ = torch.as_tensor


def _inputs(seed=1, B=8, T=5, H=256):
    """tests/test_pallas.py:46-56: x, h0, c0 ~ 0.1 N(0, 1), weights and
    biases U(+-1/sqrt(H))."""
    rs = np.random.RandomState(seed)
    f = lambda *s: (0.1 * rs.randn(*s)).astype(np.float32)
    u = lambda *s: rs.uniform(-1 / np.sqrt(H), 1 / np.sqrt(H),
                              s).astype(np.float32)
    return (f(B, T, H), f(B, H), f(B, H), u(4 * H, H), u(4 * H, H),
            u(4 * H), u(4 * H))


def test_lstm_fused_matches_pallas_and_basic():
    """lstm_fused (CPU: the scan's plain version) against lstm_pallas in
    interpret mode and against ops.basic.lstm, B=8, T=5, H=256: ys, h_T
    and c_T to atol 1e-5 (tests/test_pallas.py:61-63)."""
    args = _inputs()
    want = lstm_pallas(*map(jnp.asarray, args), interpret=True)
    got = lstm_fused(*map(T_, args))
    ref = lstm(*map(T_, args))
    for name, g, w, r in zip(("ys", "h_T", "c_T"), got, want, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=f"{name} vs lstm_pallas")
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5,
                                   err_msg=f"{name} vs ops.basic.lstm")


@pytest.mark.parametrize("gi_dtype,h_dtype", [("bfloat16", "bfloat16"),
                                              ("bfloat16", "float32"),
                                              ("float32", "bfloat16")])
def test_scan_dtype_contract(gi_dtype, h_dtype):
    """ys come out in gi's dtype, h_T and c_T in h0's, the math in float32
    (the TPU kernel's contract): against lstm_scan in interpret mode on
    the same bf16-rounded inputs, to one bf16 step (rtol 2^-7, atol
    1e-5)."""
    from vap_realtime_tpu.ops.pallas.lstm import lstm_scan as jax_scan

    x, h0, c0, w_ih, w_hh, b_ih, b_hh = _inputs(seed=2)
    gi = x @ w_ih.T + b_ih
    gd, hd = getattr(torch, gi_dtype), getattr(torch, h_dtype)
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
    got = lstm_scan(T_(gi).to(gd), T_(h0).to(hd), T_(c0).to(hd),
                    T_(w_hh).T, T_(b_hh))
    want = jax_scan(jnp.asarray(gi, jd[gi_dtype]),
                    jnp.asarray(h0, jd[h_dtype]),
                    jnp.asarray(c0, jd[h_dtype]), jnp.asarray(w_hh).T,
                    jnp.asarray(b_hh), interpret=True)
    assert [t.dtype for t in got] == [gd, hd, hd]
    for name, g, w in zip(("ys", "h_T", "c_T"), got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-5, err_msg=name)


def test_wrapper_cpu_dispatch_and_checks():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; any other non-CUDA device raises instead of falling back."""
    x, h0, c0, w_ih, w_hh, b_ih, b_hh = map(T_, _inputs(seed=3, B=3))
    gi = x @ w_ih.T + b_ih
    before = lstm_scan.launches
    for a, b in zip(lstm_scan(gi, h0, c0, w_hh.T, b_hh),
                    lstm_scan_plain(gi, h0, c0, w_hh.T, b_hh)):
        assert torch.equal(a, b)
    assert lstm_scan.launches == before
    m = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_scan(m(gi), m(h0), m(c0), m(w_hh.T), m(b_hh))


def test_pack_w_hh_layout():
    """The kernel's weight layout (4, H / 2, H, 2): column j = 32 w + 8 nt
    + 2 q + e of pass p is gate 2 (q & 1) + e of unit 64 p + 8 w + 4 (q >>
    1) + nt (lanes q and q ^ 1 of an MMA tile share a unit; a lane's four
    column tiles are consecutive units), K rows in pairs; every column of
    W_hh^T lands once."""
    H = 256
    w = torch.from_numpy(np.random.RandomState(4).randn(H, 4 * H)
                         .astype(np.float32))
    wp = pack_w_hh(w)
    assert wp.shape == (4, H // 2, H, 2) and wp.dtype == torch.float32
    j = np.arange(H)
    wg, r = np.divmod(j, 32)
    nt, r = np.divmod(r, 8)
    q, e = np.divmod(r, 2)
    seen = []
    for p in range(4):
        cols = (2 * (q & 1) + e) * H + 64 * p + 8 * wg + 4 * (q >> 1) + nt
        by_k = wp[p].permute(0, 2, 1).reshape(H, H)      # (k, j)
        assert torch.equal(by_k, w[:, cols])
        seen.append(cols)
    assert sorted(np.concatenate(seen).tolist()) == list(range(4 * H))


@pytest.mark.parametrize("cluster", [8, 16])
def test_pack_w_hh_seq_layout(cluster):
    """The sequence body's weight layout (cluster, H / 2, 4H / cluster,
    2): block r's local column j = 8 nt + 2 q + e is gate 2 (q & 1) + e of
    unit (H / cluster) r + 2 nt + (q >> 1) (lanes q and q ^ 1 of an MMA
    tile share a unit, so the cell update stays in the block), K rows in
    pairs; every column of W_hh^T lands once, column by column."""
    H = 256
    w = torch.from_numpy(np.random.RandomState(5).randn(H, 4 * H)
                         .astype(np.float32))
    wp = pack_w_hh_seq(w, cluster)
    n = 4 * H // cluster
    assert wp.shape == (cluster, H // 2, n, 2) and wp.dtype == torch.float32
    seen = []
    for r in range(cluster):
        by_k = wp[r].permute(0, 2, 1).reshape(H, n)     # (k, j)
        for j in range(n):
            nt, q, e = j // 8, (j % 8) // 2, j % 2
            col = (2 * (q & 1) + e) * H + (H // cluster) * r + 2 * nt + (
                q >> 1)
            assert torch.equal(by_k[:, j], w[:, col]), (r, j)
            seen.append(col)
    assert sorted(seen) == list(range(4 * H))


# The body (and the sequence body's cluster size) lstm_scan takes on the
# grid measured on the card (PERF.md, tools/lstm_bodies.py): the fastest
# at every T there.  B = 112 and 128 straddle the 7 clusters of 16
# blocks that fit at once (measured in an earlier run of the tool: at T =
# 5 the two cluster sizes were within 3% at B = 128).
BODY_GRID = {16: "sequence 16", 64: "sequence 16", 112: "sequence 16",
             128: "sequence 8", 256: "sequence 16", 1024: "sequence 8",
             2048: "sequence 8", 4096: "sequence 8", 8192: "serving"}
# What runs at once on the card the grid was measured on (NVIDIA H100 80GB
# HBM3): 132 SMs, one serving block each; `max_active_clusters` 15 of 8
# blocks, 7 of 16.
H100_SXM = {"serving": 132, 8: 15, 16: 7}


def _pick(B, at_once):
    got = k5._body(B, at_once)
    return (f"sequence {k5._cluster(B, at_once)}" if got == "sequence"
            else got)


@pytest.mark.parametrize("B,want", sorted(BODY_GRID.items()))
def test_body_choice_by_shape(B, want):
    """The body depends on B and the card alone (the sequence length
    scales both bodies alike): the training encoder's 16 streams take the
    sequence body on clusters of 16 blocks, the serving shape's 8192
    channel-streams keep the serving body, and the measured grid gives
    its winner."""
    assert _pick(B, H100_SXM) == want


def test_body_choice_follows_the_card():
    """On a card that runs half as many blocks and clusters at once the
    waves double: the serving body's one wave wins from B = 4096 on, the
    training encoder's 16 streams stay on the sequence body."""
    half = {"serving": 66, 8: 7, 16: 3}
    assert _pick(16, half) == "sequence 16"
    assert _pick(2048, half) == "sequence 8"
    assert _pick(4096, half) == _pick(8192, half) == "serving"
    assert _pick(4096, H100_SXM) == "sequence 8"


@pytest.mark.parametrize("B,T", [(16, 40), (20, 7), (8, 5)])
def test_wrapper_cpu_goes_to_plain_whatever_the_body(B, T):
    """On CPU tensors the wrapper is lstm_scan_plain at any shape, the
    ones whose CUDA body would be the sequence body included: bit-equal,
    and no body's counter moves; another non-CUDA device raises."""
    x, h0, c0, w_ih, w_hh, b_ih, b_hh = map(T_, _inputs(seed=6, B=B, T=T))
    gi = x @ w_ih.T + b_ih
    names = ("launches", "serving_launches", "sequence_launches")
    before = [getattr(lstm_scan, n) for n in names]
    for a, b in zip(lstm_scan(gi, h0, c0, w_hh.T, b_hh),
                    lstm_scan_plain(gi, h0, c0, w_hh.T, b_hh)):
        assert torch.equal(a, b)
    assert [getattr(lstm_scan, n) for n in names] == before
    m = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_scan(m(gi), m(h0), m(c0), m(w_hh.T), m(b_hh))


# --- the serving LSTM in bf16 (`lstm_serve`, csrc/lstm_serve.cu) ---------

def _serve_inputs(seed, B, T, H=256):
    """bf16 serving-LSTM inputs: x like K7's ReLU'd rows (|N(0, 1)|), h0
    and c0 a running stream's state, weights and biases U(+-1/16)."""
    rs = np.random.RandomState(seed)
    u = lambda *s: rs.uniform(-1 / 16, 1 / 16, s)
    bf = lambda a: torch.tensor(a, dtype=torch.float32).bfloat16()
    return (bf(np.abs(rs.randn(B, T, H))), bf(0.3 * rs.randn(B, H)),
            bf(0.5 * rs.randn(B, H)), bf(u(4 * H, H)), bf(u(4 * H, H)),
            bf(u(4 * H)), bf(u(4 * H)))


@pytest.mark.parametrize("T", [5, 20])
def test_lstm_serve_plain_matches_float64(T):
    """lstm_serve_plain (the kernel's rounding points: bf16 x / h
    operands and weights, float32 bias sum, gates and c, bf16 ys / h_T /
    c_T) against ops.basic.lstm in float64 on the same bf16 values, at
    the 20 Hz and 5 Hz frames' steps and B = 200 (not a multiple of the
    kernel's 128-row tile): |d| <= 2^-8 |ref| + 2^-9.  The outputs are
    rounded to bf16 once (half an ulp, 2^-9 relative) and h's bf16
    roundings at earlier steps reach them through W_hh (measured: 2.0e-3
    on ys, 3.9e-3 on c at |c| ~1.4); the bound leaves about twice that.
    And it is no less precise than the plain bf16 path it replaces
    (ops.basic.lstm in bf16, which rounds every gate, product and c)."""
    args = _serve_inputs(7 + T, 200, T)
    got = lstm_serve_plain(*args)
    ref = lstm(*[a.double() for a in args])
    bf16_path = lstm(*args)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    for name, g, r, p in zip(("ys", "h_T", "c_T"), got, ref, bf16_path):
        d = (g.double() - r).abs()
        assert bool((d <= 2 ** -8 * r.abs() + 2 ** -9).all()), (
            name, d.max().item())
        assert d.max() <= (p.double() - r).abs().max(), name


def test_lstm_serve_cpu_dispatch():
    """On CPU tensors lstm_serve is lstm_serve_plain, bit for bit, and
    launches nothing."""
    args = _serve_inputs(3, 131, 5)
    before = k5.lstm_serve.launches
    for a, b in zip(k5.lstm_serve(*args), lstm_serve_plain(*args)):
        assert torch.equal(a, b)
    assert k5.lstm_serve.launches == before


def _bad_serve_args(case):
    """The inputs of `_serve_inputs(9, 6, 5)` with one thing wrong."""
    x, h0, c0, w_ih, w_hh, b_ih, b_hh = _serve_inputs(9, 6, 5)
    if case == "dtype x":
        x = x.float()
    elif case == "dtype state":
        h0 = h0.float()
    elif case == "dtype weights":
        w_hh = w_hh.float()
    elif case == "shape x":
        x = x[..., :128]
    elif case == "shape state":
        c0 = c0[:5]
    elif case == "shape weights":
        w_ih = w_ih[:, :128]
    elif case == "contiguity x":
        # the chunked conv stack's (B, C, T) view, transposed
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "contiguity slice":
        x = torch.cat([x, x], dim=1)[:, 1:6]
    elif case == "contiguity state":
        h0 = torch.cat([h0, h0], dim=1)[:, ::2]
    elif case == "device":
        x, h0, c0, w_ih, w_hh, b_ih, b_hh = (
            t.to("meta") for t in (x, h0, c0, w_ih, w_hh, b_ih, b_hh))
    elif case == "devices mixed":
        w_hh = w_hh.to("meta")
    return x, h0, c0, w_ih, w_hh, b_ih, b_hh


@pytest.mark.parametrize("case,match", [
    ("dtype x", "bfloat16"), ("dtype state", "bfloat16"),
    ("dtype weights", "bfloat16"), ("shape x", "x must be"),
    ("shape state", "h0, c0 must be"), ("shape weights", "w_ih, w_hh must"),
    ("contiguity x", "contiguous"), ("contiguity slice", "contiguous"),
    ("contiguity state", "contiguous"),
    ("device", "unsupported device"), ("devices mixed", "one device")])
def test_lstm_serve_refuses(case, match):
    """The wrapper raises ValueError on what the kernel does not take (a
    dtype, a shape, a layout, a device), before any dispatch: nothing
    falls back."""
    with pytest.raises(ValueError, match=match):
        k5.lstm_serve(*_bad_serve_args(case))


def test_pack_w_serve_layout():
    """The kernel's weights (4H, 2H) bf16: packed row n = 128 j + 32 m + 8
    gate + r is the stacked [W_ih | W_hh] row of that gate and unit 32 j
    + 8 m + r, so in wgmma m64n128's accumulator (columns 8 i + 2 (lane %
    4) + {0, 1} of chunk j, i = 4 m + gate) a lane holds the four gates
    of units 32 j + 8 m + 2 (lane % 4) + {0, 1}; the bias is b_ih + b_hh
    in float32 in the same order; every row lands once; the packing is
    cached per weight tensors."""
    H = 256
    _, _, _, w_ih, w_hh, b_ih, b_hh = _serve_inputs(11, 1, 1)
    w, b = k5.pack_w_serve(w_ih, w_hh, b_ih, b_hh)
    assert w.shape == (4 * H, 2 * H) and w.dtype == torch.bfloat16
    assert b.shape == (4 * H,) and b.dtype == torch.float32
    stacked = torch.cat([w_ih, w_hh], dim=1)
    bias = b_ih.float() + b_hh.float()
    seen = []
    for j in range(8):
        for lane in range(4):
            for i in range(16):
                m, gate = divmod(i, 4)
                for e in range(2):
                    n = 128 * j + 8 * i + 2 * lane + e
                    row = gate * H + 32 * j + 8 * m + 2 * lane + e
                    assert torch.equal(w[n], stacked[row]), (j, lane, i, e)
                    assert b[n] == bias[row]
                    seen.append(row)
    assert sorted(seen) == list(range(4 * H))
    assert k5.pack_w_serve(w_ih, w_hh, b_ih, b_hh)[0] is w
    assert k5.pack_w_serve(w_ih, w_hh.clone(), b_ih, b_hh)[0] is not w


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cpc_context_on_the_cpu_keeps_basic_lstm(dtype):
    """cpc_context sends CPU tensors, bf16 or float32, to ops.basic.lstm,
    bit for bit, and leaves lstm_serve.launches alone (the kernel takes
    CUDA bf16 tensors only)."""
    from vap_realtime_tpu_torch.models.encoder import cpc_context

    x, h0, c0, w_ih, w_hh, b_ih, b_hh = (
        t.to(getattr(torch, dtype)) for t in _serve_inputs(12, 9, 5))
    params = {"lstm": dict(w_ih=w_ih, w_hh=w_hh, b_ih=b_ih, b_hh=b_hh)}
    before = k5.lstm_serve.launches
    for a, b in zip(cpc_context(params, x, h0, c0),
                    lstm(x, h0, c0, w_ih, w_hh, b_ih, b_hh)):
        assert torch.equal(a, b)
    assert k5.lstm_serve.launches == before
