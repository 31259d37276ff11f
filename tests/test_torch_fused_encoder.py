"""PyTorch port: the fused conv stack (`conv_impl="fused"`, K7) and the
blocked stack against the JAX package — the kernel's plain version
against the TPU kernel (Pallas in interpret mode), the fused and blocked
streaming stacks, the fast staged step and the arena with
conv_impl="fused"."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models import encoder as jenc
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.ops.pallas import encoder as jfused
from vap_realtime_tpu.runtime import incremental as jinc
from vap_realtime_tpu.runtime.arena import StreamArena as JaxArena
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.models import encoder as tenc
from vap_realtime_tpu_torch.ops.cuda import encoder as tfused
from vap_realtime_tpu_torch.runtime import incremental as tinc
from vap_realtime_tpu_torch.runtime.arena import StreamArena
from vap_realtime_tpu_torch.weights.convert import params_to_torch

# the fused kernel is written for the encoder's 256 channels; a short
# context and one stereo layer keep the trunk small
SMALL = dict(dim=256, encoder_dim=256, num_heads=4, frame_hz=20,
             context_len_sec=1.0, cross_layers=1)
T_ = torch.as_tensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and timing-sensitive socket tests share the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    jc = jcfg.VapConfig(**SMALL)
    init = jax.jit(init_vap_params, static_argnums=1)
    return jc, jax.tree_util.tree_map(np.asarray,
                                      init(jax.random.PRNGKey(4), jc))


def _frames(n, f, seed):
    rs = np.random.RandomState(seed)
    return [(0.1 * rs.randn(n, 800)).astype(np.float32) for _ in range(f)]


def _random_carries(n, seed, dtype=np.float32):
    """Non-zero carries, so the first frame already reads them."""
    rs = np.random.RandomState(seed)
    st = {"c0": 0.1 * rs.randn(n, 1, 5)}
    for i, (k, s) in enumerate(jfused.TAIL_KS, start=1):
        st[f"c{i}"] = np.abs(rs.randn(n, k - s, 256))
    return {k: v.astype(dtype) for k, v in st.items()}


@pytest.mark.parametrize("mode", ["merge8", "taps20"])
def test_fused_plain_matches_pallas_kernel_f32(mode):
    """cpc_conv_stack_streaming_fused (CPU: the kernel's plain version)
    against the TPU kernel in interpret mode, 3 frames with carried
    state: features and every carry to atol 2e-5 (tests/test_pallas.py:
    238-245)."""
    _, jp = _params()
    enc_j, enc_t = jp["encoder"], params_to_torch(jp["encoder"])
    n = 4
    st_np = _random_carries(n, 1)
    st_j = {k: jnp.asarray(v) for k, v in st_np.items()}
    st_t = {k: T_(v) for k, v in st_np.items()}
    for f, new in enumerate(_frames(n, 3, 2)):
        z_j, st_j = jfused.cpc_conv_stack_streaming_fused(
            enc_j, jnp.asarray(new), st_j, mode=mode)
        z_t, st_t = tfused.cpc_conv_stack_streaming_fused(enc_t, T_(new),
                                                          st_t)
        np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=2e-5,
                                   err_msg=f"{mode} features frame {f}")
        for k in st_j:
            np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                       atol=2e-5, err_msg=f"{k} frame {f}")


def test_fused_plain_matches_pallas_kernel_bf16():
    """The same in bf16 (activations, carries and conv weights bf16; bias
    and norm stats float32): both accumulate bf16 products in float32 and
    round the same ops to bf16, so they differ only where float32 sums
    taken in another order move a value across a bf16 rounding boundary,
    and such a flip travels on through the later layers.  Held at atol
    and rtol 2^-6 (two bf16 steps at 1); measured max |d| 2^-6 over
    3 x 4 x 5 x 256 features (one bf16 step at a value in [2, 4)),
    carries c0 exact."""
    _, jp = _params()
    enc_j = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   jp["encoder"])
    enc_t = params_to_torch(jp["encoder"], dtype=torch.bfloat16)
    n = 4
    st_np = _random_carries(n, 3)
    st_j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in st_np.items()}
    st_t = {k: T_(v).to(torch.bfloat16) for k, v in st_np.items()}
    for f, new in enumerate(_frames(n, 3, 4)):
        z_j, st_j = jfused.cpc_conv_stack_streaming_fused(
            enc_j, jnp.asarray(new, jnp.bfloat16), st_j)
        z_t, st_t = tfused.cpc_conv_stack_streaming_fused(
            enc_t, T_(new).to(torch.bfloat16), st_t)
        assert z_t.dtype == torch.bfloat16
        want = np.asarray(z_j.astype(jnp.float32))
        np.testing.assert_allclose(z_t.float().numpy(), want, atol=2 ** -6,
                                   rtol=2 ** -6, err_msg=f"frame {f}")
        np.testing.assert_array_equal(
            st_t["c0"].float().numpy(),
            np.asarray(st_j["c0"].astype(jnp.float32)))
        for k in ("c1", "c2", "c3", "c4"):
            np.testing.assert_allclose(
                st_t[k].float().numpy(),
                np.asarray(st_j[k].astype(jnp.float32)), atol=2 ** -6,
                rtol=2 ** -6, err_msg=f"{k} frame {f}")


@pytest.mark.parametrize("impl", ["fused", "blocked"])
def test_stack_matches_port_conv_stack_f32(impl):
    """The fused and blocked stacks against the port's own `conv` stack in
    float32, 3 frames with carries: features and carries to atol 2e-5."""
    _, jp = _params()
    enc = params_to_torch(jp["encoder"])
    stack = {"fused": tfused.cpc_conv_stack_streaming_fused,
             "blocked": tenc.cpc_conv_stack_streaming_blocked}[impl]
    st_np = _random_carries(3, 5)
    st_a = {k: T_(v) for k, v in st_np.items()}
    st_b = {k: T_(v) for k, v in st_np.items()}
    for f, new in enumerate(_frames(3, 3, 6)):
        z_a, st_a = stack(enc, T_(new), st_a)
        z_b, st_b = tenc.cpc_conv_stack_streaming(enc, T_(new), st_b)
        np.testing.assert_allclose(z_a.numpy(), z_b.numpy(), atol=2e-5,
                                   err_msg=f"{impl} frame {f}")
        for k in st_b:
            np.testing.assert_allclose(st_a[k].numpy(), st_b[k].numpy(),
                                       atol=2e-5, err_msg=f"{k} frame {f}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_matches_jax(dtype):
    """cpc_conv_stack_streaming_blocked against the JAX function, 3
    frames with carries.  float32: atol 1e-5.  bf16 (conv0 an NCW conv
    rounded to bf16, the later matmuls float32-accumulated, the affine in
    float32): atol and rtol 2^-6, as the fused bf16 check."""
    _, jp = _params()
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    enc_j = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jd),
                                   jp["encoder"])
    enc_t = params_to_torch(jp["encoder"], dtype=td)
    st_np = _random_carries(4, 7)
    st_j = {k: jnp.asarray(v, jd) for k, v in st_np.items()}
    st_t = {k: T_(v).to(td) for k, v in st_np.items()}
    tol = dict(atol=1e-5) if dtype == "float32" else dict(atol=2 ** -6,
                                                          rtol=2 ** -6)
    for f, new in enumerate(_frames(4, 3, 8)):
        z_j, st_j = jenc.cpc_conv_stack_streaming_blocked(
            enc_j, jnp.asarray(new, jd), st_j)
        z_t, st_t = tenc.cpc_conv_stack_streaming_blocked(
            enc_t, T_(new).to(td), st_t)
        assert z_t.dtype == td
        np.testing.assert_allclose(
            z_t.float().numpy(), np.asarray(z_j.astype(jnp.float32)),
            err_msg=f"frame {f}", **tol)
        for k in st_j:
            np.testing.assert_allclose(
                st_t[k].float().numpy(),
                np.asarray(st_j[k].astype(jnp.float32)),
                err_msg=f"{k} frame {f}", **tol)


def test_fast_step_fused_matches_jax():
    """fast_step(conv_impl="fused", slots="staged", attend_impl="kernel")
    against JAX fast_step(conv_impl="fused", attend_impl="pallas"), both
    TPU kernels in interpret mode, 12 frames past a merge with mixed
    activity: p_now / p_future / vad to atol 1e-4, stamps equal, conv
    carries to atol 1e-5."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**SMALL)
    tp = params_to_torch(jp)
    Bs = 3
    jstep = jax.jit(functools.partial(jinc.fast_step, cfg=jc, slots="staged",
                                      attend_impl="pallas",
                                      conv_impl="fused"))
    js = jinc.init_fast_state(jc, Bs, staged=True, conv_impl="fused")
    ts = tinc.init_fast_state(tc, Bs, staged=True, conv_impl="fused")
    rs = np.random.RandomState(9)
    for f in range(12):
        new = (0.1 * rs.randn(Bs, 2, jc.frame_shift)).astype(np.float32)
        act = np.array([True, f % 2 == 0, f % 3 != 0])
        js, jo = jstep(jp, js, jnp.asarray(new), active=jnp.asarray(act))
        ts, to = tinc.fast_step(tp, ts, T_(new), tc, T_(act), slots="staged",
                                attend_impl="kernel", conv_impl="fused")
        for k in ("p_now", "p_future", "vad"):
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        np.testing.assert_array_equal(ts.kv.stamp.numpy(),
                                      np.asarray(js.kv.stamp))
        for k in js.conv:
            np.testing.assert_allclose(ts.conv[k].numpy(),
                                       np.asarray(js.conv[k]), atol=1e-5,
                                       err_msg=f"{k} frame {f}")


def test_arena_fused_matches_jax_arena():
    """StreamArena(conv_impl="fused") against the JAX arena with the same
    lifecycle (add, partial ticks, a slot reset): every served output to
    atol 1e-4."""
    jc, jp = _params()
    ja = JaxArena(jc, jp, capacity=3, path="fast", attend_impl="pallas",
                  conv_impl="fused")
    ta = StreamArena(tcfg.VapConfig(**SMALL), jp, capacity=3, path="fast",
                     conv_impl="fused", device="cpu")
    ja.warmup()
    ta.warmup()
    slots = [ja.add_stream() for _ in range(2)]
    assert [ta.add_stream() for _ in range(2)] == slots
    rs = np.random.RandomState(10)
    for tick in range(10):
        if tick == 6:
            ja.reset_slots([slots[1]])
            ta.reset_slots([slots[1]])
        feed = [s for i, s in enumerate(slots) if (tick + i) % 3 != 1]
        chunks = {s: (0.1 * rs.randn(2, ta.chunk_samples))
                  .astype(np.float32) for s in feed}
        out_j, out_t = ja.step(chunks), ta.step(chunks)
        for s in feed:
            for k in ("p_now", "p_future", "vad"):
                np.testing.assert_allclose(out_t[s][k], out_j[s][k],
                                           atol=1e-4,
                                           err_msg=f"{k} slot {s} tick {tick}")


def test_wrapper_cpu_dispatch_and_checks():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; any other non-CUDA device raises instead of falling back;
    packed operands are cached per params and dtype."""
    _, jp = _params()
    enc = params_to_torch(jp["encoder"])
    packed = tfused.pack_fused_params(enc, torch.float32)
    assert tfused.pack_fused_params(enc, torch.float32) is packed
    st = {k: T_(v) for k, v in _random_carries(2, 11).items()}
    new = T_(_frames(2, 1, 12)[0])
    args = (st["c0"][:, 0], new, tuple(st[f"c{i}"] for i in range(1, 5)),
            *packed)
    before = tfused.conv_stack_fused.launches
    got, want = (tfused.conv_stack_fused(*args),
                 tfused.conv_stack_fused_plain(*args))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert tfused.conv_stack_fused.launches == before
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.conv_stack_fused(meta(args[0]), meta(new),
                                tuple(map(meta, args[2])),
                                *map(meta, packed[:1]),
                                tuple(map(meta, packed[1])), meta(packed[2]))


def _conv1_tile(B, L, m0, y0, stats, c1, w, b):
    """conv1's A operand for the tile at xm row m0 as the producer warps
    build it: per X1 row block cb the TILE_ROWS rows `conv1_a_rows` names
    (a conv0 row from its products y0 (B, T0, C) float32, its stored (mean,
    rstd) and conv0's norm w, b (C,) in the activation dtype; a c1 row; or
    zeros), which fill W[0]'s half of K as they are and W[1]'s one row up,
    its last row zero.  Returns (A0, A1), each (TILE_ROWS, 4 C)."""
    mean, rstd = stats
    rows = tfused.TILE_ROWS
    a0 = torch.zeros(rows, 4 * 256, dtype=c1.dtype)
    a1 = torch.zeros_like(a0)
    for cb in range(4):
        kind, n, t = tfused.conv1_a_rows(B, L, m0, cb)
        built = torch.zeros(rows, 256, dtype=c1.dtype)
        conv, car = kind == 1, kind == -1
        built[conv] = tfused._cnorm_apply(
            y0[n[conv], t[conv]], mean[n[conv], t[conv]],
            rstd[n[conv], t[conv]], w, b, c1.dtype)
        built[car] = c1[n[car], t[car]]
        a0[:, 256 * cb:256 * (cb + 1)] = built
        a1[:rows - 1, 256 * cb:256 * (cb + 1)] = built[1:]
    return a0, a1


def _emulate_hopper_body(c0, new, carries, w0, wts, aux):
    """Plain-torch emulation of the bf16 body's data path (any dtype):
    conv0 stores each row's (mean, rstd), the new c1 and the carries into
    X2..X4's first rows; conv1's A operand is built from conv0's products,
    those statistics and c1 (`_conv1_tile`), and held bit-equal to the
    boxes of the stored X1 = [c1 | conv0 rows] that TMA would read (the
    stride-block rows of all streams, the junk row that straddles two
    streams, zeros past the last one), but for W[1]'s last row, whose
    output row the tile drops; each tail layer takes tiles of `rows`
    output rows m (TILE_ROWS computed, conv1's last dropped) with A =
    xm[m0 : m0 + 128] and xm[m0 + 1 : m0 + 129] against the kernel-private
    W^T, and the epilogue writes row m = n (T_out + 1) + t to the next
    input's row n (T_out + 2) + 2 + t (z: n T_out + t), dropping the junk
    rows t = T_out and the ragged rows m >= M."""
    B, L = new.shape
    dt, f32 = new.dtype, torch.float32
    xc0 = torch.cat([c0.to(dt), new], dim=-1)
    y0 = (torch.matmul(tfused.conv0_patches(xc0).to(f32), w0.to(f32))
          + aux[0])
    stats = tfused._cnorm_stats(y0)
    w, b = aux[1].to(dt), aux[2].to(dt)
    c1 = carries[0].to(dt)
    # never stored by the kernel: only to hold the built tiles against
    x1 = torch.cat([c1, tfused._cnorm_apply(y0, *stats, w, b, dt)], dim=1)
    geo = tfused.layer_geometry(B, L)
    xs = [x1]
    for li, g in enumerate(geo[:3]):
        buf = torch.full((B, g["T_out"] + 2, 256), float("nan"), dtype=dt)
        buf[:, :2] = carries[li + 1].to(dt)
        xs.append(buf)
    z = torch.full((B, geo[-1]["T_out"], 256), float("nan"), dtype=dt)
    outs = [n.reshape(B, -1, 256) for n in xs[1:]] + [z]
    new_carries = [xc0[:, -5:], tfused._cnorm_apply(
        y0[:, -4:], stats[0][:, -4:], stats[1][:, -4:], w, b, dt)]
    R = tfused.TILE_ROWS
    for li, (g, Wt) in enumerate(zip(geo, tfused.hopper_weights(wts))):
        M, T, half, tr = g["M"], g["T_out"], g["s"] * 256, g["rows"]
        xm = xs[li].reshape(M, half)
        end = g["tiles"] * tr + R + 1
        xz = torch.cat([xm, torch.zeros(end - M, half, dtype=dt)])
        Wt = Wt.to(f32)
        cn = 2 if li < 3 else 0
        flat = outs[li].reshape(-1, 256)
        for m0 in range(0, g["tiles"] * tr, tr):
            a0, a1 = xz[m0:m0 + R], xz[m0 + 1:m0 + R + 1]
            if li == 0:
                b0, b1 = _conv1_tile(B, L, m0, y0, stats, c1, w, b)
                assert torch.equal(b0, a0), m0
                assert torch.equal(b1[:R - 1], a1[:R - 1]), m0
                a0, a1 = b0, b1
            y = (torch.matmul(a0.to(f32), Wt[:, :half].T)
                 + torch.matmul(a1.to(f32), Wt[:, half:].T)
                 + aux[3 * (li + 1)])
            o = tfused._cnorm_relu(y, aux[3 * (li + 1) + 1].to(dt),
                                   aux[3 * (li + 1) + 2].to(dt), dt)
            m = torch.arange(m0, m0 + R)
            n, t = m // (T + 1), m % (T + 1)
            keep = (m < min(M, m0 + tr)) & (t < T)
            flat[(n * (T + cn) + cn + t)[keep]] = o[keep]
        if li < 3:
            new_carries.append(outs[li][:, -2:].clone())
    return z, tuple(new_carries)


def _hold_emulation_to_plain(n, L, dtype, seed):
    """Three frames of `_emulate_hopper_body` (in PIECE-sample pieces
    past the bf16 body's 1600 samples, as the wrapper runs them) against
    conv_stack_fused_plain over the whole frame, each carrying its own
    state: float32 at atol 1e-6; bf16 at |d| <= 2^-6 (1 + |plain|),
    chip_smoke.py's kernel tolerance."""
    _, jp = _params()
    td = getattr(torch, dtype)
    enc = params_to_torch(jp["encoder"], dtype=td)
    w0, wts, aux = tfused.pack_fused_params(enc, td)
    st = {k: T_(v).to(td) for k, v in _random_carries(n, seed).items()}
    st_e = st_p = (st["c0"][:, 0], *(st[f"c{i}"] for i in range(1, 5)))
    piece = tfused.piece_samples(L, lambda s: s <= 1600)
    rs = np.random.RandomState(seed + 1)
    for f in range(3):
        new = T_((0.1 * rs.randn(n, L)).astype(np.float32)).to(td)
        z_e, st_e = tfused.in_pieces(_emulate_hopper_body, st_e[0], new,
                                     st_e[1:], w0, wts, aux, piece)
        z_p, st_p = tfused.conv_stack_fused_plain(st_p[0], new, st_p[1:],
                                                  w0, wts, aux)
        for name, a, b in [("z", z_e, z_p)] + [
                (f"c{i}", a, b) for i, (a, b) in enumerate(zip(st_e, st_p))]:
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.isfinite(a.float()).all(), f"{name} frame {f}"
            d = (a.float() - b.float()).abs()
            tol = (1e-6 if dtype == "float32"
                   else 2 ** -6 * (1 + b.float().abs()))
            assert bool((d <= tol).all()), (
                f"L={L} {dtype} {name} frame {f}: max |d| "
                f"{d.max().item():.3e}")


@pytest.mark.parametrize("L,dtype", [(320, "float32"), (800, "float32"),
                                     (1600, "float32"), (800, "bfloat16")])
def test_hopper_layout_emulation_matches_plain(L, dtype):
    """The bf16 body's data path (conv1's A tiles built from the samples
    and conv0's stored statistics, each bit-equal to the X1 box it
    replaces but for the row its tile drops; the W^T repack, M stacked over all channel-streams with its
    masked ragged last tile, the stride-block A views with their dropped
    junk rows), emulated in plain torch, against conv_stack_fused_plain:
    B = 13 (ragged against the 128-row tiles at every L), three frames
    carrying state."""
    _hold_emulation_to_plain(13, L, dtype, 13)


@pytest.mark.parametrize("n,L", [(13, 800), (13, 1600), (13, 3200),
                                 (3, 3200)])
def test_hopper_conv1_build_matches_plain_bf16(n, L):
    """conv1's A tiles built from the samples, in bf16 at the frames the
    serving cells run (20, 10 and 5 Hz; 3200 samples in four 800-sample
    body calls with the carries threaded): every tile bit-equal to the
    stored X1's box (but for the row its tile drops), with the row that
    straddles two streams and the
    ragged last tile (n = 3: one tile, mostly past the last stream); the
    stack's outputs and carries against the plain version over the whole
    frame."""
    _hold_emulation_to_plain(n, L, "bfloat16", 17)


def test_layer_geometry_and_weight_traffic():
    """layer_geometry at the serving shape (8192 channel-streams x 800
    samples): M = N (T_out + 1) per layer, tiles of 128 output rows (127
    for conv1) with only the last one ragged, and the L2 weight bytes per
    call those tiles imply; the W^T repack is cached per weight tensor."""
    geo = tfused.layer_geometry(8192, 800)
    assert [g["T_out"] for g in geo] == [40, 20, 10, 5]
    assert [g["rows"] for g in geo] == [127, 128, 128, 128]
    for g in geo:
        assert g["M"] == 8192 * (g["T_out"] + 1)
        assert (g["tiles"] - 1) * g["rows"] < g["M"] <= g["tiles"] * g["rows"]
    assert [g["tiles"] for g in geo] == [2645, 1344, 704, 384]
    assert tfused.weight_l2_bytes(8192, 800) == sum(
        t * k * 256 * 2 for t, k in zip([2645, 1344, 704, 384],
                                        [2048, 1024, 1024, 1024]))
    assert tfused.CUDA_LAUNCHES == {torch.float32: 1, torch.bfloat16: 5}
    _, jp = _params()
    _, wts, _ = tfused.pack_fused_params(params_to_torch(jp["encoder"]),
                                         torch.float32)
    wt = tfused.hopper_weights(wts)
    assert all(a is b for a, b in zip(wt, tfused.hopper_weights(wts)))
    for W, Wt in zip(wts, wt):
        assert Wt.is_contiguous()
        assert torch.equal(Wt, W.reshape(-1, 256).T)
