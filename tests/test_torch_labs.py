"""PyTorch port: the lab tools `encoder_lab`, `roofline` and `scatter_lab`
on the CPU (their plain versions; their times on the card come from
`chip_smoke.py`): the JAX roofline's counts, the scatter bodies against
numpy, the encoder lab's impls and its refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import roofline as jax_roofline
from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.tools import encoder_lab, roofline, scatter_lab
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_roofline_counts_match_jax(dtype):
    """The three components' FLOP and byte counts equal the JAX tool's
    `build_components` at B = 2, and each component steps once on the
    CPU to a finite carry of the same shapes."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = roofline.DTYPES[dtype]
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt),
                                jax_params(20))
    want = jax_roofline.build_components(
        2, jdt, JaxConfig(frame_hz=20, context_len_sec=2.5), jp)
    got = roofline.build_components(
        2, tdt, cfg, params_to_torch(synthetic_params(20), "cpu", tdt),
        torch.device("cpu"))
    assert list(got) == list(want)
    for name, comp in got.items():
        assert comp.flops == want[name].flops, name
        assert comp.bytes == want[name].bytes, name
        c0 = comp.init()
        c1 = comp.fn(c0)
        leaves = lambda c: [c] if isinstance(c, torch.Tensor) else (
            [c[1]] if name == "kv_step_total" else list(c))
        for a, b in zip(leaves(c1), leaves(c0)):
            assert a.shape == b.shape and torch.isfinite(a.float()).all()


def test_roofline_runs_on_the_cpu(capsys, monkeypatch):
    """main at B = 2 in float32 on the CPU (the peak from 256^3 matmuls,
    to keep the CPU's time short): every component's ms, TFLOP/s, share
    of peak and GB/s finite and positive, the device named."""
    peak = roofline.measure_peak
    monkeypatch.setattr(roofline, "measure_peak",
                        lambda dtype, device, iters: peak(dtype, device, 256,
                                                          iters))
    res = roofline.main(["--batch", "2", "--dtype", "f32", "--iters", "2",
                         "--device", "cpu"])
    assert "cpu (host clock)" in capsys.readouterr().out
    assert res["peak_tflops"] > 0
    for name in ("conv_encoder", "lstm_context", "kv_step_total"):
        assert all(np.isfinite(v) and v > 0 for v in res[name].values())


def _numpy_scatter(name, r, T, S, calls):
    """What `calls` calls of body `name` write, in numpy (float32 copies
    of the bf16 rows each call writes; the stage for stage_w): stream b's
    per-stream count starts at b % 11; an S-row global write starts at
    (g // S * S) % T, clamped to T - S as a dynamic_update_slice."""
    B = r[0].shape[0]
    if name == "stage_w":
        buf = np.zeros((S, B, scatter_lab.P * scatter_lab.D4), np.float32)
    else:
        buf = np.zeros((B, scatter_lab.P, T, scatter_lab.D4), np.float32)
    n, g = np.arange(B) % 11, 0
    for k in range(calls):
        rk = r[k]
        if name == "dus1":
            buf[:, :, g % T] = rk
            g += 1
        elif name == "scat1":
            for b in range(B):
                buf[b, :, n[b] % T] = rk[b]
            n = n + 1
        elif name == "scat8":
            for b in range(B):
                for s in range(S):
                    buf[b, :, (n[b] + s) % T] = rk[b, s]
            n = n + S
        elif name == "stage_w":
            buf[g % S] = rk.reshape(B, -1)
            g += 1
        else:
            base = min((g // S * S) % T, T - S)
            for s in range(S):
                buf[:, :, base + s] = rk[:, s]
            g += S
    return buf


@pytest.mark.parametrize("name", list(scatter_lab.BODIES))
def test_scatter_body_matches_numpy(name):
    """Five calls of each write body at B = 8, T = 10, S = 4 (the ring
    wraps; dus8's third start, 8, is clamped to 6) leave a cache (stage)
    bit-equal to numpy's writes of the same bf16 rows."""
    B, T, S, calls = 8, 10, 4, 5
    carry = scatter_lab.initial(name, B, T, S, "cpu")
    rows = []
    for _ in range(calls):
        rows.append(carry[1].float().numpy().copy())
        carry = scatter_lab.BODIES[name](carry, T, S)
    want = _numpy_scatter(name, rows, T, S, calls)
    np.testing.assert_array_equal(carry[0].float().numpy(), want)
    assert carry[0].dtype == torch.bfloat16 and carry[0].abs().sum() > 0


def test_scatter_lab_main_on_the_cpu(capsys):
    res = scatter_lab.main(["--batch", "8", "--T", "10", "--S", "4",
                            "--iters", "2", "--device", "cpu"])
    assert list(res) == ["dus1", "scat1", "scat8", "stage_w", "dus8"]
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert capsys.readouterr().out.startswith("{'dus1': ")


def test_encoder_lab_impls_on_the_cpu(capsys):
    """All four impls time on the CPU (float32, 6 channel-streams, 20 Hz),
    and one step of each gives the conv impl's output and carries (atol
    1e-4): the lab times the stacks the fast step runs."""
    res = encoder_lab.main(["--impls", "conv,normk,blocked,fused",
                            "--batch", "6", "--dtype", "f32", "--iters",
                            "2", "--device", "cpu"])
    assert list(res) == ["conv", "normk", "blocked", "fused"]
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert "FAILED" not in capsys.readouterr().out
    params = encoder_lab.init_cpc_encoder_params(
        torch.Generator().manual_seed(0))
    x = torch.randn(6, 800, generator=torch.Generator().manual_seed(1)) * 0.1
    st = encoder_lab.init_conv_stream_state(6)
    st = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(2))
          for k, v in st.items()}
    want, want_st = encoder_lab.IMPLS["conv"](params, x, st)
    for impl in ("normk", "blocked", "fused"):
        got, got_st = encoder_lab.IMPLS[impl](params, x, st)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   err_msg=impl)
        for k in want_st:
            np.testing.assert_allclose(got_st[k].numpy(),
                                       want_st[k].numpy(), atol=1e-4,
                                       err_msg=f"{impl} {k}")


@pytest.mark.parametrize("impl", ["fused:merge8", "fused@32",
                                  "fused:taps20:dma", "pallas"])
def test_encoder_lab_refuses_names_it_does_not_have(impl):
    """The JAX tool's fused-kernel variants name k7_ablate; an unknown
    impl lists the four; both before anything runs."""
    match = "k7_ablate" if impl.startswith("fused") else "choose from"
    with pytest.raises(ValueError, match=match):
        encoder_lab.main(["--impls", impl, "--device", "cpu"])


def test_encoder_lab_exits_nonzero_after_a_failed_impl(monkeypatch, capsys):
    """An impl that raises prints FAILED, as in the JAX tool; the others
    still run, and the tool then exits non-zero."""
    def broken(params, new, state):
        raise RuntimeError("no shared memory for this L")

    monkeypatch.setitem(encoder_lab.IMPLS, "fused", broken)
    with pytest.raises(SystemExit) as e:
        encoder_lab.main(["--impls", "fused,conv", "--batch", "2",
                          "--dtype", "f32", "--iters", "1", "--device",
                          "cpu"])
    assert e.value.code and "fused FAILED" in str(e.value.code)
    out = capsys.readouterr().out
    assert "fused   : FAILED RuntimeError: no shared memory" in out
    assert "conv    :" in out and "ms/step" in out
