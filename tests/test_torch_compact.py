"""PyTorch port: the compact attend (K10, `attend_impl="kernel3"`, the JAX
package's "pallas3") and the head-free "grouped" attend against the JAX
package — the kernel's plain version against the TPU kernel (Pallas in
interpret mode) and the fast step on ring slots with each cache mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu import config as jcfg
from vap_realtime_tpu.models.vap import init_vap_params
from vap_realtime_tpu.ops.pallas.attend import fused_attend_pair
from vap_realtime_tpu.runtime import incremental as jinc
from vap_realtime_tpu_torch import config as tcfg
from vap_realtime_tpu_torch.ops.cuda.attend import (
    DEAD, attend_pair, attend_pair_plain,
)
from vap_realtime_tpu_torch.runtime import incremental as tinc
from vap_realtime_tpu_torch.weights.convert import params_to_torch

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)
OUT_KEYS = ("p_now", "p_future", "vad")
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
    jc = jcfg.VapConfig(**NARROW)
    init = jax.jit(init_vap_params, static_argnums=1)
    return jc, jax.tree_util.tree_map(np.asarray,
                                      init(jax.random.PRNGKey(5), jc))


# --- the compact body's plain version against the TPU kernel -------------

B, P, T, D, H = 8, 2, 12, 256, 4


def _inputs(seed, int8=False):
    """Phase-major cache (float, or int8 codes with row scales), twin q /
    k_cur / v_cur, ages in [1, T] with about a third DEAD."""
    rs = np.random.RandomState(seed)
    f = lambda *s: (0.3 * rs.randn(*s)).astype(np.float32)
    if int8:
        cache = rs.randint(-127, 128, (B, P, T, 4 * D)).astype(np.int8)
    else:
        cache = f(B, P, T, 4 * D)
    sc = (rs.uniform(0.5, 1.5, (B, P, T)) * 1 / 127).astype(np.float32)
    age = rs.randint(1, T + 1, (B, T)).astype(np.float32)
    age[rs.rand(B, T) < 0.35] = DEAD
    return cache, f(B, 2, D), f(B, 2, D), f(B, 2, D), age, sc


@pytest.mark.parametrize("case", ["float", "int8_row", "dead"])
def test_plain_compact_matches_pallas_kernel(case):
    """attend_pair_plain(impl="compact") against fused_attend_pair(
    impl="compact", interpret=True), both phases, float32: the float
    cache at atol 2e-5, int8 codes with row scales at 2e-4
    (tests/test_pallas.py:126,155); all-DEAD rows give v_cur."""
    cache, q, kc, vc, age, sc = _inputs(seed=1, int8=case == "int8_row")
    if case == "dead":
        age[:] = DEAD
    for phase in range(P):
        kw = dict(pair_base=2 * phase, num_heads=H)
        scale = sc[:, phase] if case == "int8_row" else None
        want = np.asarray(fused_attend_pair(
            cache, q, kc, vc, age, scale=scale, interpret=True,
            impl="compact", **kw))
        got = attend_pair_plain(
            T_(cache), T_(q), T_(kc), T_(vc), T_(age),
            scale=None if scale is None else T_(scale), impl="compact",
            **kw).numpy()
        atol = 2e-4 if case == "int8_row" else 2e-5
        np.testing.assert_allclose(got, want, atol=atol,
                                   err_msg=f"{case} phase {phase}")
        if case == "dead":
            np.testing.assert_allclose(got, vc, atol=1e-7)


def test_compact_with_stage_raises_and_cpu_dispatch():
    """A stage with impl="compact" raises (no staged form, as the TPU
    wrapper asserts); on CPU tensors the wrapper is the plain version and
    launches nothing; an unknown impl raises."""
    cache, q, kc, vc, age, _ = map(T_, _inputs(seed=2))
    stage = torch.zeros(8, B, P * 4 * D)
    sage = torch.full((8, B), DEAD)
    for fn in (attend_pair, attend_pair_plain):
        with pytest.raises(ValueError, match="compact"):
            fn(cache, q, kc, vc, age, stage, sage, pair_base=0,
               impl="compact")
        with pytest.raises(ValueError, match="impl"):
            fn(cache, q, kc, vc, age, pair_base=0, impl="nope")
    before = (attend_pair.launches, attend_pair.compact_launches)
    assert torch.equal(
        attend_pair(cache, q, kc, vc, age, pair_base=2, impl="compact"),
        attend_pair_plain(cache, q, kc, vc, age, pair_base=2,
                          impl="compact"))
    assert (attend_pair.launches, attend_pair.compact_launches) == before


# --- the fast step on ring slots --------------------------------------------

def _run_both(attend_impl, jax_impl, quant, F=24, slots="stream"):
    """fast_step in the port and in JAX over F frames (the T=20 ring
    wraps), mixed activity with a frozen tick; yields per frame."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**NARROW)
    Bs = 3
    jstep = jax.jit(functools.partial(jinc.fast_step, cfg=jc, slots=slots,
                                      attend_impl=jax_impl))
    js = jinc.init_fast_state(jc, Bs, quant=quant)
    tp = params_to_torch(jp)
    ts = tinc.init_fast_state(tc, Bs, quant=quant)
    rs = np.random.RandomState(7)
    for f in range(F):
        new = (0.1 * rs.randn(Bs, 2, jc.frame_shift)).astype(np.float32)
        act = np.array([True, f % 2 == 0, f % 3 != 0]) & (f != 5)
        js, jo = jstep(jp, js, jnp.asarray(new), active=jnp.asarray(act))
        ts, to = tinc.fast_step(tp, ts, T_(new), tc, T_(act), slots=slots,
                                attend_impl=attend_impl)
        yield f, jo, to, js, ts


@pytest.mark.parametrize("quant", [False, "row", "global"])
def test_fast_step_kernel3_matches_pallas3(quant):
    """fast_step(slots="stream", attend_impl="kernel3") against JAX
    "pallas3" (interpret mode) over 24 frames, float32 state with the
    float cache and both int8 modes: p_now / p_future / vad to atol
    1e-4, stamps equal."""
    for f, jo, to, js, ts in _run_both("kernel3", "pallas3", quant):
        for k in OUT_KEYS:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")
        np.testing.assert_array_equal(ts.kv.stamp.numpy(),
                                      np.asarray(js.kv.stamp))


@pytest.mark.parametrize("quant", [False, "global"])
def test_fast_step_grouped_matches_jax(quant):
    """attend_impl="grouped" (plain PyTorch) against JAX "grouped" on
    ring slots, 24 frames: outputs to atol 1e-4."""
    for f, jo, to, _, _ in _run_both("grouped", "grouped", quant):
        for k in OUT_KEYS:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")


def test_fast_step_grouped_staged_matches_jax():
    """"grouped" with slots="staged" (ring + staged rows in one softmax),
    12 frames past a merge: outputs to atol 1e-4."""
    jc, jp = _params()
    tc = tcfg.VapConfig(**NARROW)
    jstep = jax.jit(functools.partial(jinc.fast_step, cfg=jc, slots="staged",
                                      attend_impl="grouped"))
    js = jinc.init_fast_state(jc, 2, staged=True)
    ts = tinc.init_fast_state(tc, 2, staged=True)
    tp = params_to_torch(jp)
    rs = np.random.RandomState(8)
    for f in range(12):
        new = (0.1 * rs.randn(2, 2, jc.frame_shift)).astype(np.float32)
        act = np.array([True, f % 3 != 1])
        js, jo = jstep(jp, js, jnp.asarray(new), active=jnp.asarray(act))
        ts, to = tinc.fast_step(tp, ts, T_(new), tc, T_(act), slots="staged",
                                attend_impl="grouped")
        for k in OUT_KEYS:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")


@pytest.mark.parametrize("impl", ["kernel3", "plain3"])
def test_compact_with_staged_slots_raises(impl):
    """The compact attends have no staged form: slots="staged" raises, as
    the JAX package's "pallas3" does (incremental.py:401-403)."""
    tc = tcfg.VapConfig(**NARROW)
    _, jp = _params()
    st = tinc.init_fast_state(tc, 1, staged=True)
    with pytest.raises(ValueError, match="staged"):
        tinc.fast_step(params_to_torch(jp), st,
                       torch.zeros(1, 2, tc.frame_shift), tc,
                       slots="staged", attend_impl=impl)
