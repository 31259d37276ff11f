"""PyTorch port: the attend-lab ablations (K11) — `attend_lab_plain` in
every mode against the JAX lab's `launch` over the same body, and the
lab's production variants through `attend_pair` — on the same numpy
inputs, float32; and the port's lab tool on the CPU.

The JAX lab (tools/attend_lab.py) has no interpret flag: its module's
`pl` is replaced by a shim whose `pallas_call` runs in interpret mode,
so the TPU bodies run on the CPU unchanged."""

import functools
import importlib.util
import math
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vap_realtime_tpu_torch.ops.cuda.attend import attend_pair
from vap_realtime_tpu_torch.ops.cuda.attend_lab import (
    attend_lab, attend_lab_plain,
)
from vap_realtime_tpu_torch.tools import attend_lab as port_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
B, P, D, H, BB = 16, 3, 256, 4, 8
SCALE = 1.0 / math.sqrt(D)


@pytest.fixture(scope="module")
def jax_lab():
    """tools/attend_lab.py, imported by path, its Pallas calls in
    interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_attend_lab", os.path.join(REPO, "tools", "attend_lab.py"))
    lab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lab)
    lab.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return lab


# bf16exp rounds its exp argument, its weights and its value products to
# bf16.  Within one jit, XLA on the CPU drops such roundings between
# float32 ops unless excess precision is switched off, which only a fresh
# process can do: the reference runs there.
_BF16EXP_REF = """
import functools, importlib.util, sys, types
import jax, jax.numpy as jnp, numpy as np
from jax.experimental import pallas as pl
jax.config.update("jax_default_matmul_precision", "highest")
spec = importlib.util.spec_from_file_location("lab", sys.argv[1])
lab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(lab)
lab.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec, pallas_call=
    functools.partial(pl.pallas_call, interpret=True))
x = dict(np.load(sys.argv[2]))
kern = functools.partial(lab._k_bcast_mode, H=int(x["H"]),
                         scale=float(x["scale"]), mode="bf16exp")
out = {}
for T in (10, 50):
    a = [jnp.asarray(x[f"{n}{T}"]) for n in ("cache", "q", "kc", "vc", "age")]
    out[f"out{T}"] = np.asarray(lab.launch(kern, *a, 1, int(x["Bb"])))
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def bf16exp_want(tmp_path_factory):
    """The JAX lab's bf16exp body at T = 10 and 50, with every bf16
    rounding kept (XLA_FLAGS=--xla_allow_excess_precision=false)."""
    tmp = tmp_path_factory.mktemp("bf16exp")
    arrays = dict(H=H, scale=SCALE, Bb=BB)
    for T in (10, 50):
        for n, x in zip(("cache", "q", "kc", "vc", "age"), _inputs(T, T)):
            arrays[f"{n}{T}"] = x
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _BF16EXP_REF,
                    os.path.join(REPO, "tools", "attend_lab.py"),
                    str(tmp / "in.npz"), str(tmp / "out.npz")],
                   env=env, check=True, timeout=300)
    out = np.load(tmp / "out.npz")
    return {T: out[f"out{T}"] for T in (10, 50)}


def _inputs(T, seed, int8=False):
    """A (B, P, T, 4D) cache (float32, or int8 codes), q / kc / vc (B, 2D)
    and live ages in [1, T), made from a seed."""
    rs = np.random.RandomState(seed)
    if int8:
        cache = rs.randint(-127, 128, (B, P, T, 4 * D)).astype(np.int8)
    else:
        cache = (rs.randn(B, P, T, 4 * D) * 0.3).astype(np.float32)
    q, kc, vc = (rs.randn(3, B, 2 * D) * 0.3).astype(np.float32)
    age = rs.randint(1, T, (B, T)).astype(np.float32)
    return cache, q, kc, vc, age


# the JAX body of each port mode (and whether it reads int8 codes)
BODIES = {
    "dma": (lambda lab: lab._k_dma, False),
    "q8dma": (lambda lab: lab._k_q8dma, True),
    "mxu": (lambda lab: lab._k_mxu, False),
    "q8glb": (lambda lab: lab._k_q8glb, True),
    "v5": (lambda lab: lab._k_v5, False),
    **{m: (lambda lab, m=m: functools.partial(lab._k_bcast_mode, mode=m),
           False)
       for m in ("nomax", "noexp", "f32out", "nodenom", "noout",
                 "bf16exp")},
}


def _noexp_denominators(cache, q, kc, age, phase):
    """min |sum_t min(s, 60) + min(s_cur, 60)| of the noexp body."""
    kv = torch.as_tensor(cache[:, phase])
    qt, kct = torch.as_tensor(q), torch.as_tensor(kc)
    m = torch.exp2(-8.0 * (torch.arange(H) + 1.0) / H)
    worst = math.inf
    for s in (0, 1):
        k = kv[:, :, 2 * s * D:(2 * s + 1) * D]
        qs, kcs = qt[:, s * D:(s + 1) * D], kct[:, s * D:(s + 1) * D]
        sc = (k * qs[:, None]).view(B, -1, H, 64).sum(-1) * SCALE \
            - torch.as_tensor(age)[..., None] * m
        s_cur = (kcs * qs).view(B, H, 64).sum(-1) * SCALE
        den = sc.clamp(max=60).sum(1) + s_cur.clamp(max=60)
        worst = min(worst, den.abs().min().item())
    return worst


@pytest.mark.parametrize("T", [10, 50])
@pytest.mark.parametrize("variant", sorted(BODIES))
def test_plain_matches_jax_lab(jax_lab, request, variant, T):
    """Each ablated body's plain version against the JAX lab's `launch`
    in interpret mode, phase 1, at atol 1e-5; noexp and nodenom at rtol
    1e-5 as well (their sums are large or can cross 0: noexp's q and kc
    are scaled down, so its denominators, sums of the ages' bias, stay
    away from 0, and this is checked); bf16exp against a reference that
    keeps its bf16 roundings."""
    make, int8 = BODIES[variant]
    mode = {"q8dma": "dma"}.get(variant, variant)
    cache, q, kc, vc, age = _inputs(T, seed=T, int8=int8)
    if mode == "noexp":
        q, kc = q * 0.1, kc * 0.1
        assert _noexp_denominators(cache, q, kc, age, 1) > 0.05
    if mode == "bf16exp":
        want = request.getfixturevalue("bf16exp_want")[T]
    else:
        kern = functools.partial(make(jax_lab), H=H, scale=SCALE)
        want = np.asarray(jax_lab.launch(
            kern, jnp.asarray(cache), jnp.asarray(q), jnp.asarray(kc),
            jnp.asarray(vc), jnp.asarray(age), 1, BB))
    args = [torch.as_tensor(x) for x in (cache, q, kc, vc, age)]
    got = attend_lab(mode, *args, 1, num_heads=H)
    assert got.shape == (B, 2 * D) and got.dtype == torch.float32
    rtol = 1e-5 if mode in ("noexp", "nodenom") else 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=rtol)
    np.testing.assert_array_equal(
        got.numpy(), attend_lab_plain(mode, *args, 1, num_heads=H).numpy())


@pytest.mark.parametrize("variant", ["bcast", "compact", "q8_row"])
def test_production_variants_match_jax_lab(jax_lab, variant):
    """The lab's production bodies are the serving kernels: `attend_pair`
    (bcast, compact; int8 codes with row scales for q8_row) against the
    JAX lab's `_k_prod` / `_k_q8row` over every phase, at atol 2e-5 (the
    attend's tolerance against the TPU kernel in interpret mode)."""
    T = 50
    cache, q, kc, vc, age = _inputs(T, seed=3, int8=variant == "q8_row")
    rs = np.random.RandomState(4)
    rowscale = (rs.rand(B, T) * 0.02 + 0.01).astype(np.float32)
    if variant == "q8_row":
        kern = functools.partial(jax_lab._k_q8row, H=H, scale=SCALE)
    else:
        kern = functools.partial(jax_lab._k_prod, H=H, scale=SCALE,
                                 compact=variant == "compact")
    view = lambda x: torch.as_tensor(x).view(B, 2, D)
    for ph in range(P):
        want = np.asarray(jax_lab.launch(
            kern, jnp.asarray(cache), jnp.asarray(q), jnp.asarray(kc),
            jnp.asarray(vc), jnp.asarray(age), ph, BB,
            rowscale=jnp.asarray(rowscale) if variant == "q8_row"
            else None))
        got = attend_pair(
            torch.as_tensor(cache), view(q), view(kc), view(vc),
            torch.as_tensor(age), pair_base=2 * ph, num_heads=H,
            impl="compact" if variant == "compact" else "bcast",
            scale=torch.as_tensor(rowscale) if variant == "q8_row"
            else None)
        np.testing.assert_allclose(got.reshape(B, 2 * D).numpy(), want,
                                   atol=2e-5, err_msg=f"phase {ph}")


def test_lab_modes_are_checked():
    cache, q, kc, vc, age = (torch.as_tensor(x) for x in _inputs(10, 0))
    codes = torch.zeros(cache.shape, dtype=torch.int8)
    with pytest.raises(ValueError, match="not in"):
        attend_lab("softmax", cache, q, kc, vc, age, 0)
    with pytest.raises(ValueError, match="int8"):
        attend_lab("v5", codes, q, kc, vc, age, 0)
    with pytest.raises(ValueError, match="int8"):
        attend_lab("q8glb", cache, q, kc, vc, age, 0)


def test_lab_tool_runs_on_cpu(capsys):
    """The port's lab tool on the CPU at a tiny batch, every variant of
    the JAX lab's list (and the port's two-streams-per-block names):
    one ms-per-step line each, launches counted only on the card."""
    variants = ",".join(port_lab.JAX_VARIANTS + ("v5_s2", "q8_glb_s2"))
    res = port_lab.main(["--batch", "4", "--T", "6", "--iters", "1",
                         "--device", "cpu", "--variants", variants])
    assert set(res) == set(variants.split(","))
    assert all(v > 0 for v in res.values())
    assert attend_lab.launches == 0
    out = capsys.readouterr().err
    assert "ms / 7-phase step" in out and "cpu" in out
