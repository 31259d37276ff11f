"""PyTorch port: the single-pair KV-step attend (K8, `fused_attend`).  Its
plain versions — `attend_reference` (what the wrapper runs on CPU
tensors) and `fused_attend_plain` (the kernel's v4 math) — against the
TPU kernel in interpret mode and the JAX package's einsum reference.  The
CUDA kernel runs only on the card (chip_smoke.py holds it against both
plain versions there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu.ops.pallas import attend as jatt
from vap_realtime_tpu_torch.ops.cuda.attend import (
    DEAD, attend_reference, fused_attend, fused_attend_plain,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B=8, T=12, P=2, D=256, seed=0):
    """A phase-major cache (B, P, T, 4D), q/k_cur/v_cur (B, D), ages with
    two DEAD rows per stream (tests/test_pallas.py:70-83)."""
    rs = np.random.RandomState(seed)
    cache = (0.3 * rs.randn(B, P, T, 4 * D)).astype(np.float32)
    q, kc, vc = (0.3 * rs.randn(3, B, D)).astype(np.float32)
    age = rs.randint(1, T + 1, size=(B, T)).astype(np.float32)
    age[:, -2:] = 2e9
    return cache, q, kc, vc, age


@pytest.mark.parametrize("slot_k", [0, 2, 4])
def test_single_pair_matches_jax(slot_k):
    """Slot pairs (0,1), (2,3) (the second half of phase 0) and (4,5)
    (phase 1): the port's reference, wrapper and v4 plain form against JAX
    `fused_attend` (interpret) and `attend_reference`, 2e-5."""
    args = _inputs()
    kw = dict(slot_k=slot_k, slot_v=slot_k + 1)
    want_k = np.asarray(jatt.fused_attend(*map(jnp.asarray, args), block=8,
                                          interpret=True, **kw))
    want_r = np.asarray(jatt.attend_reference(*map(jnp.asarray, args), **kw))
    t = [torch.as_tensor(a) for a in args]
    for name, got in (("attend_reference", attend_reference(*t, **kw)),
                      ("fused_attend", fused_attend(*t, **kw)),
                      ("fused_attend_plain", fused_attend_plain(*t, **kw))):
        assert got.shape == (8, 256)
        np.testing.assert_allclose(got.numpy(), want_k, atol=2e-5,
                                   err_msg=f"{name} vs the TPU kernel")
        np.testing.assert_allclose(got.numpy(), want_r, atol=2e-5,
                                   err_msg=f"{name} vs attend_reference")


def test_bf16_plain_forms_agree():
    """In bf16 the two plain forms round at different points (the
    reference casts softmax weights, the v4 form (k - kc) * q and w) and
    agree to bf16 resolution."""
    t = [torch.as_tensor(a) for a in _inputs(seed=1)]
    t = [x.to(torch.bfloat16) for x in t[:4]] + [t[4]]
    kw = dict(slot_k=6, slot_v=7)
    ref = attend_reference(*t, **kw).float()
    v4 = fused_attend_plain(*t, **kw).float()
    assert (ref - v4).abs().max().item() <= 2e-2


def test_all_rows_dead_give_v_cur():
    """Cold start: only the current position is attendable, so the output
    is v_cur (exactly in the v4 form: weights exp2(-inf) = 0, denominator
    1)."""
    cache, q, kc, vc, age = (torch.as_tensor(a) for a in _inputs())
    age = torch.full_like(age, DEAD)
    for fn in (fused_attend, attend_reference):
        np.testing.assert_allclose(fn(cache, q, kc, vc, age, slot_k=0,
                                      slot_v=1).numpy(), vc.numpy(),
                                   atol=2e-5)
    assert torch.equal(fused_attend_plain(cache, q, kc, vc, age, slot_k=4,
                                          slot_v=5), vc)


def test_int8_cache_and_bad_slots_raise():
    """No int8 dequant path (ops/pallas/attend.py:414-415) and k/v must be
    an adjacent pair (:422-423): both raise, on any device."""
    cache, q, kc, vc, age = (torch.as_tensor(a) for a in _inputs())
    codes = torch.zeros(cache.shape, dtype=torch.int8)
    for fn in (fused_attend, fused_attend_plain):
        with pytest.raises(ValueError, match="int8"):
            fn(codes, q, kc, vc, age, slot_k=0, slot_v=1)
        for sk, sv in ((0, 2), (1, 2)):
            with pytest.raises(ValueError, match="pair"):
                fn(cache, q, kc, vc, age, slot_k=sk, slot_v=sv)
