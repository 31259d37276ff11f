"""PyTorch port: the attend kernel's plain version against the TPU
kernel (`fused_attend_pair`, Pallas interpret mode on the CPU) and the
port's einsum attend, plus the wrapper's CPU dispatch."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu.ops.pallas.attend import fused_attend_pair
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.ops.cuda.attend import (
    DEAD, attend_pair, attend_pair_plain,
)
from vap_realtime_tpu_torch.runtime import incremental as tinc

B, P, T, D, H, S = 3, 2, 20, 64, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once, and timing-sensitive socket tests share the
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rows: str, seed: int = 0):
    """Cache/stage rows with live ages in [1, T+S) and, for 'mixed',
    about a third of the rows DEAD; 'dead' = every row DEAD."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    cache, stage = f(B, P, T, 4 * D), f(S, B, P * 4 * D)
    q, kc, vc = f(B, 2, D), f(B, 2, D), f(B, 2, D)
    age = rs.randint(1, T + S, (B, T)).astype(np.float32)
    sage = rs.randint(1, T + S, (S, B)).astype(np.float32)
    if rows == "mixed":
        age[rs.rand(B, T) < 0.35] = DEAD
        sage[rs.rand(S, B) < 0.35] = DEAD
    else:
        age[:] = DEAD
        sage[:] = DEAD
    return cache, q, kc, vc, age, stage, sage


@pytest.mark.parametrize("rows", ["mixed", "dead"])
@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("staged", [False, True])
def test_plain_matches_pallas_kernel(staged, phase, rows):
    cache, q, kc, vc, age, stage, sage = _inputs(rows, seed=phase)
    kw = dict(pair_base=2 * phase, num_heads=H)
    st_j = dict(stage=stage, stage_age=sage) if staged else {}
    want = np.asarray(fused_attend_pair(cache, q, kc, vc, age,
                                        interpret=True, **st_j, **kw))
    T_ = torch.as_tensor
    st_t = (T_(stage), T_(sage)) if staged else (None, None)
    got = attend_pair_plain(T_(cache), T_(q), T_(kc), T_(vc), T_(age),
                            *st_t, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if rows == "dead":                  # only the current position counts
        np.testing.assert_allclose(got, vc, atol=1e-6)


@pytest.mark.parametrize("staged", [False, True])
def test_plain_matches_einsum_attend(staged):
    """The kernel's math equals the softmax/einsum form over the same
    rows (ring + staged + current), per twin set."""
    cache, q, kc, vc, age, stage, sage = _inputs("mixed", seed=4)
    T_ = torch.as_tensor
    cfg = VapConfig(dim=D, num_heads=H)
    st = tinc.KVState(cache=T_(cache), lstm_h=torch.zeros(B, 2, D),
                      lstm_c=torch.zeros(B, 2, D), count=None, stamp=None,
                      step=0, stage=T_(stage) if staged else None)
    reads = (T_(age),) + ((T_(stage), T_(sage)) if staged else (None, None))
    for phase in range(P):
        got = attend_pair_plain(T_(cache), T_(q), T_(kc), T_(vc), *reads,
                                pair_base=2 * phase, num_heads=H)
        want = tinc.ATTENDS["einsum"](st, T_(q), T_(kc), T_(vc), 2 * phase,
                                      reads, cfg.num_heads)
        for s in range(2):
            np.testing.assert_allclose(got[:, s].numpy(), want[:, s].numpy(),
                                       atol=2e-5)


def test_wrapper_cpu_dispatch_and_checks():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing; any other non-CUDA device raises instead of falling back."""
    cache, q, kc, vc, age, stage, sage = _inputs("mixed")
    args = [torch.as_tensor(a) for a in (cache, q, kc, vc, age, stage,
                                         sage)]
    before = attend_pair.launches
    got = attend_pair(*args, pair_base=2, num_heads=H)
    want = attend_pair_plain(*args, pair_base=2, num_heads=H)
    assert torch.equal(got, want)
    assert attend_pair.launches == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        attend_pair(*meta, pair_base=2, num_heads=H)
