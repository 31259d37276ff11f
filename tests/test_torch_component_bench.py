"""PyTorch port: the component bench and its cache-read floor (K12) — the
plain version of `cache_read_all` against the numpy statement of the TPU
kernel's body, `conv1d_im2col` against the JAX tool's, and the tool on
the CPU over every stage.

The TPU kernel `read_all` (tools/component_bench.py:393) is a closure
inside the JAX tool's `main()`, so nothing can call it: its body
`_sum_kernel` adds float32(cache) over every (Bb, 1, T, 4D) phase block of
the grid into one (1, 4D) float32 row, which numpy states as a sum over
(B, P, T)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.ops.cuda.lab import (
    cache_read_all, cache_read_all_plain,
)
from vap_realtime_tpu_torch.tools import component_bench as port_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_cache_read_plain_matches_numpy(dtype):
    """(B, P, T, 4D) -> (1, 4D) float32 column sums, bf16 / float32 /
    int8, against the float64 numpy sum at rtol 1e-5 (float32 sums in
    another order); the wrapper runs the plain version on the CPU and
    counts no launch."""
    rs = np.random.RandomState(0)
    shape = (6, 7, 10, 64)
    if dtype == torch.int8:
        cache = torch.as_tensor(rs.randint(-127, 128, shape).astype(np.int8))
    else:
        cache = torch.as_tensor(rs.randn(*shape).astype(np.float32)).to(dtype)
    want = cache.float().numpy().astype(np.float64).sum((0, 1, 2))[None]
    got = cache_read_all(cache)
    assert got.shape == (1, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, cache_read_all_plain(cache))
    assert cache_read_all.launches == 0


def test_conv1d_im2col_matches_jax():
    """The unfold + matmul conv against the JAX tool's patches + matmul
    at every CPC conv's kernel, stride and padding, float32, 1e-5."""
    spec = importlib.util.spec_from_file_location(
        "jax_component_bench",
        os.path.join(REPO, "tools", "component_bench.py"))
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    rs = np.random.RandomState(1)
    for k, s, p in ((10, 5, 3), (8, 4, 2), (4, 2, 1)):
        x = rs.randn(3, 16, 120).astype(np.float32)
        w = rs.randn(24, 16, k).astype(np.float32) * 0.1
        b = rs.randn(24).astype(np.float32)
        want = np.asarray(jax_bench.conv1d_im2col(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s, p))
        got = port_bench.conv1d_im2col(torch.as_tensor(x),
                                       torch.as_tensor(w),
                                       torch.as_tensor(b), s, p)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_component_bench_every_stage_on_cpu(capsys):
    """main(--device cpu --batch 4 --stages <every stage>): every stage
    reports a time (those by difference from the stages they need)."""
    res = port_bench.main(["--device", "cpu", "--batch", "4", "--iters",
                           "1", "--stages", ",".join(port_bench.STAGES)])
    assert set(res) == set(port_bench.STAGES)
    assert all(np.isfinite(v) for v in res.values())
    assert all(res[s] > 0 for s in port_bench.STAGES
               if s not in port_bench.DIFFERENCES and s != "opchain")
    err = capsys.readouterr().err
    assert "(by difference)" in err and "cpu" in err
