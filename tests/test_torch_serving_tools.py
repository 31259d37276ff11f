"""PyTorch port: the serving tools on the CPU — hbm_budget's bytes per
stream against the JAX package's state shapes, the capacity probe, and
the serving benchmark through the native server and load generator
(a CPU arena and the host stub)."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.runtime import incremental, streaming
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.tools import (
    capacity_probe, hbm_budget, serving_bench,
)
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_INITS = {"full": streaming.init_stream_state,
             "kv": incremental.init_kv_state,
             "fast": incremental.init_fast_state,
             "hybrid": incremental.init_hybrid_state,
             "fast_hybrid": incremental.init_fast_hybrid_state}
# (label, JAX dtype, port dtype, quant)
MODES = [("bf16", jnp.bfloat16, torch.bfloat16, False),
         ("f32", jnp.float32, torch.float32, False),
         ("q8", jnp.bfloat16, torch.bfloat16, True),
         ("q8g", jnp.bfloat16, torch.bfloat16, "global")]
CASES = [(p, m) for p in hbm_budget.PATHS for m in MODES
         if p != "full" or m[3] is False]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread while this file runs: the suite runs
    several files at once, and the socket runs share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bytes_per_stream(path, dtype, quant, staged) -> int:
    """Bytes per stream of the JAX state: the growth from 8 to 16
    streams over 8 (the JAX states also carry O(1) 0-d leaves, a few
    bytes per state, not per stream)."""
    jc = JaxConfig(frame_hz=20, context_len_sec=2.5)
    kw = {} if path == "full" else dict(quant=quant, staged=staged)

    def total(batch):
        st = jax.eval_shape(lambda: JAX_INITS[path](jc, batch, dtype, **kw))
        return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                   for leaf in jax.tree_util.tree_leaves(st))

    return (total(16) - total(8)) // 8


@pytest.mark.parametrize("path,mode", CASES,
                         ids=[f"{p}-{m[0]}" for p, m in CASES])
def test_hbm_budget_bytes_per_stream_equal_jax(path, mode):
    """Every path / dtype / int8 mode, without and with the stage: the
    port's state tensors hold exactly the JAX state's bytes per stream
    (built on the meta device, nothing allocated)."""
    _, jdt, tdt, quant = mode
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    for staged in ([False] if path == "full" else [False, True]):
        got = hbm_budget.state_bytes(path, cfg, tdt, quant, staged)
        assert got == _jax_bytes_per_stream(path, jdt, quant, staged), staged


def test_hbm_budget_table(capsys):
    """The tool at an explicit 16 GiB prints the JAX tool's KiB per
    stream (fast / kv / full, as `tools/hbm_budget.py` prints them), each
    capacity is (90% of the memory - the bf16 params) // bytes, and the
    staged column adds the (S, P * 4D) stage.  Without --hbm_gb it reads
    the card, and raises where there is none."""
    rows = hbm_budget.main(["--hbm_gb", "16"])
    want = {"fast": [712.2, 1424.2, 363.6, 362.3],
            "kv": [702.2, 1404.2, 353.6, 352.3], "full": [52.0, 104.0]}
    for path, kib in want.items():
        assert [round(r["bytes"] / 1024, 1) for r in rows
                if r["path"] == path] == kib, path
    usable = 16 * 1024**3 * 0.9 - hbm_budget.params_bytes(
        synthetic_params(20))
    for r in rows:
        assert r["cap"] == int(usable // r["bytes"])
        if r["path"] != "full":
            stage = 8 * 7 * 4 * 256 * (1 if "int8" in r["label"] else
                                       2 if r["label"] == "bf16" else 4)
            stage += 8 * 4 + (8 * 7 * 4 if "row" in r["label"] else 0)
            assert r["staged_bytes"] == r["bytes"] + stage, r
    assert "712.2 KiB/stream" in capsys.readouterr().out
    if torch.cuda.is_available():
        assert hbm_budget.main([])
    else:
        with pytest.raises(RuntimeError, match="--hbm_gb"):
            hbm_budget.main([])


def test_capacity_probe_cpu(capsys):
    """--device cpu --batch 4 --ticks 2 builds the arena, warms it and
    times the ticks: one JSON line with ok true; the default device is
    CUDA, which raises where there is no card."""
    res = capacity_probe.main(["--device", "cpu", "--batch", "4",
                               "--ticks", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["ok"] is True
    assert res["ms_per_step"] > 0 and res["streams_if_realtime"] >= 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            capacity_probe.main(["--batch", "4", "--ticks", "2"])


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("argv", [["--device", "cpu"], ["--stub_device"]],
                         ids=["cpu", "stub"])
def test_serving_bench(argv, capsys):
    """The native server over a CPU arena (fast path, bf16, int16 wire)
    or the host stub, 4 loopback streams for 5 s (the generator's 3 s
    ramp included): every connection accepted, results delivered, the
    server's tick split reported; the load generator builds into
    build/vaploadgen and the tracked native/vaploadgen is untouched."""
    tracked = os.path.join(REPO, "native", "vaploadgen")
    before = _sha(tracked)
    report = serving_bench.main(argv + ["--streams", "4", "--seconds", "5"])
    assert _sha(tracked) == before
    assert os.path.exists(os.path.join(REPO, "build", "vaploadgen"))
    (run,) = report["runs"]
    assert run["connected"] == 4 and run["send_errs"] == 0
    assert run["results"] > 0 and run["latency_ms"]["n"] > 0
    assert set(run["server_ms_per_tick"]) == {"dispatch", "fetch", "send"}
    assert report["config"]["cpu_count"] == os.cpu_count()
    assert report["sustained_streams"] in (0, 4)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {
        "sustained_streams": report["sustained_streams"]}


def test_serving_bench_runs_on_cuda_by_default():
    """The device is CUDA unless asked otherwise; without a card the
    bench raises instead of falling back to the CPU."""
    assert serving_bench.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serving_bench.main(["--streams", "4", "--seconds", "1"])
