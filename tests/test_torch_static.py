"""The PyTorch port stands alone: no module of `vap_realtime_tpu_torch/`,
and not `chip_smoke.py`, imports JAX or the JAX package."""

import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"import jax|(import|from) vap_realtime_tpu(\.| |$)", re.MULTILINE)


def _port_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO,
                                               "vap_realtime_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = list(_port_files())
    assert os.path.exists(files[0]) and len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            for m in FORBIDDEN.finditer(f.read()):
                bad.append(f"{os.path.relpath(path, REPO)}: {m.group(0)!r}")
    assert not bad, bad


def test_every_port_module_is_scanned():
    """The scan reaches each kernel wrapper and runtime module, those of
    the fused encoder, LSTM scan, engine, conv tail, full-recompute path,
    offline runner, WAV IO, the lab kernels and the lab tools included."""
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    pkg = "vap_realtime_tpu_torch/"
    for mod in ("ops/cuda/attend.py", "ops/cuda/channorm.py",
                "ops/cuda/encoder.py", "ops/cuda/lstm.py",
                "ops/cuda/cpc_conv.py", "models/encoder.py",
                "models/transformer.py", "models/vap.py",
                "runtime/incremental.py", "runtime/streaming.py",
                "runtime/offline.py", "io/audio.py",
                "runtime/arena.py", "runtime/engine.py",
                "runtime/server_native.py", "profile_step.py",
                "ops/cuda/attend_lab.py", "ops/cuda/lab.py",
                "tools/attend_lab.py", "tools/component_bench.py"):
        assert pkg + mod in rel, mod


def test_forbidden_pattern():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from vap_realtime_tpu.config import VapConfig",
                 "import vap_realtime_tpu", "from vap_realtime_tpu import x"):
        assert FORBIDDEN.search(line), line
    for line in ("from vap_realtime_tpu_torch.config import VapConfig",
                 "import vap_realtime_tpu_torch"):
        assert not FORBIDDEN.search(line), line
