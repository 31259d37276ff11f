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
    offline runner, WAV IO, the lab kernels and the lab tools included,
    the serving surfaces: the library API, the audio sources, the
    two-port and batched servers, the static step and its export tool,
    the serving tools, the clients, the demo and the examples, and the
    export and checkpoint tools, the web runner's server and the encoder,
    roofline and scatter labs, K5's crossover and ablation tools, the
    staged merge's wrapper, the KV cache's format and the arena's 2-D
    upload copy."""
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
                "tools/attend_lab.py", "tools/component_bench.py",
                "api.py", "io/sources.py", "runtime/cli.py",
                "runtime/server.py", "runtime/server_batched.py",
                "runtime/static.py", "tools/export_static.py",
                "tools/hbm_budget.py", "tools/capacity_probe.py",
                "tools/serving_bench.py", "tools/demo_e2e.py",
                "clients/input_wav.py", "clients/input_mic.py",
                "clients/output_bar.py", "clients/output_console.py",
                "clients/output_gui.py", "clients/visualizer/server.py",
                "examples/example_vap_2wav.py",
                "examples/example_vap_2tcp.py",
                "examples/example_bc_nod.py",
                "tools/convert_checkpoint.py",
                "tools/vap_offline_exported.py", "tools/export_web.py",
                "clients/web_runner/serve.py", "tools/encoder_lab.py",
                "tools/roofline.py", "tools/scatter_lab.py",
                "tools/lstm_bodies.py", "tools/k5_ablate.py",
                "ops/cuda/merge.py", "runtime/cache_format.py",
                "ops/cuda/upload.py"):
        assert pkg + mod in rel, mod


def test_forbidden_pattern():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from vap_realtime_tpu.config import VapConfig",
                 "import vap_realtime_tpu", "from vap_realtime_tpu import x"):
        assert FORBIDDEN.search(line), line
    for line in ("from vap_realtime_tpu_torch.config import VapConfig",
                 "import vap_realtime_tpu_torch"):
        assert not FORBIDDEN.search(line), line
