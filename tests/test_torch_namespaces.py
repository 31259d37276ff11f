"""PyTorch port: the package namespaces export the JAX package's public
names, the new `ops/basic.py` recurrences (`gru_cell`, `gru`) and
`softmax` match the JAX functions, and importing the package and every
subpackage touches no CUDA and builds no kernel."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu.ops import basic as jax_basic
from vap_realtime_tpu_torch.ops import basic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("clients", "clients.visualizer", "examples", "io", "models",
               "ops", "ops.cuda", "parallel", "runtime", "tools", "train",
               "utils", "weights")
# (subpackage, the JAX package's exports it must also export)
EXPORTS = [
    ("", ["VapConfig", "Vap", "VapEngine", "VapModel", "__version__"]),
    ("ops", ["channel_norm", "conv1d", "gelu", "gru", "gru_cell",
             "layer_norm", "linear", "lstm", "lstm_cell"]),
    ("runtime", ["StreamState", "init_stream_state", "stream_step"]),
    ("weights", ["convert_state_dict", "load_torch_checkpoint",
                 "load_pytree_npz", "save_pytree_npz"]),
    ("models", ["VapModel", "init_vap_params"]),
    ("parallel", ["shard_batch", "replicate"]),
]


def _mod(pkg: str, sub: str):
    return importlib.import_module(pkg + ("." + sub if sub else ""))


@pytest.mark.parametrize("sub,names", EXPORTS,
                         ids=[s or "top" for s, _ in EXPORTS])
def test_subpackage_exports_the_jax_names(sub, names):
    """Each name the JAX subpackage exports is there in the port's and
    is the port's own object (from the port's modules); the JAX
    `parallel` exports `make_mesh`, which has no one-card counterpart:
    the port exports `local_slice` in its place."""
    jax_mod = _mod("vap_realtime_tpu", sub)
    port = _mod("vap_realtime_tpu_torch", sub)
    for name in names:
        assert hasattr(jax_mod, name), name
        obj = getattr(port, name)
        if name != "__version__":
            assert obj.__module__.startswith("vap_realtime_tpu_torch."), name
    if sub == "parallel":
        assert hasattr(jax_mod, "make_mesh")
        assert not hasattr(port, "make_mesh")
        assert port.local_slice(np.arange(8), 1, 2).tolist() == [4, 5, 6, 7]
    if sub == "":
        with pytest.raises(AttributeError):
            port.NoSuchName


def _gru_inputs(seed: int, B=3, T=7, I=5, H=6):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32) * 0.5  # noqa: E731
    return (f(B, T, I), f(B, H), f(3 * H, I), f(3 * H, H), f(3 * H),
            f(3 * H))


@pytest.mark.parametrize("seed", [0, 1])
def test_gru_cell_and_gru_match_jax(seed):
    """gru_cell on one step and gru over T = 7 steps (gate order r, z, n)
    equal the JAX functions at 1e-5, outputs and final state."""
    x, h0, w_ih, w_hh, b_ih, b_hh = _gru_inputs(seed)
    t = [torch.from_numpy(a) for a in (x, h0, w_ih, w_hh, b_ih, b_hh)]
    j = [jnp.asarray(a) for a in (x, h0, w_ih, w_hh, b_ih, b_hh)]
    got = basic.gru_cell(t[0][:, 0], *t[1:]).numpy()
    want = np.asarray(jax_basic.gru_cell(j[0][:, 0], *j[1:]))
    np.testing.assert_allclose(got, want, atol=1e-5)
    ys, h_t = basic.gru(*t)
    jys, jh = jax_basic.gru(*j)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_array_equal(ys[:, -1].numpy(), h_t.numpy())


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_softmax_matches_jax(axis):
    x = np.random.RandomState(3).randn(4, 5, 6).astype(np.float32) * 4
    got = basic.softmax(torch.from_numpy(x), axis=axis).numpy()
    want = np.asarray(jax_basic.softmax(jnp.asarray(x), axis=axis))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_import_touches_no_cuda_and_builds_no_kernel():
    """A fresh interpreter imports the package and every subpackage (and
    the lazy top-level names): CUDA is not initialised and the kernel
    build module is not imported."""
    code = (
        "import importlib, sys, torch\n"
        "import vap_realtime_tpu_torch as v\n"
        f"for s in {SUBPACKAGES!r}:\n"
        "    importlib.import_module('vap_realtime_tpu_torch.' + s)\n"
        "v.Vap, v.VapEngine, v.VapModel\n"
        "print(torch.cuda.is_initialized(),\n"
        "      'vap_realtime_tpu_torch.ops.cuda.build' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False"], r.stdout
