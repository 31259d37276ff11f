"""PyTorch port: the export and checkpoint tools and the web runner
against the JAX package's tools on the same inputs (`convert_checkpoint`,
`export_static --dynamic`, `vap_offline_exported`, `export_web`,
`clients/web_runner/`).  The web runner's JavaScript has no runtime here
(no JS engine in this environment): it is checked in a browser only, as
in the JAX package."""

import csv
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import convert_checkpoint as jax_convert
from tools import export_static as jax_export_static
from tools import export_web as jax_export_web
from tools import vap_offline_exported as jax_offline_exported
from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch.clients.web_runner import serve
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io.audio import write_wav
from vap_realtime_tpu_torch.runtime.offline import run_offline
from vap_realtime_tpu_torch.runtime.static import make_static_fn
from vap_realtime_tpu_torch.tools import (
    convert_checkpoint, export_static, export_web, vap_offline_exported,
)
from vap_realtime_tpu_torch.weights.convert import (
    _unflatten, params_to_torch,
)
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_cpc_weights, synthetic_params,
    synthetic_vap_state_dict,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUNNER = os.path.join(REPO, "vap_realtime_tpu", "clients", "web_runner")
NAMES = ("p_now", "p_future", "vad1", "vad2", "e1", "e2", "h", "c")
CTX = 20                                 # the static exports' context


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dynamic_pt2(tmp_path_factory):
    """The port's export tool with --dynamic on the CPU: <out>.pt2."""
    out = str(tmp_path_factory.mktemp("dyn") / "vap")
    export_static.main(["--synthetic_weights", "--out", out, "--dynamic",
                        "--context_frames", "16", "--device", "cpu"])
    return out + ".pt2"


@pytest.fixture(scope="module")
def web_out(tmp_path_factory):
    """export_web of both packages at 20 context frames (the port's
    fixture on the CPU): (port dir, JAX dir)."""
    tmp = tmp_path_factory.mktemp("web")
    ours, theirs = str(tmp / "port" / "artifacts"), str(tmp / "jax")
    export_web.main(["--synthetic_weights", "--context_frames", str(CTX),
                     "--out", ours, "--device", "cpu"])
    jax_export_web.main(["--synthetic_weights", "--context_frames", str(CTX),
                         "--out", theirs])
    return ours, theirs


def test_convert_checkpoint_matches_jax_tool(tmp_path, capsys):
    """convert_checkpoint on the reference's .pt files (the synthetic
    weights through torch.save) writes the JAX tool's npz: the same keys,
    every array bit-equal and of the same dtype, the same parameter
    count."""
    vap, cpc = str(tmp_path / "vap.pt"), str(tmp_path / "cpc.pt")
    torch.save({k: torch.from_numpy(v)
                for k, v in synthetic_vap_state_dict(20).items()}, vap)
    torch.save({"weights": {k: torch.from_numpy(v)
                            for k, v in synthetic_cpc_weights().items()}},
               cpc)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    n = convert_checkpoint.main(["--vap_model", vap, "--cpc_model", cpc,
                                 "--out", ours])
    jax_convert.main(["--vap_model", vap, "--cpc_model", cpc, "--out",
                      theirs])
    log = capsys.readouterr().out.splitlines()
    assert log[0].replace(ours, "X") == log[1].replace(theirs, "X")
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert n == sum(a[k].size for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dynamic_export_matches_jax_at_two_lengths(dynamic_pt2):
    """One --dynamic program, saved and loaded, answers at T = 8 and 24:
    all eight outputs within 1e-5 of the JAX package's dynamic artifact
    (serialised and deserialised) and of the port's eager step, on random
    inputs."""
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    prog = torch.export.load(dynamic_pt2).module()
    p = params_to_torch(synthetic_params(20))
    fn, _ = make_static_fn(cfg, 16, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params(20))
    exp, _ = jax_export_static.export_artifact(
        jp, JaxConfig(frame_hz=20, context_len_sec=2.5), dynamic=True)
    jcall = jax.export.deserialize(exp.serialize()).call
    for T in (8, 24):
        rs = np.random.RandomState(T)
        x = (0.1 * rs.randn(2, 1, cfg.frame_samples)).astype(np.float32)
        ctx = (0.5 * rs.randn(2, 1, T, cfg.dim)).astype(np.float32)
        hc = (0.1 * rs.randn(2, 2, cfg.dim)).astype(np.float32)
        args = (x[0], x[1], ctx[0], ctx[1], hc[0], hc[1])
        targs = tuple(torch.from_numpy(a) for a in args)
        with torch.no_grad():
            got, eager = prog(p, *targs), fn(p, *targs)
        want = jcall(jp, *args)
        for name, a, b, e in zip(NAMES, got, want, eager):
            assert tuple(a.shape) == b.shape, (name, T)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       err_msg=f"{name} T={T} vs JAX")
            np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5,
                                       err_msg=f"{name} T={T} vs eager")


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_offline_exported_matches_jax_tool_and_offline(tmp_path):
    """A 3 s synthetic stereo wav at 20 Hz through the port's .pt2 (context
    20) and through the JAX tool on its StableHLO artifact of the same
    weights: the same header and time column, every cell within 1e-5; the
    last frames within 2e-5 of the port's runtime/offline.py (full path,
    20 context frames) once the buffer fills."""
    audio = synthetic_audio(3 * 16000)
    left, right = str(tmp_path / "l.wav"), str(tmp_path / "r.wav")
    write_wav(left, audio[0], 16000)
    write_wav(right, audio[1], 16000)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    export_static.main(["--synthetic_weights", "--out", ours,
                        "--context_frames", str(CTX), "--device", "cpu"])
    jax_export_static.main(["--synthetic_weights", "--out", theirs,
                            "--context_frames", str(CTX)])
    wavs = ["--input_wav_left", left, "--input_wav_right", right]
    n = vap_offline_exported.main(
        ["--artifact", ours + ".pt2", "--params", ours + ".npz",
         "--filename_output", ours + ".csv", "--device", "cpu"] + wavs)
    jax_offline_exported.main(
        ["--artifact", theirs + ".stablehlo", "--params", theirs + ".npz",
         "--filename_output", theirs + ".csv"] + wavs)
    head, rows = _read_csv(ours + ".csv")
    jhead, jrows = _read_csv(theirs + ".csv")
    assert head == jhead and len(rows) == len(jrows) == n == 59
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    got = np.array(rows, np.float64)
    np.testing.assert_allclose(got, np.array(jrows, np.float64), atol=1e-5)
    cfg = VapConfig(frame_hz=20, context_len_sec=1.0)
    assert cfg.context_frames == CTX
    ref = run_offline(synthetic_params(20), audio, cfg, path="full",
                      device="cpu")
    np.testing.assert_array_equal(got[:, 0], ref["t"])
    np.testing.assert_allclose(got[-3:, 1:3], ref["p_now"][-3:], atol=2e-5)
    np.testing.assert_allclose(got[-3:, 3:5], ref["p_future"][-3:],
                               atol=2e-5)


def test_offline_exported_refuses_a_symbolic_context(dynamic_pt2, tmp_path):
    """A --dynamic program has no context length to start from: the runner
    says so and stops."""
    wav = str(tmp_path / "a.wav")
    write_wav(wav, synthetic_audio(16000)[0], 16000)
    with pytest.raises(SystemExit, match="symbolic context length"):
        vap_offline_exported.main(
            ["--artifact", dynamic_pt2, "--params", "unused.npz",
             "--input_wav_left", wav, "--input_wav_right", wav,
             "--device", "cpu"])


def test_export_web_matches_jax_tool(web_out):
    """weights.bin is byte-identical to the JAX tool's; the manifest's
    params, cfg, atol and self-test inputs are equal and its expected
    outputs within 1e-5; the params rebuilt from weights.bin by the
    manifest's offsets and shapes (no dead bytes) replay the fixture
    through the port's static step at the manifest's atol."""
    ours, theirs = web_out
    with open(os.path.join(ours, "weights.bin"), "rb") as f:
        blob = f.read()
    with open(os.path.join(theirs, "weights.bin"), "rb") as f:
        assert blob == f.read()
    m, jm = (json.load(open(os.path.join(d, "manifest.json")))
             for d in (ours, theirs))
    assert m["params"] == jm["params"] and m["cfg"] == jm["cfg"]
    st, jst = m["selftest"], jm["selftest"]
    assert st["x1"] == jst["x1"] and st["x2"] == jst["x2"]
    assert st["atol"] == jst["atol"] and st["seed_note"] == jst["seed_note"]
    for k, v in jst["expected"].items():
        np.testing.assert_allclose(st["expected"][k], v, atol=1e-5,
                                   err_msg=k)

    w = np.frombuffer(blob, dtype="<f4")
    flat = {}
    for name, meta in m["params"].items():
        size = int(np.prod(meta["shape"])) if meta["shape"] else 1
        flat[name] = w[meta["offset"]:meta["offset"] + size].reshape(
            meta["shape"])
    assert sum(v.size for v in flat.values()) == w.size
    cfg = VapConfig(frame_hz=m["cfg"]["frame_hz"])
    fn, ex = make_static_fn(cfg, m["cfg"]["context_frames"], device="cpu")
    x1 = torch.tensor(st["x1"], dtype=torch.float32)[None]
    x2 = torch.tensor(st["x2"], dtype=torch.float32)[None]
    with torch.no_grad():
        p_now, p_fut, v1, v2, e1, _, _, _ = fn(
            params_to_torch(_unflatten(flat)), x1, x2, *ex[2:])
    exp, atol = st["expected"], st["atol"]
    np.testing.assert_allclose(p_now.numpy(), exp["p_now"], atol=atol)
    np.testing.assert_allclose(p_fut.numpy(), exp["p_future"], atol=atol)
    np.testing.assert_allclose([v1[-1].item(), v2[-1].item()], exp["vad"],
                               atol=atol)
    np.testing.assert_allclose(e1[0, :8].numpy(), exp["e1_head"], atol=atol)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_web_runner_assets_and_server(web_out):
    """index.html and vap_web.js are the JAX package's, byte for byte;
    serve.py on a free loopback port serves its own folder (index.html),
    and over a folder holding the runner and an export, the page and the
    exported manifest.json; each server is then stopped."""
    here = os.path.dirname(serve.__file__)
    assert here == serve.HERE
    for name in ("index.html", "vap_web.js"):
        with open(os.path.join(here, name), "rb") as a, \
                open(os.path.join(JAX_RUNNER, name), "rb") as b:
            assert a.read() == b.read(), name
    site = os.path.dirname(web_out[0])          # holds artifacts/
    for name in ("index.html", "vap_web.js"):
        with open(os.path.join(here, name), "rb") as a, \
                open(os.path.join(site, name), "wb") as b:
            b.write(a.read())
    for directory, files in ((here, ("index.html",)),
                             (site, ("index.html", "artifacts/manifest.json"))):
        srv = serve.make_server(0, directory)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            port = srv.server_address[1]
            for name in files:
                with open(os.path.join(directory, name), "rb") as f:
                    assert _get(f"http://127.0.0.1:{port}/{name}") == f.read()
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=10)
        assert not t.is_alive()


def test_tools_default_to_cuda(tmp_path):
    """export_web's fixture and the exported-program runner run on CUDA
    unless asked for the CPU, and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        export_web.main(["--synthetic_weights", "--context_frames", "4",
                         "--out", str(tmp_path / "w")])
    with pytest.raises(RuntimeError, match="CUDA"):
        vap_offline_exported.main(
            ["--artifact", "x.pt2", "--params", "x.npz", "--input_wav_left",
             "l.wav", "--input_wav_right", "r.wav"])
