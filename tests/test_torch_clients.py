"""PyTorch port: the client programs, the demo and the examples — the
twin of `tests/test_clients.py`.  The bars and the result buffer against
the JAX clients', the wav client end to end through the port's
`VapServer` on the CPU against JAX `run_frames`, with the console client
reading the same results, the visualizer over loopback HTTP, the
headless demo, and each example in a subprocess on the CPU."""

import filecmp
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_golden_stream
from vap_realtime_tpu.clients import output_bar as jax_bar
from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.runtime.streaming import (
    frame_audio, init_stream_state, run_frames,
)
from vap_realtime_tpu.weights.synthetic import synthetic_params as jax_params
from vap_realtime_tpu_torch.clients.output_bar import (
    balance_bar, level_bar, prob_bar,
)
from vap_realtime_tpu_torch.clients.output_gui import ResultBuffer
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.io.audio import read_wav, write_wav
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RESULTS = 20                     # 1 s of frames at 20 Hz


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread while this file runs: the suite runs
    several files at once, and the socket tests share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _run(args, timeout=120):
    """A port module in a fresh interpreter from the repository root."""
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_bars():
    """The bars render as the JAX client's at every level."""
    assert len(level_bar(0.0)) == 40
    assert level_bar(1.0).count("#") == 40
    assert balance_bar(0.5).count("|") == 1
    assert ">" in balance_bar(0.9) and "<" in balance_bar(0.1)
    assert prob_bar(0.5).count("#") == 20
    for v in np.linspace(0, 1, 41):
        assert level_bar(v) == jax_bar.level_bar(v)
        assert balance_bar(v) == jax_bar.balance_bar(v)
        assert prob_bar(v) == jax_bar.prob_bar(v)


def test_result_buffer_window():
    buf = ResultBuffer("vap", window_sec=1.0)
    for i in range(30):
        buf.add({"t": i * 0.1, "p_now": [0.4, 0.6], "p_future": [0.5, 0.5],
                 "x1": np.zeros(10), "x2": np.zeros(10)})
    t, probs, a1, a2 = buf.snapshot()
    assert t[-1] - t[0] <= 1.0 + 1e-9
    assert probs["p_now"].shape == (len(t), 2) and len(a1) == len(t)
    assert ResultBuffer("nod").keys() == ["p_bc", "p_nod_short",
                                          "p_nod_long", "p_nod_long_p"]


def test_input_wav_client_end_to_end(tmp_path):
    """input_wav client -> the port's VapServer (VapEngine(path="kv"),
    CPU) -> framed results: the first 20 equal JAX run_frames over the
    same WAV samples after the server's 320 zero samples (p_now,
    p_future, vad at atol 1e-4), and the console client, reading the
    same output port, prints 20 finite results."""
    golden = load_golden_stream("stream_vap_20hz.npz")
    audio = golden["audio"][:, :19200]            # 1.2 s: 23 frames
    left, right = str(tmp_path / "l.wav"), str(tmp_path / "r.wav")
    write_wav(left, audio[0], 16000)
    write_wav(right, audio[1], 16000)

    from vap_realtime_tpu_torch.clients.input_wav import main as wav_main
    from vap_realtime_tpu_torch.runtime.engine import VapEngine
    from vap_realtime_tpu_torch.runtime.server import VapServer

    (port_cmd,) = _free_ports(1)
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    engine = VapEngine(cfg, params=synthetic_params(20), path="kv",
                       device="cpu")
    engine.warmup()
    server = VapServer(engine, mode="vap", port_in=0, port_out=0)
    server.start_background()
    results = []

    def consume():
        with socket.create_connection(("127.0.0.1", server.port_out),
                                      timeout=30) as c:
            while len(results) < N_RESULTS:
                results.append(wire.deserialize_result(
                    wire.read_framed(c), "vap"))

    tc = threading.Thread(target=consume, daemon=True)
    console = subprocess.Popen(
        [sys.executable, "-m", "vap_realtime_tpu_torch.clients.output_console",
         "--port_num", str(server.port_out), "--print_every", "1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tc.start()
        deadline = time.time() + 30
        while len(server.clients) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(server.clients) == 2
        wav_main(["--server_ip", "127.0.0.1",
                  "--port_num", str(server.port_in),
                  "--command_port_num", str(port_cmd),
                  "--input_wav_left", left, "--input_wav_right", right])
        tc.join(timeout=30)
    finally:
        server.stop()
        try:
            out, err = console.communicate(timeout=30)
        finally:
            console.kill()
    assert not tc.is_alive() and len(results) == N_RESULTS

    samples = np.stack([read_wav(left)[0], read_wav(right)[0]])
    jc = JaxConfig(frame_hz=20, context_len_sec=2.5)
    padded = np.concatenate([np.zeros((2, 320), np.float32), samples], 1)
    frames = jnp.asarray(frame_audio(padded, jc)[:N_RESULTS, None])
    _, want = jax.jit(run_frames, static_argnums=3)(
        jax_params(20), init_stream_state(jc, 1), frames, jc)
    for k in ("p_now", "p_future", "vad"):
        got = np.array([r[k] for r in results])
        np.testing.assert_allclose(got, np.asarray(want[k][:, 0]),
                                   atol=1e-4, err_msg=k)

    assert console.returncode == 0, err
    lines = [ln for ln in out.splitlines() if ln.startswith("t=")]
    assert len(lines) >= N_RESULTS, out
    vals = [float(v) for ln in lines
            for v in re.findall(r"[-\w.]+(?=[,\]])", ln)]
    assert len(vals) == 6 * len(lines) and np.isfinite(vals).all()
    assert "[OUT] Disconnected" in out


def test_visualizer_http(tmp_path):
    """The port's visualizer serves its page, script, data and audio
    over loopback HTTP; its static assets are the JAX client's."""
    csv = tmp_path / "out.csv"
    csv.write_text("time_sec,p_now(0),p_now(1),p_future(0),p_future(1)\n"
                   "0.05,0.4,0.6,0.45,0.55\n0.10,0.5,0.5,0.5,0.5\n")
    wav = str(tmp_path / "a.wav")
    write_wav(wav, np.zeros(1600), 16000)

    from vap_realtime_tpu_torch.clients.visualizer import server as vis

    assert vis.STATIC_DIR.startswith(os.path.join(
        REPO, "vap_realtime_tpu_torch", "clients"))
    for name in ("index.html", "script.js"):
        assert filecmp.cmp(
            os.path.join(vis.STATIC_DIR, name),
            os.path.join(REPO, "vap_realtime_tpu", "clients", "visualizer",
                         "static", name), shallow=False), name
    httpd = vis.serve(str(csv), wav, wav, port=0, block=False)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.read()

        assert "VAP offline prediction visualizer" in get("/").decode()
        assert "drawProb" in get("/script.js").decode()
        assert json.loads(get("/data")) == [[0.05, 0.4, 0.6, 0.45, 0.55],
                                            [0.1, 0.5, 0.5, 0.5, 0.5]]
        assert get("/audio/left")[:4] == b"RIFF"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_demo_e2e_writes_a_png(tmp_path):
    """The demo on the CPU: server, wav client and the headless GUI
    dashboard render a PNG."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pytest.skip("the demo's dashboard needs matplotlib")
    out = str(tmp_path / "demo.png")
    r = _run(["vap_realtime_tpu_torch.tools.demo_e2e", "--device", "cpu",
              "--seconds", "2", "--out", out])
    assert r.returncode == 0, r.stderr
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert "demo complete" in r.stdout


def _example_argv(name):
    if name == "example_vap_2tcp":
        p1, p2 = _free_ports(2)
        return ["--port1", str(p1), "--port2", str(p2)]
    if name == "example_bc_nod nod":
        return ["--mode", "nod"]
    return []


@pytest.mark.parametrize("name,keys,n_vals", [
    ("example_vap_2wav", ("p_now", "p_future", "vad"), 6),
    ("example_vap_2tcp", ("p_now",), 2),
    ("example_bc_nod", ("p_bc_react", "p_bc_emo"), 2),
    ("example_bc_nod nod", ("p_bc", "short", "long", "long_p"), 4)])
def test_example_runs_on_the_cpu(name, keys, n_vals):
    """Each example as `python -m vap_realtime_tpu_torch.examples.<name>
    --device cpu --frames 3` over the sample WAVs: three result lines of
    finite probabilities, exit 0."""
    module = "vap_realtime_tpu_torch.examples." + name.split()[0]
    r = _run([module, "--device", "cpu", "--frames", "3"]
             + _example_argv(name))
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("t=")]
    assert len(lines) == 3, r.stdout
    for ln in lines:
        for k in keys:
            assert f" {k}=" in ln, ln
        vals = [float(v) for v in re.findall(r"(?<=[=(,])[-\d.]+", ln)[1:]]
        assert len(vals) == n_vals and all(0 <= v <= 1 for v in vals), ln
