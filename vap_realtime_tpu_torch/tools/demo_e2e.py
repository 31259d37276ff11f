"""End-to-end demo: server + wav client + GUI dashboard (headless PNG).

Port of `tools/demo_e2e.py`.  Starts the two-port realtime server
(`runtime/server.py` `VapServer`) on a `VapEngine(path="kv")` with
synthetic weights, streams synthetic stereo audio through the wav input
client, and renders the live GUI dashboard to a PNG: the reference's
whole pipeline (input/wav.py -> vap_main server -> output/gui.py) in one
process.  The engine runs on the card unless --device cpu; the dashboard
needs matplotlib.

Run: python -m vap_realtime_tpu_torch.tools.demo_e2e --out demo.png \
         [--seconds 6] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
import threading


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="demo_dashboard.png")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--mode", choices=["vap", "vad"], default="vad")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vap_realtime_tpu_torch.clients.input_wav import main as wav_main
    from vap_realtime_tpu_torch.clients.output_gui import main as gui_main
    from vap_realtime_tpu_torch.config import VapConfig
    from vap_realtime_tpu_torch.io.audio import write_wav
    from vap_realtime_tpu_torch.runtime.engine import VapEngine
    from vap_realtime_tpu_torch.runtime.server import VapServer
    from vap_realtime_tpu_torch.weights.synthetic import (
        synthetic_audio, synthetic_params,
    )

    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    engine = VapEngine(cfg, params=synthetic_params(20), path="kv",
                       device=args.device)
    print("warming up...")
    engine.warmup()
    server = VapServer(engine, mode="vap", port_in=0, port_out=0)
    server.start_background()
    try:
        audio = synthetic_audio(int(args.seconds * 16000))
        with tempfile.TemporaryDirectory() as tmp:
            left = os.path.join(tmp, "l.wav")
            right = os.path.join(tmp, "r.wav")
            write_wav(left, audio[0], 16000)
            write_wav(right, audio[1], 16000)
            port_cmd = str(free_port())
            producer = threading.Thread(
                target=wav_main,
                args=(["--server_ip", "127.0.0.1",
                       "--port_num", str(server.port_in),
                       "--command_port_num", port_cmd,
                       "--input_wav_left", left,
                       "--input_wav_right", right],),
                daemon=True)
            producer.start()
            gui_main(["--server_ip", "127.0.0.1",
                      "--port_num", str(server.port_out),
                      "--command_port_num", port_cmd,
                      "--mode", args.mode, "--headless", args.out,
                      "--headless_seconds", str(args.seconds + 1.0)])
            producer.join(timeout=10)
    finally:
        server.stop()
    size = os.path.getsize(args.out)
    print(f"demo complete: {args.out} ({size} bytes), streamed "
          f"{args.seconds}s of audio end-to-end")


if __name__ == "__main__":
    main()
