"""Offline prediction visualizer — browser UI for offline CSV results.

Reference analogue: output/offline_prediction_visualizer (FastAPI +
wavesurfer.js; main.py:9-68, static/script.js).  This implementation is
dependency-free: stdlib http.server serving a self-contained HTML/JS page
(canvas waveforms + p_now/p_future charts synced to audio playback,
speed keys 1/2/3).

The port's own copy of `vap_realtime_tpu/clients/visualizer/server.py`.

Run: python -m vap_realtime_tpu_torch.clients.visualizer.server \
        --data out.csv --audio_left l.wav --audio_right r.wav --port 8000
"""

from __future__ import annotations

import argparse
import http.server
import json
import os
import threading

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


def load_rows(csv_path: str):
    rows = []
    with open(csv_path) as f:
        next(f)  # header
        for line in f:
            vals = line.strip().split(",")
            if len(vals) >= 5:
                rows.append([float(v) for v in vals[:5]])
    return rows


class Handler(http.server.BaseHTTPRequestHandler):
    paths = {}  # {"left": wav, "right": wav, "data": csv}

    def log_message(self, *a):
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
                return self._send(200, f.read(), "text/html")
        if self.path == "/script.js":
            with open(os.path.join(STATIC_DIR, "script.js"), "rb") as f:
                return self._send(200, f.read(), "text/javascript")
        if self.path in ("/audio/left", "/audio/right"):
            key = self.path.rsplit("/", 1)[1]
            with open(self.paths[key], "rb") as f:
                return self._send(200, f.read(), "audio/wav")
        if self.path == "/data":
            rows = load_rows(self.paths["data"])
            return self._send(200, json.dumps(rows).encode(),
                              "application/json")
        self._send(404, b"not found", "text/plain")


def serve(data: str, audio_left: str, audio_right: str,
          host: str = "127.0.0.1", port: int = 8000, block: bool = True):
    Handler.paths = {"left": audio_left, "right": audio_right,
                     "data": data}
    httpd = http.server.ThreadingHTTPServer((host, port), Handler)
    print(f"visualizer at http://{host}:{httpd.server_address[1]}/")
    if block:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True, help="offline CSV output")
    ap.add_argument("--audio_left", required=True)
    ap.add_argument("--audio_right", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args(argv)
    serve(args.data, args.audio_left, args.audio_right, args.host,
          args.port)


if __name__ == "__main__":
    main()
