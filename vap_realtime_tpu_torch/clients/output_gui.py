"""Live GUI dashboard client (matplotlib).

Reference analogues: output/gui.py (2 waveforms + p_now/p_future fill
plots colored by side of 0.5, 10 s window, 250 ms refresh, p/r keypress
forwarded to the input client's command server), output/gui_vad.py
(adds per-channel VAD traces), output/gui_bc.py / gui_nod.py
(probability fills with a 0.5 threshold line).  Select with --mode.

The port's own copy of `vap_realtime_tpu/clients/output_gui.py`.

Run: python -m vap_realtime_tpu_torch.clients.output_gui --mode vap
     (use --headless out.png in display-less environments: renders one
      dashboard frame to a PNG after --headless_seconds of data)
"""

from __future__ import annotations

import argparse
import collections
import socket
import threading
import time

import numpy as np

from vap_realtime_tpu_torch.io import wire

WINDOW_SEC = 10.0
REFRESH_MS = 250
RATE = 16000


class ResultBuffer:
    """Rolling window of results + audio for plotting."""

    def __init__(self, mode: str, window_sec: float = WINDOW_SEC):
        self.mode = mode
        self.window = window_sec
        self.lock = threading.Lock()
        self.times: collections.deque = collections.deque()
        self.probs: dict = collections.defaultdict(collections.deque)
        self.audio1: collections.deque = collections.deque()
        self.audio2: collections.deque = collections.deque()

    def keys(self):
        return {"vap": ["p_now", "p_future"],
                "vad": ["p_now", "p_future", "vad"],
                "bc": ["p_bc_react", "p_bc_emo"],
                "nod": ["p_bc", "p_nod_short", "p_nod_long", "p_nod_long_p"],
                }[self.mode]

    def add(self, r: dict):
        with self.lock:
            t = r["t"]
            self.times.append(t)
            for k in self.keys():
                self.probs[k].append(r[k])
            self.audio1.append((t, np.asarray(r["x1"])))
            self.audio2.append((t, np.asarray(r["x2"])))
            while self.times and self.times[0] < t - self.window:
                self.times.popleft()
                for k in self.keys():
                    self.probs[k].popleft()
                self.audio1.popleft()
                self.audio2.popleft()

    def snapshot(self):
        with self.lock:
            t = np.array(self.times)
            probs = {k: np.array(v) for k, v in self.probs.items()}
            a1 = list(self.audio1)
            a2 = list(self.audio2)
        return t, probs, a1, a2


def consume(buf: ResultBuffer, ip: str, port: int, wire_mode: str):
    with socket.create_connection((ip, port)) as sock:
        print("[OUT] Connected to server")
        try:
            while True:
                buf.add(wire.deserialize_result(wire.read_framed(sock),
                                                wire_mode))
        except ConnectionError:
            print("[OUT] Disconnected")       # the server closed the stream


def draw(fig, axes, buf: ResultBuffer):
    t, probs, a1, a2 = buf.snapshot()
    if len(t) == 0:
        return
    t0 = t[-1]
    for ax in axes:
        ax.clear()
        ax.set_xlim(-buf.window, 0)

    def plot_wave(ax, chunks, title):
        if chunks:
            xs = np.concatenate([c[1] for c in chunks])
            ts = np.linspace(chunks[0][0] - t0, 0, len(xs))
            ax.plot(ts, xs, linewidth=0.5, color="k")
        ax.set_ylim(-1, 1)
        ax.set_ylabel(title)

    plot_wave(axes[0], a1, "ch1")
    plot_wave(axes[1], a2, "ch2")

    rel = t - t0
    if buf.mode in ("vap", "vad"):
        for i, key in enumerate(("p_now", "p_future")):
            ax = axes[2 + i]
            p = probs[key][:, 1]  # P(speaker 1 next)
            ax.fill_between(rel, 0.5, p, where=p >= 0.5, color="orange",
                            alpha=0.7)
            ax.fill_between(rel, p, 0.5, where=p < 0.5, color="steelblue",
                            alpha=0.7)
            ax.axhline(0.5, color="gray", linewidth=0.5)
            ax.set_ylim(0, 1)
            ax.set_ylabel(key)
        if buf.mode == "vad":
            for ch in range(2):
                ax = axes[4 + ch]
                ax.plot(rel, probs["vad"][:, ch], color="green")
                ax.set_ylim(0, 1)
                ax.set_ylabel(f"vad{ch + 1}")
    else:
        for i, key in enumerate(buf.keys()):
            ax = axes[2 + i]
            p = probs[key][:, 0] if probs[key].ndim > 1 else probs[key]
            ax.fill_between(rel, 0, p, color="orange", alpha=0.7)
            ax.axhline(0.5, color="red", linewidth=0.5)
            ax.set_ylim(0, 1)
            ax.set_ylabel(key)
    axes[-1].set_xlabel("time [s]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server_ip", default="127.0.0.1")
    ap.add_argument("--port_num", type=int, default=50008)
    ap.add_argument("--command_server_ip", default="127.0.0.1")
    ap.add_argument("--command_port_num", type=int, default=50009)
    ap.add_argument("--mode", choices=["vap", "vad", "bc", "nod"],
                    default="vap")
    ap.add_argument("--headless", default=None, metavar="OUT_PNG",
                    help="render one frame to PNG instead of a window")
    ap.add_argument("--headless_seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import matplotlib

    if args.headless:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    wire_mode = {"vap": "vap", "vad": "vap", "bc": "bc",
                 "nod": "nod"}[args.mode]
    buf = ResultBuffer(args.mode)
    threading.Thread(target=consume,
                     args=(buf, args.server_ip, args.port_num, wire_mode),
                     daemon=True).start()

    n_rows = {"vap": 4, "vad": 6, "bc": 4, "nod": 6}[args.mode]
    fig, axes = plt.subplots(n_rows, 1, sharex=True,
                             figsize=(10, 1.6 * n_rows))

    if args.headless:
        time.sleep(args.headless_seconds)
        draw(fig, axes, buf)
        fig.tight_layout()
        fig.savefig(args.headless, dpi=100)
        print(f"saved {args.headless}")
        return

    # keypress p/r forwarded to the input client (gui.py:18-35)
    cmd_sock = None
    try:
        cmd_sock = socket.create_connection(
            (args.command_server_ip, args.command_port_num), timeout=1)
    except OSError:
        print("[COMMAND] input command server not reachable (no pause/resume)")

    def on_key(event):
        if cmd_sock and event.key in ("p", "r"):
            cmd_sock.sendall(event.key.encode())

    fig.canvas.mpl_connect("key_press_event", on_key)

    from matplotlib.animation import FuncAnimation

    anim = FuncAnimation(fig, lambda _f: draw(fig, axes, buf),
                         interval=REFRESH_MS, cache_frame_data=False)
    plt.tight_layout()
    plt.show()
    del anim


if __name__ == "__main__":
    main()
