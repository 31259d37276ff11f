"""ANSI terminal live-bar output client.

Reference analogue: output/bar.py (+ _bc/_nod): RMS level bars for each
channel and a balance bar for p_now / p_future centered at 0.5 (vap), or
0->1 probability bars (bc/nod).

The port's own copy of `vap_realtime_tpu/clients/output_bar.py`.

Run: python -m vap_realtime_tpu_torch.clients.output_bar --mode vap
"""

from __future__ import annotations

import argparse
import socket

import numpy as np

from vap_realtime_tpu_torch.io import wire

WIDTH = 40


def level_bar(rms: float, width: int = WIDTH) -> str:
    n = min(int(rms * width * 5), width)
    return "#" * n + "-" * (width - n)


def balance_bar(p: float, width: int = WIDTH) -> str:
    """Centered at 0.5: left fill = speaker 0, right fill = speaker 1."""
    half = width // 2
    if p <= 0.5:
        n = int((0.5 - p) * 2 * half)
        return "-" * (half - n) + "<" * n + "|" + "-" * half
    n = int((p - 0.5) * 2 * half)
    return "-" * half + "|" + ">" * n + "-" * (half - n)


def prob_bar(p: float, width: int = WIDTH) -> str:
    n = min(int(p * width), width)
    return "#" * n + "-" * (width - n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server_ip", default="127.0.0.1")
    ap.add_argument("--port_num", type=int, default=50008)
    ap.add_argument("--mode", choices=["vap", "bc", "nod"], default="vap")
    args = ap.parse_args(argv)

    sock = socket.create_connection((args.server_ip, args.port_num))
    print("\x1b[2J")  # clear screen
    while True:
        try:
            r = wire.deserialize_result(wire.read_framed(sock), args.mode)
        except ConnectionError:
            print("\n[OUT] Disconnected")          # the server closed it
            sock.close()
            return
        rms1 = float(np.sqrt(np.mean(np.square(r["x1"])))) if r["x1"] else 0
        rms2 = float(np.sqrt(np.mean(np.square(r["x2"])))) if r["x2"] else 0
        lines = [f"mic1 level   [{level_bar(rms1)}]",
                 f"mic2 level   [{level_bar(rms2)}]"]
        if args.mode == "vap":
            # p[1] = probability that speaker 1 (right) is next
            lines += [f"p_now    0 {balance_bar(r['p_now'][1])} 1",
                      f"p_future 0 {balance_bar(r['p_future'][1])} 1"]
        elif args.mode == "bc":
            lines += [f"p_bc_react [{prob_bar(r['p_bc_react'][0])}]",
                      f"p_bc_emo   [{prob_bar(r['p_bc_emo'][0])}]"]
        else:
            lines += [f"p_bc         [{prob_bar(r['p_bc'][0])}]",
                      f"p_nod_short  [{prob_bar(r['p_nod_short'][0])}]",
                      f"p_nod_long   [{prob_bar(r['p_nod_long'][0])}]",
                      f"p_nod_long_p [{prob_bar(r['p_nod_long_p'][0])}]"]
        print("\x1b[H" + "\n".join(lines) + "\x1b[J", end="", flush=True)


if __name__ == "__main__":
    main()
