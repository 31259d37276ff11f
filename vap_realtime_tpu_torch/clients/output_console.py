"""Console output client — prints every Nth result from the server.

Reference analogue: output/console.py (+ _bc/_nod variants; select with
--mode).

The port's own copy of `vap_realtime_tpu/clients/output_console.py`.

Run: python -m vap_realtime_tpu_torch.clients.output_console \
        --server_ip 127.0.0.1 --port_num 50008 --mode vap
"""

from __future__ import annotations

import argparse
import socket

from vap_realtime_tpu_torch.io import wire


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server_ip", default="127.0.0.1")
    ap.add_argument("--port_num", type=int, default=50008)
    ap.add_argument("--mode", choices=["vap", "bc", "nod"], default="vap")
    ap.add_argument("--print_every", type=int, default=20)
    args = ap.parse_args(argv)

    sock = socket.create_connection((args.server_ip, args.port_num))
    print("[OUT] Connected to server", flush=True)
    n = 0
    while True:
        try:
            r = wire.deserialize_result(wire.read_framed(sock), args.mode)
        except ConnectionError:
            print("[OUT] Disconnected", flush=True)  # the server closed it
            sock.close()
            return
        n += 1
        if n % args.print_every:
            continue
        if args.mode == "vap":
            print(f"t={r['t']:.3f} p_now={[round(v, 4) for v in r['p_now']]}"
                  f" p_future={[round(v, 4) for v in r['p_future']]}"
                  f" vad={[round(v, 3) for v in r['vad']]}", flush=True)
        elif args.mode == "bc":
            print(f"t={r['t']:.3f} p_bc_react={r['p_bc_react'][0]:.4f} "
                  f"p_bc_emo={r['p_bc_emo'][0]:.4f}", flush=True)
        else:
            print(f"t={r['t']:.3f} p_bc={r['p_bc'][0]:.4f} "
                  f"p_nod_short={r['p_nod_short'][0]:.4f} "
                  f"p_nod_long={r['p_nod_long'][0]:.4f} "
                  f"p_nod_long_p={r['p_nod_long_p'][0]:.4f}", flush=True)


if __name__ == "__main__":
    main()
