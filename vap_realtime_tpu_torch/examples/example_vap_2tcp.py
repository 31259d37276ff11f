"""Loopback TCP smoke: two TCPTransmitter sources -> two TCPReceiver
inputs -> Vap, the whole wire path in one process.

Port of `examples/example_vap_2tcp.py` (reference analogue:
test_scripts/test_vap_module_2tcp.py).  The two receiver ports are
options (the JAX example fixes 51007 / 51008, the defaults here).  The
engine runs on the card unless --device cpu.

Run: python -m vap_realtime_tpu_torch.examples.example_vap_2tcp \
         [--port1 51007 --port2 51008] [--device cpu]
"""

import argparse
import os
import time

from vap_realtime_tpu_torch.api import Vap
from vap_realtime_tpu_torch.io.sources import TCPReceiver, TCPTransmitter, Wav
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port1", type=int, default=51007)
    ap.add_argument("--port2", type=int, default=51008)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rx1 = TCPReceiver(port=args.port1, channel=0)
    rx2 = TCPReceiver(port=args.port2, channel=0)
    rx1.start_process()
    rx2.start_process()
    time.sleep(0.2)

    tx1 = TCPTransmitter(
        Wav(os.path.join(REPO, "sample/sample_ch1_16k.wav")), port=args.port1)
    tx2 = TCPTransmitter(
        Wav(os.path.join(REPO, "sample/sample_ch2_16k.wav")), port=args.port2)
    tx1.start_process()
    tx2.start_process()

    vap = Vap(mode="vap", frame_rate=20, context_len_sec=2.5,
              mic1=rx1, mic2=rx2, params=synthetic_params(20),
              device=args.device)
    vap.start_process()
    try:
        for _ in range(args.frames):
            r = vap.get_result(timeout=60)
            print(f"t={r['t']:.2f} p_now=({r['p_now'][0]:.3f},"
                  f"{r['p_now'][1]:.3f})", flush=True)
    finally:
        tx1.stop_process()
        tx2.stop_process()
        vap.stop_process()


if __name__ == "__main__":
    main()
