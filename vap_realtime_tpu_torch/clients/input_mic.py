"""Microphone input client — one mic channel + one silent channel.

Reference analogues: input/mic.py (mic on channel 1, zeros on channel 2)
and input/mic_bc.py / mic_nod.py (mic on channel 2 — BC/NOD predict the
behaviour of the channel-1 system given the user on channel 2;
mic_bc.py:72-74).  Select with --mic_channel.

The port's own copy of `vap_realtime_tpu/clients/input_mic.py`.

Run: python -m vap_realtime_tpu_torch.clients.input_mic \
        --server_ip 127.0.0.1 --port_num 50007 [--mic_channel 2]
"""

from __future__ import annotations

import argparse
import socket
import time

import numpy as np

from vap_realtime_tpu_torch.clients.input_wav import PauseController
from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.io.sources import (
    FRAME_SIZE, Mic, available_mic_devices,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server_ip", default="127.0.0.1")
    ap.add_argument("--port_num", type=int, default=50007)
    ap.add_argument("--command_port_num", type=int, default=50009)
    ap.add_argument("--mic_device_index", type=int, default=None)
    ap.add_argument("--mic_channel", type=int, choices=[1, 2], default=1,
                    help="1 = vap user mic; 2 = bc/nod system-side layout")
    ap.add_argument("--audio_gain", type=float, default=1.0)
    ap.add_argument("--list_devices", action="store_true")
    args = ap.parse_args(argv)

    if args.list_devices:
        for d in available_mic_devices():
            print(f"{d['index']}: {d['name']}")
        return

    ctrl = PauseController(args.command_port_num)
    ctrl.start()

    mic = Mic(args.mic_device_index, gain=args.audio_gain)
    mic.start_process()
    sock = socket.create_connection((args.server_ip, args.port_num))
    print("[IN] Connected to server")
    zeros = np.zeros(FRAME_SIZE)
    while True:
        x = mic.get_audio_data()
        if ctrl.paused.is_set():
            x = zeros
        pair = (x, zeros) if args.mic_channel == 1 else (zeros, x)
        try:
            sock.sendall(wire.conv_2floatarray_2_bytearray(*pair))
        except OSError as e:
            print("[IN] send failed:", e)
            time.sleep(0.5)


if __name__ == "__main__":
    main()
