"""WAV input client — streams two WAVs to the VAP server in realtime.

Reference analogue: input/wav.py — sends synced 160-sample float64 pairs
to the server's input port while (optionally) playing a mix via pygame,
with a pause/resume command server on port 50009 accepting 'p'/'r'.

The port's own copy of `vap_realtime_tpu/clients/input_wav.py`.

Run: python -m vap_realtime_tpu_torch.clients.input_wav \
        --server_ip 127.0.0.1 --port_num 50007 \
        --input_wav_left l.wav --input_wav_right r.wav [--play_audio]
"""

from __future__ import annotations

import argparse
import socket
import threading
import time

import numpy as np

from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.io.audio import read_wav

FRAME = 160
RATE = 16000


class PauseController:
    """Command server: 'p' pauses, 'r' resumes (input/wav.py:123-151)."""

    def __init__(self, port: int = 50009, host: str = "127.0.0.1"):
        self.paused = threading.Event()
        self.port = port
        self.host = host

    def start(self):
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(1)
        while True:
            conn, _ = s.accept()
            print("[COMMAND] Connected")
            with conn:
                while True:
                    cmd = conn.recv(1)
                    if not cmd:
                        break
                    if cmd == b"p":
                        print("[COMMAND] pause")
                        self.paused.set()
                    elif cmd == b"r":
                        print("[COMMAND] resume")
                        self.paused.clear()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server_ip", default="127.0.0.1")
    ap.add_argument("--port_num", type=int, default=50007)
    ap.add_argument("--command_port_num", type=int, default=50009)
    ap.add_argument("--input_wav_left", required=True)
    ap.add_argument("--input_wav_right", required=True)
    ap.add_argument("--play_wav_stereo", default=None,
                    help="stereo mix to play locally (pygame)")
    ap.add_argument("--play_audio", action="store_true")
    ap.add_argument("--audio_gain", type=float, default=1.0)
    args = ap.parse_args(argv)

    left, sr = read_wav(args.input_wav_left)
    right, _ = read_wav(args.input_wav_right)
    if left.ndim > 1:
        left = left[:, 0]
    if right.ndim > 1:
        right = right[:, 0]
    n = min(len(left), len(right))
    left, right = left[:n] * args.audio_gain, right[:n] * args.audio_gain

    ctrl = PauseController(args.command_port_num)
    ctrl.start()

    if args.play_audio:
        try:
            import pygame

            pygame.mixer.init(frequency=RATE)
            mix_path = args.play_wav_stereo
            if mix_path is None:  # auto-mix (reference uses pydub)
                import tempfile

                from vap_realtime_tpu_torch.io.audio import write_wav

                mix = np.stack([left, right], axis=-1)
                with tempfile.NamedTemporaryFile(suffix=".wav",
                                                 delete=False) as f:
                    mix_path = f.name
                write_wav(mix_path, mix, RATE)
            pygame.mixer.music.load(mix_path)
            pygame.mixer.music.play()
        except Exception as e:  # no audio device in headless envs
            print(f"[PLAY] disabled ({e})")

    sock = socket.create_connection((args.server_ip, args.port_num))
    print("[IN] Connected to server")
    t_next = time.time()
    for i in range(0, n - FRAME, FRAME):
        while ctrl.paused.is_set():
            time.sleep(0.01)
            t_next = time.time()
        sock.sendall(wire.conv_2floatarray_2_bytearray(
            left[i:i + FRAME], right[i:i + FRAME]))
        t_next += FRAME / RATE
        delay = t_next - time.time()
        if delay > 0:
            time.sleep(delay)
    print("[IN] done")


if __name__ == "__main__":
    main()
