"""Backchannel + nodding head smoke over the sample WAVs.

Port of `examples/example_bc_nod.py` (reference analogues:
test_scripts/test_vap_bc_module_wav_mic.py and
test_vap_nod_module_wav_mic.py; a WAV source instead of a microphone).
With --mic a real microphone is the user channel, in the bc/nod layout:
system = channel 1, user mic = channel 2 (mic_bc.py:72-74).  The engine
runs on the card unless --device cpu.

Run: python -m vap_realtime_tpu_torch.examples.example_bc_nod \
         --mode bc|nod [--mic] [--device cpu]
"""

import argparse
import os

from vap_realtime_tpu_torch.api import Vap
from vap_realtime_tpu_torch.io.sources import Mic, Wav, Zero
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["bc", "nod"], default="bc")
    ap.add_argument("--mic", action="store_true",
                    help="use a real microphone as the user channel")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # bc/nod predict channel-1 (system) behaviour given the user on
    # channel 2, so the live source goes on mic2
    user = Mic() if args.mic else Wav(
        os.path.join(REPO, "sample/sample_ch2_16k.wav"))
    vap = Vap(mode=args.mode, frame_rate=10, context_len_sec=5.0,
              mic1=Zero(), mic2=user,
              params=synthetic_params(10, mode=args.mode),
              device=args.device)
    vap.start_process()
    try:
        for _ in range(args.frames):
            r = vap.get_result(timeout=60)
            if args.mode == "bc":
                print(f"t={r['t']:.2f} p_bc_react={r['p_bc_react']:.3f} "
                      f"p_bc_emo={r['p_bc_emo']:.3f}", flush=True)
            else:
                print(f"t={r['t']:.2f} p_bc={r['p_bc']:.3f} "
                      f"short={r['p_nod_short']:.3f} "
                      f"long={r['p_nod_long']:.3f} "
                      f"long_p={r['p_nod_long_p']:.3f}", flush=True)
    finally:
        vap.stop_process()


if __name__ == "__main__":
    main()
