"""Library API smoke: two WAV files -> live p_now / p_future stream.

Port of `examples/example_vap_2wav.py` (reference analogue:
test_scripts/test_vap_module_2wav.py, console output instead of the
Tkinter plot).  The engine runs on the card unless --device cpu.

Run: python -m vap_realtime_tpu_torch.examples.example_vap_2wav \
         [--checkpoint_npz w.npz] [--device cpu]
     (without a checkpoint: deterministic synthetic weights)
"""

import argparse
import os

from vap_realtime_tpu_torch.api import Vap
from vap_realtime_tpu_torch.io.sources import Wav

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint_npz", default=None)
    ap.add_argument("--wav1",
                    default=os.path.join(REPO, "sample/sample_ch1_16k.wav"))
    ap.add_argument("--wav2",
                    default=os.path.join(REPO, "sample/sample_ch2_16k.wav"))
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    params = None
    if not args.checkpoint_npz:
        from vap_realtime_tpu_torch.weights.synthetic import synthetic_params
        params = synthetic_params(20)

    vap = Vap(mode="vap", frame_rate=20, context_len_sec=2.5,
              mic1=Wav(args.wav1), mic2=Wav(args.wav2),
              checkpoint_npz=args.checkpoint_npz, params=params,
              device=args.device)
    vap.start_process()
    try:
        for _ in range(args.frames):
            r = vap.get_result(timeout=60)
            print(f"t={r['t']:.2f} p_now=({r['p_now'][0]:.3f},"
                  f"{r['p_now'][1]:.3f}) p_future=({r['p_future'][0]:.3f},"
                  f"{r['p_future'][1]:.3f}) vad=({r['vad'][0]:.2f},"
                  f"{r['vad'][1]:.2f})", flush=True)
    finally:
        vap.stop_process()


if __name__ == "__main__":
    main()
