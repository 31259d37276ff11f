"""Export weights and a self-test fixture for the in-browser VAP runner.

Port of `tools/export_web.py` (reference analogue: tools/
vap_offline_onnxweb.html / vap_offline_tfjs.html).  It feeds
`vap_realtime_tpu_torch/clients/web_runner/`, a dependency-free
JavaScript implementation of the static step (`runtime/static.py`),
with:

- weights.bin   little-endian float32, all params concatenated in the
                order of their sorted npz names
- manifest.json {params: {name: {offset, shape}}, cfg: {...},
                 selftest: {x1, x2, expected p_now/p_future/vad/e1_head,
                 atol}}

The self-test fixture is one static step on a seeded input (numpy
`RandomState(7)`), computed on `--device` in float32 with TF32 off, so
opening index.html checks the JS implementation end to end (PASS/FAIL
in the page) before its latency benchmark runs.

Run (the fixture on the card; `--device cpu` for the CPU):
    python -m vap_realtime_tpu_torch.tools.export_web --synthetic_weights
    python -m vap_realtime_tpu_torch.tools.export_web \\
        --checkpoint_npz w.npz --context_frames 99 --out web_artifacts
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime.static import make_static_fn
from vap_realtime_tpu_torch.weights.convert import (
    _flatten, load_pytree_npz, params_to_torch,
)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(HERE, "clients", "web_runner", "artifacts")


@contextlib.contextmanager
def full_float32():
    """Matmuls and cuDNN convs in full float32 (no TF32) inside the
    block: the JS runner checks the fixture at atol 2e-4."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def selftest_fixture(params, cfg: VapConfig, context_frames: int,
                     device="cuda") -> dict:
    """One static step on x1, x2 ~ 0.1 N(0, 1) (RandomState(7)) from
    zero contexts and state, on `device` in float32."""
    fn, example = make_static_fn(cfg, context_frames, device)
    dev = example[0].device
    rs = np.random.RandomState(7)
    x1 = (rs.randn(1, cfg.frame_samples) * 0.1).astype(np.float32)
    x2 = (rs.randn(1, cfg.frame_samples) * 0.1).astype(np.float32)
    p = params_to_torch(params, dev, torch.float32)
    with torch.no_grad(), full_float32():
        outs = fn(p, torch.from_numpy(x1).to(dev),
                  torch.from_numpy(x2).to(dev), *example[2:])
    p_now, p_fut, vad1, vad2, e1, _e2, _h, _c = [o.cpu().numpy()
                                                 for o in outs]
    return {
        "seed_note": "x1/x2 ~ 0.1*N(0,1) from the fixture below",
        "x1": x1[0].round(6).tolist(),
        "x2": x2[0].round(6).tolist(),
        "expected": {
            "p_now": p_now.tolist(),
            "p_future": p_fut.tolist(),
            "vad": [float(vad1[-1]), float(vad2[-1])],
            "e1_head": e1[0, :8].tolist(),
        },
        "atol": 2e-4,
    }


def main(argv: Optional[list] = None) -> str:
    """Returns the output directory."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint_npz", default=None)
    ap.add_argument("--synthetic_weights", action="store_true")
    ap.add_argument("--frame_hz", type=int, default=20)
    ap.add_argument("--context_frames", type=int, default=99,
                    help="static context size (reference export: 99)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="where the self-test fixture is computed")
    args = ap.parse_args(argv)
    if not (args.synthetic_weights or args.checkpoint_npz):
        ap.error("give --checkpoint_npz or --synthetic_weights")

    cfg = VapConfig(frame_hz=args.frame_hz)
    if args.synthetic_weights:
        from vap_realtime_tpu_torch.weights.synthetic import synthetic_params
        params = synthetic_params(cfg.frame_hz)
    else:
        params = load_pytree_npz(args.checkpoint_npz)
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(params).items()}

    os.makedirs(args.out, exist_ok=True)
    manifest = {"params": {}, "cfg": {
        "frame_hz": cfg.frame_hz,
        "frame_samples": cfg.frame_samples,
        "context_frames": args.context_frames,
        "dim": cfg.dim,
        "num_heads": cfg.num_heads,
        "channel_layers": cfg.channel_layers,
        "cross_layers": cfg.cross_layers,
        "downsample_kernel": cfg.downsample_kernel,
    }}
    off = 0
    with open(os.path.join(args.out, "weights.bin"), "wb") as f:
        for name in sorted(flat):
            arr = flat[name].astype("<f4")
            manifest["params"][name] = {"offset": off,
                                        "shape": list(arr.shape)}
            f.write(arr.tobytes())
            off += arr.size
    manifest["selftest"] = selftest_fixture(params, cfg, args.context_frames,
                                            args.device)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    print(f"wrote {args.out}/weights.bin ({off * 4} bytes) + manifest.json")
    return args.out


if __name__ == "__main__":
    main()
