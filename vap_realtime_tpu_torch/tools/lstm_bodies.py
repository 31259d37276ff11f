"""K5's two bodies side by side on the card: the crossover grid.

`ops/cuda/lstm.py` runs the LSTM scan (K5, `csrc/lstm_scan.cu`) in one of
two bodies, picked by `_body`: the serving body (64 streams a block,
W_hh^T streamed from L2 every step) and the sequence body (16 streams a
thread-block cluster, W_hh^T resident in shared memory, h through
distributed shared memory).  This tool times both on the same random
inputs at every (B, T) of a grid, the sequence body at both its cluster
sizes (8 blocks, W_hh^T raw in shared memory; 16, non-portable, its TF32
hi and lo parts), and prints ms a call, microseconds a step, the faster
body and the one `lstm_scan` picks (`_body`, `_cluster`), beside the
card's name and power limit.  Gates and state are float32, or bf16 where
float32 gates and outputs would pass MAX_GB.  A cluster that does not fit
on the card raises.

    python -m vap_realtime_tpu_torch.tools.lstm_bodies
        [--batches 16,64,256,1024,8192] [--steps 5,200,1998] [--reps 3]

CUDA only: the bodies are CUDA kernels, and a CPU run would time the
plain version.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import torch

from vap_realtime_tpu_torch.ops.cuda import lstm as k5
from vap_realtime_tpu_torch.profile_step import cuda_ms, gpu_line

H = 256
CLUSTERS = (8, 16)     # the sequence body's cluster sizes
MAX_GB = 40.0          # float32 gates + outputs above this run in bf16


def inputs(B: int, T: int, dtype, seed: int = 0):
    """(gi, h0, c0, w_hh_t, b_hh) on the card, the LSTM's scales: gates
    0.5 N(0, 1), state 0.1 N(0, 1), W_hh^T N(0, 1) / 16, b_hh 0.06 N(0,
    1); gi and the state in `dtype`, the weights float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    gi = torch.empty(B, T, 4 * H, dtype=dtype, device="cuda")
    for i in range(0, B, 256):             # no float32 temporary of it all
        gi[i:i + 256] = 0.5 * rn(min(256, B - i), T, 4 * H)
    return (gi, (0.1 * rn(B, H)).to(dtype), (0.1 * rn(B, H)).to(dtype),
            rn(H, 4 * H) / 16, 0.06 * rn(4 * H))


def launchers() -> Dict[str, object]:
    """{name: fn(gi, h0, c0, w_hh_t, b)}: the serving body and the
    sequence body at each cluster size, through their launch functions."""
    out = {"serving": k5._launch_serving}
    for cl in CLUSTERS:
        out[f"sequence {cl}"] = (
            lambda *a, cl=cl: k5._launch_sequence(*a, cluster=cl))
    return out


def time_cell(B: int, T: int, reps: int) -> dict:
    """ms a call of every body at (B, T), in turns (serving, sequence 8,
    sequence 16, and back), and the dtype it ran in."""
    f32_gb = B * T * 5 * H * 4 / 1e9             # gi + ys, float32
    dtype = torch.float32 if f32_gb <= MAX_GB else torch.bfloat16
    gi, h0, c0, w, b = inputs(B, T, dtype)
    fns = launchers()
    order = list(fns) + list(reversed(list(fns)))
    reps = max(1, reps if T * max(B // 1024, 1) < 2000 else reps // 2)
    ms: Dict[str, list] = {k: [] for k in fns}
    with torch.no_grad():
        for k in order:
            ms[k].append(cuda_ms(lambda f=fns[k]: f(gi, h0, c0, w, b),
                                 reps=reps, warm=1))
    del gi, h0, c0
    torch.cuda.empty_cache()
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    at_once = k5._at_once(torch.device("cuda", torch.cuda.current_device()))
    pick = k5._body(B, at_once)
    if pick == "sequence":
        pick = f"sequence {k5._cluster(B, at_once)}"
    return dict(B=B, T=T, dtype=str(dtype)[6:], ms=mean,
                best=min(mean, key=mean.get), pick=pick)


def crossover(batches: List[int], steps: List[int],
              reps: int = 3) -> List[dict]:
    """Every cell of batches x steps; prints one line a cell."""
    rows = []
    for B in batches:
        for T in steps:
            row = time_cell(B, T, reps)
            cells = ", ".join(f"{k} {v:.4f} ms ({1e3 * v / T:.2f} us/step)"
                              for k, v in row["ms"].items())
            print(f"[k5 bodies] B={B} T={T} {row['dtype']}: {cells}; "
                  f"fastest {row['best']}, lstm_scan picks {row['pick']}",
                  flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ints = lambda s: [int(x) for x in s.split(",")]
    ap.add_argument("--batches", type=ints, default=[16, 64, 256, 1024,
                                                     8192])
    ap.add_argument("--steps", type=ints, default=[5, 200, 1998])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lstm_bodies: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    for cl in CLUSTERS:
        print(f"[k5 bodies] sequence {cl}: {k5.max_active_clusters(cl)} "
              f"clusters of {cl} blocks active at once | {gpu}", flush=True)
    rows = crossover(args.batches, args.steps, args.reps)
    print(f"[k5 bodies] {gpu}", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
