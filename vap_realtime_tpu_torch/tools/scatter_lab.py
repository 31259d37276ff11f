"""Scatter lab: is a staged S-row merge cheaper than S per-frame scatters?

Port of `tools/scatter_lab.py`.  The `slots="stream"` step writes each
stream's new K/V rows to its own ring row every frame; the staged design
writes each frame's rows to a small frame-major stage and merges S
frames into the ring in one S-row write every S frames.  Five write
forms on the cache's real shapes, (B, P=7, T, 4D=1024) bf16:

  dus1     per-frame global slice write   cache[:, :, g % T] = rows
  scat1    per-frame per-stream row write cache[b, :, n_b % T] = rows_b
  scat8    S-row per-stream write (the staged merge), / S; its values
           (B, S, P, 4D) in the advanced-index result layout
  stage_w  per-frame stage write          stage[g % S] = rows
  dus8     S-row aligned global slice write (the staged-global merge),
           / S; the start clamped to T - S, as a dynamic_update_slice

Each is timed in ms per frame with the rows evolving (rows * 0.999 a
step) through the component bench's CUDA-event chain
(`tools/component_bench.py` `timed`).  g is the host's tick; n the
per-stream frame counts on the device (stream b starts at b % 11).

    python -m vap_realtime_tpu_torch.tools.scatter_lab [--batch 4096]
        [--T 50] [--S 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import torch

from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.tools.component_bench import timed

P, D4 = 7, 1024


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# each body: (buf, rows, n, g) -> the next, T and S bound; buf is the
# cache (the stage for stage_w); rows (B, P, D4), or (B, S, P, D4) for
# the S-row forms; n (B,) int64 on the device; g the host's tick
def dus1(carry, T, S):
    c, r, n, g = carry
    c[:, :, g % T] = r
    return c, r * 0.999, n, g + 1


def scat1(carry, T, S):
    c, r, n, g = carry
    c[torch.arange(c.shape[0], device=c.device), :, n % T] = r
    return c, r * 0.999, n + 1, g


def scat8(carry, T, S):
    c, r, n, g = carry
    idx = (n[:, None] + torch.arange(S, device=n.device)[None, :]) % T
    c[torch.arange(c.shape[0], device=c.device)[:, None], :, idx] = r
    return c, r * 0.999, n + S, g


def stage_w(carry, T, S):
    st, r, n, g = carry
    st[g % S] = r.reshape(r.shape[0], -1)
    return st, r * 0.999, n, g + 1


def dus8(carry, T, S):
    c, r, n, g = carry
    base = min((g // S * S) % T, T - S)
    c[:, :, base:base + S] = r.transpose(1, 2)
    return c, r * 0.999, n, g + S


BODIES = {"dus1": dus1, "scat1": scat1, "scat8": scat8, "stage_w": stage_w,
          "dus8": dus8}
S_ROW = ("scat8", "dus8")        # S frames' rows a call


def initial(name: str, B: int, T: int, S: int, device, seed: int = 0):
    """The first carry of body `name`: a zero cache (the stage for
    stage_w), seeded bf16 rows, n = b % 11, g = 0."""
    g = torch.Generator().manual_seed(seed)
    shape = (B, S, P, D4) if name in S_ROW else (B, P, D4)
    r = torch.randn(*shape, generator=g).to(device, torch.bfloat16)
    buf = torch.zeros(*((S, B, P * D4) if name == "stage_w"
                        else (B, P, T, D4)),
                      dtype=torch.bfloat16, device=device)
    return buf, r, torch.arange(B, device=device) % 11, 0


def main(argv: Optional[list] = None) -> Dict[str, float]:
    """Returns {body: ms per frame}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--S", type=int, default=8)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, T, S = args.batch, args.T, args.S
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (host clock)")
    log(f"device: {where}  B={B} T={T} S={S}")
    results = {}
    for name, body in BODIES.items():
        carry = initial(name, B, T, S, dev)
        results[name] = timed(lambda c, b=body: b(c, T, S), carry,
                              args.iters, dev) / (S if name in S_ROW else 1)
        del carry
        log(f"{name:8s} {results[name]:8.3f} ms/frame")
    print({k: round(v, 3) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
