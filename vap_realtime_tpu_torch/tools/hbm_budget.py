"""Per-stream device-memory budget of the serving state, and how many
streams one card holds.

Port of `tools/hbm_budget.py`.  Walks the port's own state tensors (the
`init_*_state` functions of each path, built on the `meta` device: shapes
only, nothing is allocated) and prints the bytes per stream of each path
(full, kv, fast, hybrid, fast_hybrid), state dtype (bf16, float32) and
int8 cache mode (per-row scales "q8", frozen per-stream scales "q8g"),
with the stream capacity of the card after the params (bf16) and a 10%
workspace reserve.  As in the JAX tool, a row is the state without the
stage (slots "stream" / "global"); the serving default, slots="staged",
adds each stream's (S, P * 4D) stage, in a column of its own.

The card's memory is `torch.cuda.get_device_properties(0).total_memory`,
or --hbm_gb GiB; without either the tool raises.

Run: python -m vap_realtime_tpu_torch.tools.hbm_budget [--markdown]
         [--hbm_gb 80]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime.arena import init_path_state
from vap_realtime_tpu_torch.weights.convert import tree_items

WORKSPACE_FRACTION = 0.10          # activations and scratch reserve
PROBE_BATCH = 8                    # per-stream bytes do not depend on it
PATHS = ("full", "kv", "fast", "hybrid", "fast_hybrid")
DTYPES = ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
QUANTS = ((True, "int8 row-scales (q8)"),
          ("global", "int8 frozen scales (q8g)"))


def state_tensors(state) -> Iterator[torch.Tensor]:
    """Every tensor of a path's state (dataclasses and dicts of tensors;
    host ints such as the tick counter hold no device memory)."""
    if isinstance(state, torch.Tensor):
        yield state
    elif dataclasses.is_dataclass(state):
        for f in dataclasses.fields(state):
            yield from state_tensors(getattr(state, f.name))
    elif isinstance(state, dict):
        for v in state.values():
            yield from state_tensors(v)


def state_bytes(path: str, cfg: VapConfig, dtype, quant=False,
                staged: bool = False, batch: int = PROBE_BATCH) -> int:
    """Bytes per stream of one path's state at `dtype` / `quant`."""
    st = init_path_state(path, cfg, batch, dtype, "meta", staged=staged,
                         quant=quant)
    total = sum(t.numel() * t.element_size() for t in state_tensors(st))
    return total // batch


def params_bytes(params) -> int:
    """The serving params' bytes in bf16."""
    return sum(int(np.prod(np.shape(v))) * 2 for _, v in tree_items(params))


def card_bytes(hbm_gb: Optional[float] = None) -> int:
    """--hbm_gb GiB, else the card's total memory; raises without
    either."""
    if hbm_gb is not None:
        return int(hbm_gb * 1024**3)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card to read the memory of: pass "
                           "--hbm_gb")
    return torch.cuda.get_device_properties(0).total_memory


def budget(cfg: VapConfig, params, hbm_bytes: int) -> List[Dict]:
    """One row per path, dtype and int8 mode: bytes per stream without
    and with the stage, and the streams that fit in `hbm_bytes` for
    each."""
    usable = hbm_bytes * (1 - WORKSPACE_FRACTION) - params_bytes(params)
    modes = [(d, label, False) for d, label in DTYPES]
    modes += [(torch.bfloat16, label, q) for q, label in QUANTS]
    rows = []
    for path in PATHS:
        for dtype, label, quant in modes:
            if path == "full" and quant:
                continue             # the full path keeps no cache
            per = state_bytes(path, cfg, dtype, quant)
            row = dict(path=path, label=label, bytes=per,
                       cap=int(usable // per))
            if path != "full":
                staged = state_bytes(path, cfg, dtype, quant, staged=True)
                row.update(staged_bytes=staged,
                           staged_cap=int(usable // staged))
            rows.append(row)
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--hbm_gb", type=float, default=None,
                    help="device memory in GiB (default: the card's)")
    args = ap.parse_args(argv)

    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    params = synthetic_params(cfg.frame_hz)
    hbm = card_bytes(args.hbm_gb)
    rows = budget(cfg, params, hbm)
    where = (f"{args.hbm_gb} GiB" if args.hbm_gb is not None else
             f"{torch.cuda.get_device_name(0)}, {hbm / 1024**3:.2f} GiB")
    hdr = ("path", "state dtype", "bytes/stream", f"capacity @ {where}",
           "bytes/stream staged", "capacity staged")
    if args.markdown:
        print("| " + " | ".join(hdr) + " |")
        print("|" + "---|" * len(hdr))
        for r in rows:
            staged = (f"{r['staged_bytes']:,} | {r['staged_cap']:,} streams"
                      if "staged_bytes" in r else "- | -")
            print(f"| {r['path']} | {r['label']} | {r['bytes']:,} | "
                  f"{r['cap']:,} streams | {staged} |")
    else:
        print(f"params (bf16): {params_bytes(params) / 1e6:.1f} MB; "
              f"reserve {WORKSPACE_FRACTION:.0%} workspace; {where}")
        for r in rows:
            staged = (f"; staged {r['staged_bytes'] / 1024:8.1f} KiB -> <= "
                      f"{r['staged_cap']:,}" if "staged_bytes" in r else "")
            print(f"{r['path']:12s} {r['label']:5s} {r['bytes'] / 1024:8.1f} "
                  f"KiB/stream -> <= {r['cap']:,} streams/card{staged}")
    return rows


if __name__ == "__main__":
    main()
