"""What every part of the benchmark shares: paths, the data files, seeds,
percentiles, the device line and the guard against JAX in the process.

Imports neither torch nor the port at module level, so the tests and
the CLI can read the data files without either.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)          # the checkout's root

# top-level module names that must never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vap_realtime_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_workload(name: str) -> Dict:
    """The cell's data file `workloads/<name>.json`; raises if absent."""
    path = os.path.join(HERE, "workloads", f"{name}.json")
    if not os.path.isfile(path):
        raise SystemExit(f"no workload file {path}")
    wl = load_json(path)
    if wl.get("name") != name:
        raise SystemExit(f"{path}: name {wl.get('name')!r} != {name!r}")
    return wl


def load_config(name: str) -> Dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1.  A metric without a
    `workloads` list belongs to every cell (an end-to-end one), or to
    every cell that reports the end-to-end metric it moves (a per-layer
    one)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's seed and integer tags (any
    whole number, negative or above 2**32, is taken modulo 2**64)."""
    import numpy as np

    ss = np.random.SeedSequence([seed % 2 ** 64, *tags])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least q of the values at or below it.  Over frames that share
    a tick (equal weights) it equals the same quantile over ticks."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = max(1, math.ceil(q * len(v)))
    return float(v[k - 1])


def gpu_line() -> str:
    """nvidia-smi's name and power limit of the card(s), or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def setup_env() -> None:
    """Fixed cache directories inside the checkout (never a temporary or
    per-process name), few host threads, and no JAX through a library.
    Call before torch is imported."""
    cache = os.path.join(ROOT, "build", "vapbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_loaded() -> List[str]:
    """Modules of `sys.modules` whose top-level name is forbidden,
    compared as whole names (`vap_realtime_tpu_torch` is not
    `vap_realtime_tpu`)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def fmt(x: Optional[float]) -> str:
    return "none" if x is None else repr(float(x))
