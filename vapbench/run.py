"""Run one cell of the benchmark and print its result line.

    python3 -m vapbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the checkout's root, on a machine with the card(s) the cell asks
for.  Reads `BENCHMARK.json` for the cell's metrics, the cell's file
`vapbench/workloads/<cell>.json`, its configuration and its driver
(`vapbench/drivers/<kind>.py`).  With --trace 0 the result carries the
cell's end-to-end metrics; with --trace 1 its per-layer metrics (each
read by `vapbench/metrics/<metric>.py`), the device's busy seconds and
the traced window, and a breakdown.  Every run checks what the timed
path served against the plain reference and prints each number compared
beside its limit, as the last lines of standard error and as the last
key of the result line (the last line of standard output).

Exits non-zero without a result when there is no card or too few, when
the files it needs are missing, or when JAX or the JAX package is loaded
in the process once the window has closed.
"""

from __future__ import annotations

import time

T_PROC = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from vapbench.common import (  # noqa: E402
    HERE, benchmark, cell_metrics, fmt, forbidden_loaded, gpu_line,
    load_config, load_json, load_workload, log, setup_env,
)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    path = os.path.join(HERE, "drivers", f"{kind}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"no driver {path}")
    return load_module(path, f"vapbench_driver_{kind}")


def reader(metric: str):
    """`metrics/<metric>.py`, else `metrics/<name before the first dot>.py`."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.isfile(path):
            return load_module(path, "vapbench_metric_"
                               + stem.replace(".", "_"))
    raise SystemExit(f"no reader for the metric {metric}")


def execute(cell: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", bench: Optional[Dict] = None,
            t_proc: Optional[float] = None, **overrides) -> Dict:
    """Everything of a run but the look for a card: the cell's driver,
    its metrics, its check.  Returns the result line's object plus
    "info".  overrides (tests): streams, batch, clip_seconds, control,
    fault, workload / config dicts."""
    bench = benchmark() if bench is None else bench
    wl = overrides.pop("workload", None) or load_workload(cell)
    cfg = overrides.pop("config", None) or load_config(wl["config"])
    with contextlib.ExitStack() as stack:
        ctx = dict(overrides, workload=wl, config=cfg, seed=seed,
                   seconds=seconds, trace=trace, device=device,
                   t_proc=T_PROC if t_proc is None else t_proc,
                   stack=stack)
        res = driver(wl["driver"]).run(ctx)
    found = forbidden_loaded()
    if found:
        log("forbidden modules loaded in the process:", ", ".join(found))
        raise SystemExit(3)
    import torch

    checks = res["checks"]
    correct = bool(res["sound"] and res["failed"] == 0 and all(
        v == v and v <= lim for v, lim in checks.values()))
    out_metrics = {}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name() if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    breakdown = None
    if trace:
        peaks = load_json(os.path.join(HERE, "peaks.json"))
        rctx = dict(res["reader"], peaks=peaks)
        for m in cell_metrics(bench, cell, True):
            v = reader(m["name"]).read(rctx, m["name"])
            if v is not None:
                out_metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        summ = rctx.get("summary")
        if summ:
            from vapbench.trace import breakdown as bd, covered, traced_spans

            spans = traced_spans(rctx)
            window = (min(s for s, _ in spans), max(e for _, e in spans))
            dev["busy_s"] = covered([(op["s"], op["e"]) for op in summ["ops"]],
                                    [window])
            dev["window_s"] = window[1] - window[0]
            breakdown = bd(summ, window)
            unmapped = sorted({op["name"][:120] for op in summ["ops"]
                               if op["layer"] == "trunk"})
            log("trace: attribution", json.dumps(summ["attributed"]))
            log("trace: host seconds in CUDA runtime calls",
                json.dumps(summ["host_runtime_s"]))
            log("trace: blocking syncs by the host op they ran in",
                json.dumps(summ["syncs_by_host_op"]))
            log("trace: counters over the traced stretch",
                json.dumps(rctx["counters"]),
                f"({rctx['n_traced']} ticks or steps)")
            log(f"trace: {len(unmapped)} kernel names counted as trunk:",
                json.dumps(unmapped[:40]))
    else:
        for m in cell_metrics(bench, cell, False):
            if m["name"] not in res["e2e"]:
                raise SystemExit(f"the driver gave no {m['name']}")
            out_metrics[m["name"]] = {"value": float(res["e2e"][m["name"]]),
                                      "unit": m["unit"]}
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": out_metrics,
            "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["limits"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    line["info"] = res["info"]
    return line


def main(argv=None) -> int:
    setup_env()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"{args.workload} is not a cell of BENCHMARK.json")
        return 2
    import torch

    torch.set_num_threads(4)
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA device(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count = "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log("card:", gpu_line())
    line = execute(args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", bench)
    info = line.pop("info")
    log("info:", json.dumps(info, default=str))
    for k, v in line["limits"].items():
        log(f"check {k} = {fmt(v['value'])} (limit {fmt(v['limit'])})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
