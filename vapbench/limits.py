"""The readings a cell's limits are set from: the numbers its check
compares, for sound runs of the program over many seeds (the lower
reading is their largest) and for the control (the upper reading is its
smallest), at the cell's own size, in one process.

Serving cells: per seed, the cell's N streams run `--ticks` ticks back
to back (by default as many as one run of the benchmark's length), and
the check compares the sampled streams' served fields with the float64
reference; the control "fp8" is the reference computed in float8 (every
product's operands and results, every stored activation and the served
fields), in the program's place, on the same streams' audio (no window
needed); "int8_cache" is the port with its int8 ring cache.  Training:
per seed, the cell's set-up and its three checked steps, then the
check; the control "tf32" is the port with TF32 on, and "half_batch"
the fault of a step that sees half of its batch (a step that leaves the
weights unchanged reads 1 on the change and needs no run).

    python3 -m vapbench.limits --workload vap20-fast-open --seeds 12 \
        --controls fp8 --control_seeds 3 [--out limits.json]
"""

from __future__ import annotations

import argparse
import json
import time

from vapbench.common import (
    benchmark, gpu_line, load_config, load_workload, log, setup_env,
)


def serving_seed(wl, cfg, seed: int, ticks: int, controls):
    from vapbench.serving import Serving

    out = {}
    sv = Serving(wl, cfg, seed, "cuda")
    sv.frozen_ticks(3)
    for k in range(ticks):
        sv.audio.fill(k, sv.frames[k % 3])
        sv.collect(*sv.dispatch(k))
    sv.free()
    out["sound"] = sv.check(ticks)
    for c in [c for c in controls if c == "fp8"]:
        sv.control = c                   # the reference in the program's place
        out[c] = sv.check(ticks)
    for c in [c for c in controls if c != "fp8"]:
        sc = Serving(wl, cfg, seed, "cuda", control=c)
        sc.frozen_ticks(3)
        for k in range(ticks):
            sc.audio.fill(k, sc.frames[k % 3])
            sc.collect(*sc.dispatch(k))
        sc.free()
        out[c] = sc.check(ticks)
    return out


def half_batch(step, net):
    """A fault planted in the program: each step sees the first half of
    its batch, so its loss is the mean over the rest."""
    def f(model, batch, gen):
        return step(model, {k: v[:v.shape[0] // 2] for k, v in batch.items()},
                    gen)
    return f


def train_seed(wl, cfg, seed: int, control=None):
    import contextlib

    import torch

    from vapbench.drivers import train as tr

    ctx = {"workload": wl, "config": cfg, "seed": seed, "device": "cuda",
           "trace": False, "stack": contextlib.ExitStack()}
    if control == "half_batch":
        ctx["fault"] = half_batch
    else:
        ctx["control"] = control
    st = tr.setup(ctx)
    params, batches = st["params"], st["batches"]
    losses, grad1, after = st["losses"], st["grad1"], st["after"]
    st.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return tr.check(params, cfg["model"], cfg["training"],
                    batches[:tr.CHECKED], seed, torch.device("cuda"),
                    losses, grad1, after)


def main(argv=None):
    setup_env()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=5_000_000_000)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--also", default="",
                    help="comma-separated seeds to read first, besides "
                         "the --seeds drawn from --first")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    wl = load_workload(args.workload)
    cfg = load_config(wl["config"])
    controls = [c for c in args.controls.split(",") if c]
    log("card:", gpu_line())
    rows = []
    seeds = [int(x) for x in args.also.split(",") if x]
    seeds += [args.first + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        ctl = i < args.control_seeds
        t = time.time()
        if wl["driver"] == "train":
            row = {"seed": seed, "sound": train_seed(wl, cfg, seed)}
            if ctl:
                for c in controls:
                    row[c] = train_seed(wl, cfg, seed, c)
        else:
            ticks = args.ticks or benchmark()["run_seconds"] * \
                cfg["model"]["frame_hz"]
            row = dict(seed=seed, **serving_seed(
                wl, cfg, seed, ticks, controls if ctl else []))
        row["s"] = time.time() - t
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
    names = [k for k in dict.fromkeys(list(wl["check"]["limits"])
                                      + ["max_gap", "rms_gap_ratio"])
             if isinstance(rows[0]["sound"].get(k), float)]
    summary = {"workload": args.workload, "seeds": len(rows)}
    for n in names:
        summary[n] = {"lower": max(r["sound"][n] for r in rows)}
        for c in controls:
            vals = [r[c][n] for r in rows if c in r]
            if vals:
                summary[n][c] = min(vals)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1,
                      default=str)


if __name__ == "__main__":
    main()
