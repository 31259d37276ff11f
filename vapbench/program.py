"""The port's own layer spans (`vap_realtime_tpu_torch/utils/spans.py`)
in the traced run: recorded on the host clock, put on the profiler's
clock, and read by per-layer metrics.

What it adds to a traced run, each a call from the harness's trace:

- `recording()`: the recorder on for the run (the traced run only);
- `anchor()`: one point on both clocks, taken as the profile starts and
  as it stops: the end of a `cudaStreamQuery` runtime call and
  `perf_counter_ns()` read as it returns (visible with device activity
  alone, as in the train cell's trace; the two clocks agree within 1
  ppm and the call's end within 2 us of the host's reading on the
  card); on the CPU the end of a `record_function` range.  The check:
  the share of `vap.upload` spans holding their `cudaMemcpyAsync`;
- `extend()`: the summary's `program` (every span, on both clocks),
  `launch_spans` (each device operation with the innermost program span
  of its launch, found by correlation id) and `syncs_by_span` (each
  blocking sync by its innermost program span, or "none");
- `breakdown()`: idle gaps named by the innermost range among the
  harness's and the program's;
- `span_table()`: the per-span log line.

Against a port without the recorder, `recording()` and `anchor()` do
nothing, `extend()` adds no key, the breakdown is the harness's and the
readers (`metrics/host_syncs.py`, `probs_host_ms.py`, `merge_ms.py`,
`train_encoder_ms.py`) return None.

`python3 -m vapbench.program` runs one cell as `vapbench.run` does,
with these calls in place in the process (its files unchanged), the
metrics of `PER_LAYER` added to the cell's and the per-span table
logged; `--record 1` with `--trace 0` times the cell with the recorder
on (its on-cost):

    python3 -m vapbench.program --workload vap20-fast-open --seed 7 \
        --seconds 20 --trace 1
"""

from __future__ import annotations

import time

T_PROC = time.time()

import bisect  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import re  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

SPANS = "vap_realtime_tpu_torch.utils.spans"
ANCHOR = "vapbench.anchor"
QUERY = "cudaStreamQuery"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
ROOTS = ("vap.tick", "vap.train.step")
# runtime calls that put work on the device (kernels, copies, fills)
LAUNCH = re.compile(r"Launch|Memcpy|Memset")

_OPEN = ["vap20-fast-open", "nod20-fast-open"]
_SAT = ["vap20-fast-sat"]
_TRAIN = ["vap20-train-b8x20s"]
# the per-layer metrics that read the program's spans, as BENCHMARK.json
# entries
PER_LAYER = [
    {"name": "host_syncs.open", "unit": "syncs/tick", "better": "lower",
     "source": "device_trace", "layer": "step",
     "moves": "frame_latency_p95_ms", "workloads": _OPEN},
    {"name": "host_syncs.sat", "unit": "syncs/tick", "better": "lower",
     "source": "device_trace", "layer": "step",
     "moves": "stream_frames_per_s", "workloads": _SAT},
    {"name": "host_syncs.train", "unit": "syncs/step", "better": "lower",
     "source": "device_trace", "layer": "training",
     "moves": "train_audio_s_per_s", "workloads": _TRAIN},
    {"name": "probs_host_ms.open", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": "trunk",
     "moves": "frame_latency_p95_ms", "workloads": _OPEN},
    {"name": "probs_host_ms.sat", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": "trunk",
     "moves": "stream_frames_per_s", "workloads": _SAT},
    {"name": "merge_ms.open", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "trunk",
     "moves": "frame_latency_p95_ms", "workloads": _OPEN},
    {"name": "train_encoder_ms.train", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "encoder",
     "moves": "train_audio_s_per_s", "workloads": _TRAIN},
]


def recorder():
    """The port's span recorder module, or None when the port has none."""
    try:
        return importlib.import_module(SPANS)
    except ImportError:
        return None


@contextlib.contextmanager
def recording():
    """The port's recorder on (and emptied) while the block runs."""
    rec = recorder()
    if rec is None:
        yield
        return
    rec.take()
    rec.enable(True)
    try:
        yield
    finally:
        rec.enable(False)


def anchor(torch, cuda: bool) -> Optional[Tuple[int, str]]:
    """(host ns as the event ends, the event's name) of one event the
    profiler records: a stream query on the card, a `record_function`
    range on the CPU.  None without the recorder."""
    if recorder() is None:
        return None
    if cuda:
        # the first runtime call after the profiler starts takes ~2 ms
        # that its runtime event leaves out: the anchor is the second
        stream = torch.cuda.current_stream()
        stream.query()
        stream.query()
    else:
        with torch.profiler.record_function(ANCHOR):
            pass
    return time.perf_counter_ns(), QUERY if cuda else ANCHOR


def clock_map(anchors, marks: Dict[str, List[Tuple[float, float]]]):
    """host ns -> profiler seconds, fitted through the anchors: each
    anchor's host reading to the end of its event (`marks`: name ->
    (start, end) in profiler seconds, in time order).  The pair of events
    whose distance best matches the anchors' host distance is taken.
    Returns (function, residual seconds) or (None, None)."""
    anchors = [a for a in anchors if a is not None]
    if not anchors:
        return None, None
    hs = [h for h, _ in anchors]
    ev = [[e for _, e in marks.get(kind, [])] for _, kind in anchors]
    if any(not e for e in ev):
        return None, None
    if len(anchors) == 1:
        m0 = ev[0][0]
        return (lambda ns: m0 + (ns - hs[0]) * 1e-9), 0.0
    span_h = (hs[-1] - hs[0]) * 1e-9
    best = None
    for t0 in ev[0]:
        for t1 in ev[-1]:
            if t1 <= t0:
                continue
            r = abs((t1 - t0) - span_h)
            if best is None or r < best[0]:
                best = (r, t0, t1)
    if best is None:
        return None, None
    r, t0, t1 = best
    k = (t1 - t0) / (hs[-1] - hs[0])
    return (lambda ns: t0 + (ns - hs[0]) * k), r


def _innermost(program, starts, t: float) -> Optional[int]:
    """Index of the innermost program span holding profiler time t: from
    the last span to start at or before t, up its parents."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        p = program[i]
        if p["s"] <= t <= p["e"]:
            return i
        i = p["parent"]
    return None


def extend(summ: Dict, events, anchors) -> None:
    """Add the program's spans to a summary (see the module docstring);
    leaves it as it is without the recorder, spans or a clock."""
    rec = recorder()
    if rec is None:
        return
    records = rec.take()
    from torch.autograd import DeviceType

    from vapbench.trace import _is_copy

    marks: Dict[str, List[Tuple[float, float]]] = {}
    launch_at: Dict[int, float] = {}
    syncs: List[Tuple[float, float]] = []
    copies: List[float] = []
    device = []
    for ev in events:
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            # the profiler mirrors host annotations on the device's
            # timeline; a kernel's name may hold '#' (`{lambda()#1}`)
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("vapbench.")):
                device.append((ev.name, s, e, ev.id))
            continue
        if ev.name in (QUERY, ANCHOR):
            marks.setdefault(ev.name, []).append((s, e))
        if ev.name.startswith(("cuda", "cu")):
            if ev.id and LAUNCH.search(ev.name):
                launch_at[ev.id] = s
            if ev.name in SYNCS:
                syncs.append((s, e))
            if ev.name == "cudaMemcpyAsync":
                copies.append(s)
    to_prof, residual = clock_map(anchors, {k: sorted(v)
                                            for k, v in marks.items()})
    if to_prof is None or not records:
        return
    program = [{"name": r.name, "s": to_prof(r.start_ns),
                "e": to_prof(r.end_ns), "hs": r.start_ns * 1e-9,
                "he": r.end_ns * 1e-9, "parent": r.parent, "id": r.id,
                "n": r.n} for r in records]
    starts = [p["s"] for p in program]
    hosts = [a[0] for a in anchors if a is not None]
    launches = []
    for name, s, e, cid in device:
        t = launch_at.get(cid)
        launches.append({"name": name, "s": s, "e": e, "t": t,
                         "copy": _is_copy(name),
                         "span": (None if t is None
                                  else _innermost(program, starts, t))})
    by_span: Dict[str, List[float]] = {}
    for s, e in syncs:
        i = _innermost(program, starts, s)
        c = by_span.setdefault("none" if i is None else program[i]["name"],
                               [0, 0.0])
        c[0] += 1
        c[1] += e - s
    profile = [to_prof(hosts[0]), to_prof(hosts[-1])]
    copies.sort()
    uploads = [p for p in program if p["name"] == "vap.upload"
               and profile[0] <= p["s"] <= profile[1]]
    held = sum(bisect.bisect_right(copies, p["e"])
               > bisect.bisect_left(copies, p["s"]) for p in uploads)
    summ["program"] = program
    summ["launch_spans"] = launches
    summ["syncs_by_span"] = by_span
    summ["program_clock"] = {"anchors": len(hosts), "residual_s": residual,
                             "profile": profile, "dropped": rec.dropped(),
                             "uploads_holding_their_copy": [held,
                                                            len(uploads)]}


# --- what the readers share ------------------------------------------------

def profiled(summ: Dict, names) -> List[int]:
    """Indices of the program spans named in `names` that started inside
    the profiled stretch (between the two anchors)."""
    a, b = summ["program_clock"]["profile"]
    return [i for i, p in enumerate(summ["program"])
            if p["name"] in names and a <= p["s"] <= b]


def within(summ: Dict, i: Optional[int], names) -> bool:
    """Whether program span i, or one of its parents, is named in
    `names`."""
    program = summ["program"]
    while i is not None and i >= 0:
        if program[i]["name"] in names:
            return True
        i = program[i]["parent"]
    return False


def device_s_within(summ: Dict, names) -> float:
    """Device seconds of the kernels launched inside spans named in
    `names` (copies included)."""
    return sum(op["e"] - op["s"] for op in summ["launch_spans"]
               if within(summ, op["span"], names))


def host_self_s(summ: Dict, spans: List[Tuple[float, float]]
                ) -> Dict[str, List[float]]:
    """Per span name, over the program spans whose host start lies in
    `spans` (host seconds): [count, host seconds, self seconds, sum n]."""
    program = summ["program"]
    iv = sorted(spans)
    starts = [s for s, _ in iv]
    kids = [0.0] * len(program)
    for p in program:
        if p["parent"] >= 0:
            kids[p["parent"]] += p["he"] - p["hs"]
    out: Dict[str, List[float]] = {}
    for i, p in enumerate(program):
        j = bisect.bisect_right(starts, p["hs"]) - 1
        if j < 0 or p["hs"] > iv[j][1]:
            continue
        d = out.setdefault(p["name"], [0, 0.0, 0.0, 0])
        d[0] += 1
        d[1] += p["he"] - p["hs"]
        d[2] += p["he"] - p["hs"] - kids[i]
        d[3] += p["n"] or 0
    return out


def breakdown(summ: Dict, window, base) -> Dict:
    """`base` (the harness's breakdown) with the program's spans among the
    ranges that name the idle gaps, over every device operation
    (`launch_spans`; the harness's `ops` leave out those whose name holds
    '#')."""
    program = summ.get("program")
    if not program:
        return base(summ, window)
    ranges = {k: list(v) for k, v in summ["ranges"].items()}
    for p in program:
        ranges.setdefault(p["name"], []).append((p["s"], p["e"]))
    return base(dict(summ, ranges=ranges, ops=summ["launch_spans"]), window)


def span_table(ctx) -> Optional[Dict[str, Dict[str, float]]]:
    """Per span name: count, host self ms a tick over the untraced ticks,
    device ms a tick of the kernels launched with it innermost (the
    profiled stretch), and the summed n (untraced ticks)."""
    summ = ctx.get("summary") or {}
    if "program" not in summ:
        return None
    host = ctx["host"].get("tick") or ctx["host"].get("step") or []
    ticks = max(1, len(host))
    roots = max(1, len(profiled(summ, ROOTS)))
    dev: Dict[str, float] = {}
    for op in summ["launch_spans"]:
        if op["span"] is not None:
            name = summ["program"][op["span"]]["name"]
            dev[name] = dev.get(name, 0.0) + op["e"] - op["s"]
    out = {}
    for name, (n, _, self_s, total_n) in sorted(
            host_self_s(summ, host).items()):
        out[name] = {"count": n, "host_self_ms": 1e3 * self_s / ticks,
                     "device_ms": 1e3 * dev.get(name, 0.0) / roots,
                     "n": total_n}
    return out


def kernels_by_span(summ: Dict, top: int = 12) -> List:
    """[kernel name (cut to 60 characters), device ms, {innermost span:
    launches}] for the kernels with the most device time."""
    by: Dict[str, List] = {}
    for op in summ["launch_spans"]:
        d = by.setdefault(op["name"][:60], [0.0, {}])
        d[0] += op["e"] - op["s"]
        span = ("none" if op["span"] is None
                else summ["program"][op["span"]]["name"])
        d[1][span] = d[1].get(span, 0) + 1
    return [[k, 1e3 * v[0], v[1]] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1][0])[:top]]


def coverage(summ: Dict) -> Optional[Dict]:
    """Kernel launches (copies left out) of the profiled stretch with a
    program span, of those that reached the device; of the others, those
    the harness launched, by the innermost of its `vapbench.*` ranges
    holding the launch."""
    if "launch_spans" not in summ:
        return None
    ks = [op for op in summ["launch_spans"] if not op["copy"]]
    inside = sum(op["span"] is not None for op in ks)
    harness: Dict[str, int] = {}
    for op in ks:
        if op["span"] is None and op.get("t") is not None:
            held = [(b - a, name) for name, rs in summ["ranges"].items()
                    for a, b in rs if a <= op["t"] <= b]
            if held:
                name = min(held)[1]
                harness[name] = harness.get(name, 0) + 1
    return {"kernels": len(ks), "with_span": inside,
            "share": inside / len(ks) if ks else 0.0,
            "harness": harness,
            "named_with_hash": sum("#" in op["name"] for op in ks)}


def log_program(rctx) -> None:
    """The traced run's stderr lines of the program's spans: the clock,
    the launches with a span, the blocking syncs by span, the idle share
    over every kernel (device_idle_pct's definition) and the per-span
    table; nothing without the `program` key."""
    import json

    from vapbench.common import log
    from vapbench.trace import covered, length, traced_spans

    summ = rctx.get("summary") or {}
    if "program" not in summ:
        return
    log("program: clock", json.dumps(summ["program_clock"]))
    log("program: kernel launches with a span", json.dumps(coverage(summ)))
    log("program: blocking syncs by the span they ran in",
        json.dumps(summ["syncs_by_span"]))
    spans = traced_spans(rctx)
    busy = covered([(op["s"], op["e"]) for op in summ["launch_spans"]
                    if not op["copy"]], spans)
    log("program: idle share of the traced spans over every kernel",
        json.dumps({"idle_pct": 100.0 * (1.0 - busy / length(spans)),
                    "busy_s": busy}))
    log("program: per span (count, host self ms a tick over the untraced "
        "ticks, device ms a tick traced, summed n)",
        json.dumps(span_table(rctx)))
    log("program: the 12 kernels with the most device time, by the span "
        "of each launch", json.dumps(kernels_by_span(summ)))


# --- the run, with the calls in place ---------------------------------------

def install(captured: Dict) -> None:
    """Put `recording`, `anchor`, `extend` and `breakdown` into the
    harness's trace for this process, and keep each run's reader context
    in `captured["reader"]`."""
    from vapbench import run, trace

    layer_spans = trace.layer_spans
    base_breakdown = trace.breakdown
    load_driver = run.driver

    @contextlib.contextmanager
    def spans_and_program():
        with layer_spans(), recording():
            yield

    class Profile(trace.Profile):
        def start(self):
            super().start()
            self.anchors = [anchor(self.torch, True)]

        def stop(self):
            self.anchors.append(anchor(self.torch, True))
            super().stop()

        def summary(self):
            summ = super().summary()
            extend(summ, self.prof.events(), self.anchors)
            return summ

    class Captured:
        def __init__(self, mod):
            self.mod = mod

        def run(self, ctx):
            res = self.mod.run(ctx)
            captured["reader"] = res["reader"]
            return res

    trace.layer_spans = spans_and_program
    trace.Profile = Profile
    trace.breakdown = lambda summ, window: breakdown(summ, window,
                                                     base_breakdown)
    run.driver = lambda kind: Captured(load_driver(kind))


def main(argv=None) -> int:
    import argparse
    import json

    from vapbench.common import (
        benchmark, fmt, gpu_line, log, setup_env,
    )

    setup_env()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--record", type=int, choices=(0, 1), default=0,
                    help="with --trace 0: the recorder on over the run")
    args = ap.parse_args(argv)
    from vapbench import run

    bench = benchmark()
    bench["per_layer"] = bench["per_layer"] + [
        m for m in PER_LAYER
        if m["name"] not in {x["name"] for x in bench["per_layer"]}]
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"{args.workload} is not a cell of BENCHMARK.json")
        return 2
    import torch

    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 3
    log("card:", gpu_line())
    captured: Dict = {}
    install(captured)
    with (recording() if args.record and not args.trace
          else contextlib.nullcontext()):
        line = run.execute(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", bench, t_proc=T_PROC)
    info = line.pop("info")
    log("info:", json.dumps(info, default=str))
    log_program(captured.get("reader") or {})
    for k, v in line["limits"].items():
        log(f"check {k} = {fmt(v['value'])} (limit {fmt(v['limit'])})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
