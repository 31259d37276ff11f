"""The traced run's reading of the device: `torch.profiler` over a steady
stretch of the window, reduced to a summary (never a whole trace).

The harness marks its own calls with `record_function` ranges named
`vapbench.<what>` (the tick, the arena call, the readback, the wait, the
pacing) and, through `kernel_layers.json`, the port functions whose
kernels make up a layer (`vapbench.layer.<layer>`).  A device operation
belongs to the layer whose range holds the host call that launched it
(matched by the profiler's correlation id); otherwise to the first
kernel-name pattern of the map that matches its name; otherwise to the
map's default layer.  Copies and memsets count as device time but belong
to no layer.
"""

from __future__ import annotations

import contextlib
import importlib
import re
from typing import Dict, List, Optional, Tuple

from vapbench.common import HERE, load_json

Interval = Tuple[float, float]


def kernel_map() -> Dict:
    return load_json(f"{HERE}/kernel_layers.json")


def union(iv: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(iv: List[Interval], spans: List[Interval]) -> float:
    """Length of the union of `iv` inside the union of `spans`."""
    iv, spans = union(iv), union(spans)
    total, j = 0.0, 0
    for s, e in spans:
        while j < len(iv) and iv[j][1] <= s:
            j += 1
        k = j
        while k < len(iv) and iv[k][0] < e:
            total += max(0.0, min(e, iv[k][1]) - max(s, iv[k][0]))
            k += 1
    return total


def length(iv: List[Interval]) -> float:
    return sum(e - s for s, e in union(iv))


@contextlib.contextmanager
def layer_spans():
    """Wrap each port function that `kernel_layers.json` names under
    "spans" in a `vapbench.layer.<layer>` range while the block runs."""
    import torch

    patched = []
    for layer, targets in kernel_map().get("spans", {}).items():
        for target in targets:
            mod_name, fn_name = target.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)

            def wrapped(*a, _orig=orig, _name=f"vapbench.layer.{layer}",
                        **kw):
                with torch.profiler.record_function(_name):
                    return _orig(*a, **kw)
            setattr(mod, fn_name, wrapped)
            patched.append((mod, fn_name, orig))
    try:
        yield
    finally:
        for mod, fn_name, orig in patched:
            setattr(mod, fn_name, orig)


class Profile:
    """Start / stop the profiler around a stretch; `summary()` after."""

    def __init__(self, cpu: bool = True):
        """cpu: also record the host's ops and the harness's ranges (the
        layer spans need them); without, only the device's activity and
        the runtime calls, at a fraction of the host overhead."""
        import torch

        self.torch = torch
        self.cpu = cpu
        self.prof = None
        self.counters: Dict[str, int] = {}
        self._at_start: Dict[str, int] = {}

    def warm(self) -> None:
        """One empty profile, so the stretch pays no first-start cost."""
        torch = self.torch
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.cpu:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self._at_start = read_counters()
        self.prof.__enter__()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        end = read_counters()
        self.counters = {k: end[k] - self._at_start[k] for k in end}

    def summary(self) -> Dict:
        return summarize(self.prof.events(), kernel_map())


def read_counters() -> Dict[str, int]:
    """The port's launch counters that `kernel_layers.json` names under
    "counters" ({name: "module:object.attribute"})."""
    out = {}
    for name, target in kernel_map().get("counters", {}).items():
        mod_name, path = target.split(":")
        obj = importlib.import_module(mod_name)
        for part in path.split("."):
            obj = getattr(obj, part)
        out[name] = int(obj)
    return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def summarize(events, kmap: Dict) -> Dict:
    """Reduce the profiler's events (times in microseconds from the
    trace's start) to: the harness's ranges by name, the device ops with
    their layers and whether the stretch launched them (their launch is
    among its runtime calls), and the launch lookups' coverage."""
    from torch.autograd import DeviceType

    ranges: Dict[str, List[Interval]] = {}
    launch_at: Dict[int, float] = {}
    runtime: Dict[str, float] = {}
    syncs: List[Interval] = []
    host_ops: List[Tuple[float, float, str]] = []
    device: List[Tuple[str, float, float, int]] = []
    for ev in events:
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            # the profiler mirrors host annotations on the device's
            # timeline; they are not device work
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("vapbench.") or "#" in ev.name):
                device.append((ev.name, s, e, ev.id))
        elif ev.name.startswith("vapbench."):
            ranges.setdefault(ev.name, []).append((s, e))
        elif ev.name.startswith(("cuda", "cu")):
            runtime[ev.name] = runtime.get(ev.name, 0.0) + e - s
            if ev.id:
                launch_at[ev.id] = s
            if ev.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
                syncs.append((s, e))
        elif ev.name.startswith("aten::"):
            host_ops.append((s, e, ev.name))
    layer_ranges = {k[len("vapbench.layer."):]: sorted(v)
                    for k, v in ranges.items()
                    if k.startswith("vapbench.layer.")}
    pats = [(re.compile(p), layer) for p, layer in kmap["kernels"]]
    default = kmap["default"]
    ops = []
    n_span = n_name = n_default = 0
    for name, s, e, cid in device:
        t = launch_at.get(cid)
        launched = t is not None
        if _is_copy(name):
            ops.append({"name": name, "s": s, "e": e, "layer": None,
                        "launched": launched})
            continue
        layer = None
        if launched:
            for lname, rs in layer_ranges.items():
                if any(a <= t <= b for a, b in rs):
                    layer = lname
                    n_span += 1
                    break
        if layer is None:
            for rx, lname in pats:
                if rx.search(name):
                    layer = lname
                    n_name += 1
                    break
        if layer is None:
            layer = default
            n_default += 1
        ops.append({"name": name, "s": s, "e": e, "layer": layer,
                    "launched": launched})
    top = sorted(runtime.items(), key=lambda kv: -kv[1])[:6]
    # which host op each blocking sync ran inside (the innermost)
    by_op: Dict[str, List[float]] = {}
    for s, e in syncs:
        holders = [(b - a, n) for a, b, n in host_ops if a <= s and e <= b]
        name = min(holders)[1] if holders else "none"
        c = by_op.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += e - s
    return {"ranges": ranges, "ops": ops, "syncs_by_host_op": by_op,
            "attributed": {"by_span": n_span, "by_name": n_name,
                           "by_default": n_default,
                           "launches_seen": len(launch_at),
                           "ops_not_launched": sum(not op["launched"]
                                                   for op in ops)},
            "host_runtime_s": top}


def device_time(ops, layer: str) -> float:
    """Summed seconds of `layer`'s ops that the profiled stretch launched
    (their launch is among its runtime calls): the work of the ticks or
    steps dispatched inside it, wherever the device's clock puts it
    against the host's ranges."""
    return sum(op["e"] - op["s"] for op in ops
               if op["layer"] == layer and op["launched"])


def dispatched(ctx) -> int:
    """The ticks (or steps) dispatched inside the profiled stretch: the
    ranges of the loop's first range name (the open loop's tick, the
    closed loop's dispatch; the stop's synchronise lets each finish)."""
    return len(ctx["summary"]["ranges"].get(ctx["tick_names"][0], []))


def kernel_calls(ops, first: str, then: Optional[str] = None,
                 per_call: int = 1) -> Tuple[int, float]:
    """(whole calls, their summed device seconds) of a kernel over every
    device op of the profiled stretch, with no range filter: the profiler
    records from `Profile.start()` to `Profile.stop()`, whose synchronise
    lets every launch finish.  A call is one launch whose name matches the
    pattern `first`, then the next `per_call - 1` launches on the device
    timeline that match `then`.  A `then` launch with no call open (the
    rest of a call in flight when the stretch began) and a call cut short
    are left out, their count and their time together."""
    rf = re.compile(first)
    rt = re.compile(then) if then else None
    calls, secs = 0, 0.0
    open_ = None                 # [launches, seconds] of the call open
    for op in sorted(ops, key=lambda o: o["s"]):
        if rf.search(op["name"]):
            open_ = [0, 0.0]
        elif open_ is None or rt is None or not rt.search(op["name"]):
            continue
        open_[0] += 1
        open_[1] += op["e"] - op["s"]
        if open_[0] == per_call:
            calls += 1
            secs += open_[1]
            open_ = None
    return calls, secs


def breakdown(summ: Dict, window: Interval) -> Dict:
    """The 10 device ops with the most time in `window`, and the 10
    longest stretches of device idleness summed by the harness range the
    host was in at the time (the innermost `vapbench.*` range holding
    the gap's middle; "other" when none)."""
    a, b = window
    by_name: Dict[str, float] = {}
    busy = []
    for op in summ["ops"]:
        s, e = max(op["s"], a), min(op["e"], b)
        if e > s:
            by_name[op["name"]] = by_name.get(op["name"], 0.0) + e - s
            busy.append((s, e))
    gaps = []
    at = a
    for s, e in union(busy):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < b:
        gaps.append((at, b))
    ranges = [(name, s, e) for name, rs in summ["ranges"].items()
              for s, e in rs]
    by_host: Dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        holders = [(re_ - rs, n) for n, rs, re_ in ranges if rs <= mid <= re_]
        name = min(holders)[1] if holders else "other"
        by_host[name] = by_host.get(name, 0.0) + e - s
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_name), "idle_gaps": top(by_host)}


def traced_spans(ctx) -> List[Interval]:
    """The traced stretch's busy spans on the profiler's clock: each
    tick's (or step's) range where the loop runs one at a time, the
    whole stretch where it overlaps them (several range names), or the
    device's first to last operation where the host was not recorded."""
    summ = ctx["summary"]
    names = ctx["tick_names"]
    rs = [r for n in names for r in summ["ranges"].get(n, [])]
    if not rs:
        ops = summ["ops"]
        if not ops:
            return []
        return [(min(op["s"] for op in ops), max(op["e"] for op in ops))]
    if len(names) == 1:
        return sorted(rs)
    return [(min(s for s, _ in rs), max(e for _, e in rs))]


def kernels(ctx) -> List[Interval]:
    return [(op["s"], op["e"]) for op in ctx["summary"]["ops"]
            if op["layer"] is not None]
