"""The port's spans in the traced run (`vapbench/program.py`): the clock
mapping under `torch.profiler` on the CPU, the readers of the new
metrics on hand-built summaries, and the parent's port (no recorder, no
`program` key): no new key, no new metric, the harness's breakdown."""

import json
import time

import pytest

from vapbench import program
from vapbench.program import PER_LAYER
from vapbench.run import reader
from vapbench.trace import breakdown as base_breakdown

READERS = sorted({m["name"] for m in PER_LAYER})


def _range(prof, name):
    evs = [e for e in prof.events() if e.name == name]
    assert len(evs) == 1, name
    return evs[0].time_range.start * 1e-6, evs[0].time_range.end * 1e-6


def test_program_spans_map_onto_the_profilers_clock():
    """A program span and a `record_function` range opened at the same
    points land within 0.5 ms of each other; the nesting holds."""
    import torch

    from vap_realtime_tpu_torch.utils import spans

    with program.recording():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            anchors = [program.anchor(torch, False)]
            time.sleep(0.02)
            with spans.span("vap.tick", id=5), \
                    torch.profiler.record_function("vapbench.t.outer"):
                time.sleep(0.01)
                with spans.span("vap.probs"), \
                        torch.profiler.record_function("vapbench.t.inner"):
                    torch.ones(64).sum()
                    time.sleep(0.005)
                time.sleep(0.01)
            time.sleep(0.02)
            anchors.append(program.anchor(torch, False))
        summ = {}
        program.extend(summ, prof.events(), anchors)
    assert summ["program_clock"]["anchors"] == 2
    assert summ["program_clock"]["residual_s"] < 5e-4
    p = summ["program"]
    assert [x["name"] for x in p] == ["vap.tick", "vap.probs"]
    assert p[1]["parent"] == 0 and p[1]["id"] == p[0]["id"] == 5
    for x, name in zip(p, ("vapbench.t.outer", "vapbench.t.inner")):
        s, e = _range(prof, name)
        assert abs(x["s"] - s) < 5e-4 and abs(x["e"] - e) < 5e-4, name
    assert p[0]["s"] <= p[1]["s"] <= p[1]["e"] <= p[0]["e"]
    assert program.profiled(summ, ("vap.tick",)) == [0]


def _summary():
    """Two ticks in the traced stretch [0, 1] s: tick 0 merges; one sync
    in vap.probs each, one outside every span."""
    P = []

    def add(name, s, e, parent=-1, n=None, tick=0):
        P.append({"name": name, "s": s, "e": e, "hs": 100 + s,
                  "he": 100 + e, "parent": parent, "id": tick, "n": n})
        return len(P) - 1

    for t, t0 in enumerate((0.1, 0.5)):
        tick = add("vap.tick", t0, t0 + 0.3, tick=t)
        trunk = add("vap.trunk", t0 + 0.05, t0 + 0.25, tick, tick=t)
        if t == 0:
            add("vap.merge", t0 + 0.1, t0 + 0.12, trunk)
        add("vap.probs", t0 + 0.2, t0 + 0.24, trunk, tick=t)
    ops = [{"name": "scatter", "s": 0.2, "e": 0.203, "copy": False,
            "span": 2},
           {"name": "memcpy", "s": 0.21, "e": 0.211, "copy": True,
            "span": 2},
           {"name": "gemm", "s": 0.3, "e": 0.301, "copy": False,
            "span": 1},
           {"name": "cast", "s": 0.45, "e": 0.451, "copy": False,
            "span": None}]
    return {"ranges": {"vapbench.tick": [(0.1, 0.4), (0.5, 0.8)]},
            "ops": [], "program": P, "launch_spans": ops,
            "syncs_by_span": {"vap.probs": [2, 0.004], "none": [1, 0.001]},
            "program_clock": {"anchors": 2, "residual_s": 0.0,
                              "profile": [0.0, 1.0], "dropped": 0}}


def _ctx(summ, host=None):
    return {"summary": summ, "host": host or {"tick": [(100.05, 100.45)]},
            "n_traced": 2, "tick_names": ("vapbench.tick",)}


def test_host_syncs_counts_syncs_in_spans_per_tick():
    got = reader("host_syncs.open").read(_ctx(_summary()), "host_syncs.open")
    assert got == 1.0


def test_probs_host_ms_reads_the_untraced_ticks():
    # only the first tick's spans start inside the host tick span
    got = reader("probs_host_ms.open").read(_ctx(_summary()),
                                            "probs_host_ms.open")
    assert got == pytest.approx(40.0)


def test_merge_ms_divides_by_the_merges():
    got = reader("merge_ms.open").read(_ctx(_summary()), "merge_ms.open")
    assert got == pytest.approx(4.0)


def test_train_encoder_ms_reads_kernels_inside_the_encoder():
    summ = _summary()
    for p in summ["program"]:
        p["name"] = {"vap.tick": "vap.train.step",
                     "vap.trunk": "vap.forward",
                     "vap.merge": "vap.encode"}.get(p["name"], p["name"])
    ctx = _ctx(summ, {"step": [(100.05, 100.45)]})
    got = reader("train_encoder_ms.train").read(ctx,
                                                "train_encoder_ms.train")
    assert got == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_for_the_parents_port(name):
    """No `program` key (a port without the recorder): no reading."""
    summ = _summary()
    for k in ("program", "launch_spans", "syncs_by_span", "program_clock"):
        summ.pop(k)
    assert reader(name).read(_ctx(summ), name) is None
    assert reader(name).read(_ctx(None), name) is None


def test_extend_adds_nothing_without_the_recorder(monkeypatch):
    monkeypatch.setattr(program, "recorder", lambda: None)
    summ = {"ranges": {}}
    assert program.anchor(None, True) is None
    program.extend(summ, [], [None, None])
    assert summ == {"ranges": {}}
    with program.recording():
        pass


def test_breakdown_names_gaps_by_program_spans_else_the_harness():
    """With the program's spans: the gaps between every device operation
    (a kernel named with '#' included), named by the innermost span.
    Without: the harness's breakdown as it is."""
    summ = _summary()
    summ["ops"] = [{"name": "k", "s": 0.1, "e": 0.15, "layer": "trunk"},
                   {"name": "k", "s": 0.3, "e": 0.4, "layer": "trunk"}]
    summ["launch_spans"] = [
        {"name": "k", "s": 0.1, "e": 0.15, "t": 0.1, "copy": False,
         "span": 1},
        {"name": "f<{lambda()#1}>", "s": 0.15, "e": 0.19, "t": 0.11,
         "copy": False, "span": 1},
        {"name": "k", "s": 0.3, "e": 0.4, "t": 0.2, "copy": False,
         "span": 2}]
    got = program.breakdown(summ, (0.1, 0.4), base_breakdown)
    gaps = dict(map(tuple, got["idle_gaps"]))
    # the gap 0.19-0.3 has its middle (0.245) in vap.trunk (0.15-0.35),
    # after the merge (0.2-0.22)
    assert gaps == {"vap.trunk": pytest.approx(0.11)}
    assert dict(map(tuple, got["device_ops"]))["f<{lambda()#1}>"] == \
        pytest.approx(0.04)
    summ.pop("program")
    assert program.breakdown(summ, (0.1, 0.4), base_breakdown) == \
        base_breakdown(summ, (0.1, 0.4))
    assert dict(map(tuple, base_breakdown(summ, (0.1, 0.4))["idle_gaps"])) \
        == {"vapbench.tick": pytest.approx(0.15)}


def test_span_table_and_coverage():
    ctx = _ctx(_summary())
    t = program.span_table(ctx)
    assert set(t) == {"vap.tick", "vap.trunk", "vap.merge", "vap.probs"}
    assert t["vap.probs"]["host_self_ms"] == pytest.approx(40.0)
    assert t["vap.tick"]["host_self_ms"] == pytest.approx(100.0)
    assert t["vap.merge"]["device_ms"] == pytest.approx(2.0)
    ctx["summary"]["launch_spans"][-1]["t"] = 0.2
    assert program.coverage(ctx["summary"]) == {
        "kernels": 3, "with_span": 2, "share": pytest.approx(2 / 3),
        "harness": {"vapbench.tick": 1}, "named_with_hash": 0}
    assert program.span_table(_ctx({})) is None


def test_per_layer_entries_keep_the_contract():
    import re

    from vapbench.common import benchmark

    bench = benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in PER_LAYER:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$", m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        assert m["layer"] in layers and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert all(c in e2e[m["moves"]]["workloads"] for c in m["workloads"])


def test_log_program_lines(capsys):
    ctx = _ctx(_summary())
    program.log_program(ctx)
    err = capsys.readouterr().err.splitlines()
    assert [ln.split(" {")[0].split(" [")[0] for ln in err] == [
        "program: clock", "program: kernel launches with a span",
        "program: blocking syncs by the span they ran in",
        "program: idle share of the traced spans over every kernel",
        "program: per span (count, host self ms a tick over the untraced "
        "ticks, device ms a tick traced, summed n)",
        "program: the 12 kernels with the most device time, by the span "
        "of each launch"]
    # the traced ticks 0.1-0.4 and 0.5-0.8 hold 4 ms of kernels (the copy
    # and the launch at 0.45 are left out)
    idle = json.loads(err[3][err[3].index("{"):])
    assert idle["busy_s"] == pytest.approx(0.004)
    assert program.kernels_by_span(ctx["summary"])[0] == [
        "scatter", pytest.approx(3.0), {"vap.merge": 1}]
    program.log_program(_ctx({}))
    assert capsys.readouterr().err == ""
