"""The 5 Hz cell's readers on hand-built summaries (the form
`trace.summarize` returns), built as `test_vapbench_rooflines.py` builds
them: K7's share counted by the tick reads the same when a frame's stack
runs as one call or as four, and the encoder's rest leaves out K7's
kernels.  Also the cell's files: its configuration is the 20 Hz nod
configuration at 5 Hz, nothing cut."""

import os

import pytest

from vapbench.common import HERE, benchmark, load_config, load_json
from vapbench.counts import conv_stack_fused
from vapbench.run import reader

PEAKS = load_json(os.path.join(HERE, "peaks.json"))
MODEL = {"dim": 256, "encoder_dim": 256}
N, T, STAGE, SHIFT = 32768, 50, 8, 3200       # the 5 Hz cell's sizes
TICKS, PERIOD, BUSY = 20, 0.2, 0.12
BOUND = conv_stack_fused.bound_s(2 * N, SHIFT, PEAKS, 256)
SHARE = 0.41                     # K7's time: its bound over 41%
REST = [("lstm_step_gemm", 0.3e-3), ("sigmoid", 0.1e-3),
        ("downsample_conv", 0.5e-3), ("cast", 0.05e-3)]
CONV0 = "(anonymous namespace)::conv0_kernel(Conv0Args)"
CONV_LAYER = "(anonymous namespace)::conv_layer_kernel(CUtensorMap_st)"


def _op(name, s, d, layer, launched=True):
    return {"name": name, "s": s, "e": s + d, "layer": layer,
            "launched": launched}


def _tick_ops(t, calls):
    """One tick's device work from `t`: K7 as `calls` body calls of five
    launches (conv0's share of a call's time 0.4, each GEMM layer 0.15)
    over the frame, the encoder's other kernels, a trunk op, a copy."""
    per_call = BOUND / SHARE / calls
    ops, at = [], t
    seq = []
    for _ in range(calls):
        seq += [(CONV0, 0.4 * per_call, "encoder")]
        seq += [(CONV_LAYER, 0.15 * per_call, "encoder")] * 4
    seq += [(n, d, "encoder") for n, d in REST]
    seq += [("gemm", 2e-3, "trunk"),
            ("Memcpy DtoH (Device -> Pinned)", 0.1e-3, None)]
    for name, d, layer in seq:
        ops.append(_op(name, at, d, layer))
        at += d + 5e-6
    return ops


def _ctx(calls, shift=0.0):
    ticks = [(0.01 + PERIOD * k, 0.01 + PERIOD * k + BUSY)
             for k in range(TICKS)]
    ops = [dict(op, s=op["s"] - shift, e=op["e"] - shift)
           for a, _ in ticks for op in _tick_ops(a + 0.5e-3, calls)]
    # a tick's work launched before the stretch is not read
    ops.append(_op(CONV0, 0.001, 1.0, "encoder", launched=False))
    ops.append(_op("lstm_step_gemm", 0.002, 1.0, "encoder", launched=False))
    summ = {"ranges": {"vapbench.tick": ticks,
                       "vapbench.pace": [(a - 0.02, a) for a, _ in ticks]},
            "ops": ops}
    return {"summary": summ, "tick_names": ("vapbench.tick",),
            "n_traced": TICKS, "streams": N, "T": T, "stage": STAGE,
            "frame_shift": SHIFT, "model": MODEL, "peaks": PEAKS,
            "counters": {"conv_stack_fused.calls": calls * TICKS}}


def _read(name, ctx):
    return reader(name).read(ctx, name)


@pytest.mark.parametrize("shift", [0.0, 3e-3])
def test_frame_share_reads_the_same_in_one_call_or_four(shift):
    one = _read("conv_stack_frame_roofline.open5", _ctx(1, shift))
    four = _read("conv_stack_frame_roofline.open5", _ctx(4, shift))
    assert one == pytest.approx(100.0 * SHARE, rel=1e-9)
    assert four == pytest.approx(one, rel=1e-9)


def test_the_call_share_counts_four_calls_at_the_whole_frame_bound():
    """Why the 5 Hz cell takes the share by the tick: the call share
    multiplies the whole frame's bound by every call it times, so four
    pieces a frame read four times the truth, over 100%."""
    four = _read("conv_stack_fused_roofline.open", _ctx(4))
    assert four == pytest.approx(4 * 100.0 * SHARE, rel=1e-9)
    assert four > 100.0


@pytest.mark.parametrize("calls", [1, 4])
def test_encoder_rest_leaves_out_k7(calls):
    ctx = _ctx(calls)
    rest = _read("encoder_rest_ms.open5", ctx)
    assert rest == pytest.approx(1e3 * sum(d for _, d in REST), rel=1e-9)
    whole = _read("encoder_ms.open5", ctx)
    assert whole == pytest.approx(rest + 1e3 * BOUND / SHARE, rel=1e-9)


@pytest.mark.parametrize("name", ["conv_stack_frame_roofline.open5",
                                  "encoder_rest_ms.open5"])
def test_new_readers_find_nothing_to_read(name):
    empty = _ctx(1)
    empty["summary"] = {"ranges": {"vapbench.tick": [(0.0, 1.0)]},
                        "ops": []}
    assert _read(name, empty) is None
    none = _ctx(1)
    none["summary"] = None
    assert _read(name, none) is None


def test_the_5hz_configuration_is_the_20hz_nod_one_at_5hz():
    """Same model, serving and training keys as `nod_erica_20hz_10000ms`
    but frame_hz; nothing cut; the cell and its metrics are declared."""
    c5 = load_config("nod_erica_5hz_10000ms")
    c20 = load_config("nod_erica_20hz_10000ms")
    assert c5["reduced"] == [] and c5["model"]["frame_hz"] == 5
    assert {k: v for k, v in c5["model"].items() if k != "frame_hz"} == {
        k: v for k, v in c20["model"].items() if k != "frame_hz"}
    assert c5["serving"] == c20["serving"]
    assert c5["training"] == c20["training"]
    bench = benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}["nod5-fast-open"]
    assert cell["config"] == "nod_erica_5hz_10000ms" and cell["chips"] == 1
    open5 = [m["name"] for m in bench["per_layer"]
             if "nod5-fast-open" in m.get("workloads", [])]
    assert sorted(open5) == sorted([
        "encoder_ms.open5", "trunk_ms.open5", "attend_pair_roofline.open5",
        "device_idle_pct.open5", "step_mfu.open5",
        "conv_stack_frame_roofline.open5", "encoder_rest_ms.open5"])
