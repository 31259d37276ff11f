"""The kernel shares and the layer milliseconds of the traced run, read
from hand-built summaries (the form `trace.summarize` returns).

Each share takes its count and its time from one set of launches, every
launch of the profiled stretch with no range filter; the layer
milliseconds take the ops the stretch launched over the ticks it
dispatched.  Neither moves when the device's clock puts the ops outside
the host's tick ranges.  `_ranged_share` and `_k7_ranged` give the
former count: the launches timed or, for K7, the port's call counter over
the whole stretch, over the time of only the launches that start inside
the tick ranges."""

import os
import re

import pytest

from vapbench.common import HERE, load_json
from vapbench.counts import attend_pair, conv_stack_fused, lstm_scan
from vapbench.run import reader
from vapbench.trace import kernel_calls, traced_spans

PEAKS = load_json(os.path.join(HERE, "peaks.json"))
MODEL = {"dim": 256, "encoder_dim": 256}
N, T, STAGE, SHIFT = 14336, 200, 8, 800      # the nod cell's sizes
TICKS, PERIOD, BUSY = 20, 0.05, 0.03
D0, DL = 2.322e-3, 0.5e-3       # conv0, each conv_layer: K7 at 41% of
DA, DT = 2.0e-3, 1.0e-3         # its bound; an attend launch, a trunk op
K7_BOUND = conv_stack_fused.bound_s(2 * N, SHIFT, PEAKS, 256)
K7_SHARE = 100.0 * K7_BOUND / (D0 + 4 * DL)
CONV0 = "(anonymous namespace)::conv0_kernel(Conv0Args)"
CONV_LAYER = "(anonymous namespace)::conv_layer_kernel(CUtensorMap_st)"
ATTEND = "void (anonymous namespace)::attend_pair_kernel<__nv_bfloat16>()"


def _op(name, s, d, layer, launched=True):
    return {"name": name, "s": s, "e": s + d, "layer": layer,
            "launched": launched}


def _tick_ops(t):
    """One serving tick's device work from `t`: K7's five launches, the
    LSTM, seven attend launches, trunk kernels, the readback copy."""
    ops, at = [], t
    for name, d, layer in ([(CONV0, D0, "encoder")]
                           + [(CONV_LAYER, DL, "encoder")] * 4
                           + [("lstm_scan_kernel", 0.4e-3, "encoder")]
                           + [(ATTEND, DA, "attend"),
                              ("gemm", DT, "trunk")] * 7
                           + [("Memcpy DtoH (Device -> Pinned)", 0.1e-3,
                               None)]):
        ops.append(_op(name, at, d, layer))
        at += d + 5e-6
    return ops


def _open(shift=0.0):
    """An open loop's stretch of 20 ticks, each in its tick range after
    the pacing gap; the device's ops `shift` seconds earlier than the
    host's ranges put them."""
    ticks = [(0.01 + PERIOD * k, 0.01 + PERIOD * k + BUSY)
             for k in range(TICKS)]
    ops = [dict(op, s=op["s"] - shift, e=op["e"] - shift)
           for a, _ in ticks for op in _tick_ops(a + 0.5e-3)]
    return {"ranges": {"vapbench.tick": ticks,
                       "vapbench.pace": [(a - 0.02, a) for a, _ in ticks]},
            "ops": ops}


def _closed():
    """A closed loop's stretch: it begins while the call of the tick
    dispatched before it is in flight (that call's last three
    `conv_layer_kernel` ops, and the rest of that tick, launched before
    the stretch), then 21 ticks dispatched inside it, back to back."""
    ops = [_op(CONV_LAYER, 1e-4 + i * (DL + 5e-6), DL, "encoder", False)
           for i in range(3)]
    ops.append(_op("gemm", 0.002, DT, "trunk", False))
    at = 0.004
    dispatch = []
    for k in range(TICKS + 1):
        dispatch.append((at - 0.003, at - 0.002))
        ops += _tick_ops(at)
        at = ops[-1]["e"] + 1e-5
    collect = [(a + 0.001, a + 0.02) for a, _ in dispatch[1:]]
    return {"ranges": {"vapbench.dispatch": dispatch,
                       "vapbench.collect": collect}, "ops": ops}


def _ctx(summ, tick_names=("vapbench.tick",)):
    return {"summary": summ, "tick_names": tick_names, "n_traced": TICKS,
            "streams": N, "T": T, "stage": STAGE, "frame_shift": SHIFT,
            "model": MODEL, "peaks": PEAKS,
            "counters": {"conv_stack_fused.calls": TICKS,
                         "attend_pair.launches": 7 * TICKS}}


def _ranged_share(ctx, pattern, bound):
    """K2's and K5's former count: the launches whose start lies inside
    the tick ranges, times the bound, over their time."""
    spans = traced_spans(ctx)
    durs = [op["e"] - op["s"] for op in ctx["summary"]["ops"]
            if pattern in op["name"]
            and any(a <= op["s"] < b for a, b in spans)]
    return 100.0 * bound * len(durs) / sum(durs)


def _read(name, ctx):
    return reader(name).read(ctx, name)


def _k7_ranged(ctx):
    """K7's former count: the port's call counter times the bound, over
    the time of the launches whose start lies inside the tick ranges."""
    spans = traced_spans(ctx)
    t = sum(op["e"] - op["s"] for op in ctx["summary"]["ops"]
            if re.search(r"\bconv0_kernel\b|\bconv_layer_kernel\b",
                         op["name"])
            and any(a <= op["s"] < b for a, b in spans))
    return 100.0 * K7_BOUND * ctx["counters"]["conv_stack_fused.calls"] / t


def test_k7_inside_the_ranges_reads_as_before():
    ctx = _ctx(_open())
    got = _read("conv_stack_fused_roofline.open", ctx)
    assert got == pytest.approx(_k7_ranged(ctx), rel=1e-12)
    assert got == pytest.approx(K7_SHARE, rel=1e-12)
    assert 40.0 < got < 42.0


def test_k7_shifted_out_of_the_ranges_reads_as_unshifted():
    """Each call's conv0 and first conv_layer start in the pacing gap: the
    counter over the time left inside the ranges reads over 100; the
    calls timed over their own time read what they read unshifted."""
    ctx = _ctx(_open(shift=3e-3))
    ops = ctx["summary"]["ops"]
    ticks = ctx["summary"]["ranges"]["vapbench.tick"]
    k7 = [op for op in ops if "conv" in op["name"]]
    outside = [op for op in k7
               if not any(a <= op["s"] < b for a, b in ticks)]
    assert len(outside) == 2 * TICKS
    assert {op["name"] for op in outside} == {CONV0, CONV_LAYER}
    assert _k7_ranged(ctx) > 100.0
    got = _read("conv_stack_fused_roofline.open", ctx)
    assert got == pytest.approx(_read("conv_stack_fused_roofline.open",
                                      _ctx(_open())), abs=1e-9)
    assert got == pytest.approx(K7_SHARE, abs=1e-9)


def test_k7_leaves_out_the_cut_call_of_a_closed_loop():
    """The stretch begins with a call's last three `conv_layer_kernel`
    ops: neither their count nor their time is read."""
    summ = _closed()
    assert kernel_calls(summ["ops"], r"\bconv0_kernel\b",
                        r"\bconv_layer_kernel\b", 5) == pytest.approx(
        (TICKS + 1, (TICKS + 1) * (D0 + 4 * DL)), rel=1e-12)
    ctx = _ctx(summ, ("vapbench.dispatch", "vapbench.collect"))
    got = _read("conv_stack_fused_roofline.sat", ctx)
    assert got == pytest.approx(K7_SHARE, rel=1e-12)


def test_kernel_calls_counts_whole_calls_only():
    ops = [_op("a", 0.0, 1.0, None), _op("b", 1.0, 1.0, None),
           _op("x", 1.5, 9.0, None),         # another kernel, not read
           _op("b", 2.0, 1.0, None),         # a whole call: a b b
           _op("a", 3.0, 2.0, None), _op("b", 5.0, 1.0, None),
           _op("a", 6.0, 4.0, None), _op("b", 10.0, 1.0, None),
           _op("b", 11.0, 1.0, None),        # a b b; the a b before it
           _op("a", 12.0, 1.0, None), _op("b", 13.0, 1.0, None)]  # cut
    assert kernel_calls(ops, "a", "b", 3) == (2, 9.0)
    assert kernel_calls(ops[::-1], "a", "b", 3) == (2, 9.0)
    assert kernel_calls(ops, "a") == (4, 8.0)
    assert kernel_calls(ops, "b") == (6, 6.0)
    assert kernel_calls([], "a") == (0, 0.0)


@pytest.mark.parametrize("family", ["open", "sat"])
def test_k2_reads_as_before_on_an_unshifted_summary(family):
    ctx = _ctx(_open())
    bound = attend_pair.bound_s(N, T, STAGE, PEAKS, 256)
    got = _read(f"attend_pair_roofline.{family}", ctx)
    assert got == pytest.approx(
        _ranged_share(ctx, "attend_pair_kernel", bound), rel=1e-12)
    assert got == pytest.approx(100.0 * bound / DA, rel=1e-12)
    shifted = _read(f"attend_pair_roofline.{family}",
                    _ctx(_open(shift=0.02)))
    assert shifted == pytest.approx(got, abs=1e-9)


def test_k5_reads_as_before_on_an_unshifted_summary():
    """Training: five steps' sequence-body launches, no host ranges (the
    cell profiles the device alone)."""
    steps, d = 5, 0.0052
    ops = []
    for k in range(steps):
        t = 0.06 * k
        ops += [_op("cudnn_conv", t, 0.012, "encoder"),
                _op("lstm_seq_kernel<16>", t + 0.0121, d, "encoder"),
                _op("gemm", t + 0.0175, 0.02, "trunk")]
    ctx = {"summary": {"ranges": {}, "ops": ops},
           "tick_names": ("vapbench.step", "vapbench.wait"),
           "n_traced": 4, "batch": 8, "lstm_steps": 1998, "model": MODEL,
           "peaks": PEAKS, "counters": {"lstm_scan.sequence_launches": 5}}
    bound = lstm_scan.bound_s(16, 1998, PEAKS, 256)
    got = _read("lstm_scan_roofline.train", ctx)
    assert got == pytest.approx(_ranged_share(ctx, "lstm_seq_kernel", bound),
                                rel=1e-12)
    assert got == pytest.approx(100.0 * bound / d, rel=1e-12)


@pytest.mark.parametrize("shift", [0.0, 3e-3, 0.02])
@pytest.mark.parametrize("layer,per_tick", [
    ("encoder", D0 + 4 * DL + 0.4e-3), ("trunk", 7 * DT)])
def test_layer_ms_read_the_ops_the_stretch_launched(layer, per_tick, shift):
    """The open loop: the same per tick wherever the device's clock puts
    the ops against the tick ranges."""
    got = _read(f"{layer}_ms.open", _ctx(_open(shift)))
    assert got == pytest.approx(1e3 * per_tick, rel=1e-12)


@pytest.mark.parametrize("layer,per_tick", [
    ("encoder", D0 + 4 * DL + 0.4e-3), ("trunk", 7 * DT)])
def test_layer_ms_of_a_closed_loop_divide_by_the_ticks_dispatched(
        layer, per_tick):
    """The closed loop dispatches 21 ticks in a stretch of 20 traced; the
    ops launched before the stretch are not read."""
    ctx = _ctx(_closed(), ("vapbench.dispatch", "vapbench.collect"))
    got = _read(f"{layer}_ms.sat", ctx)
    assert got == pytest.approx(1e3 * per_tick, rel=1e-12)


@pytest.mark.parametrize("name", [
    "conv_stack_fused_roofline.open", "attend_pair_roofline.sat",
    "lstm_scan_roofline.train", "encoder_ms.open", "trunk_ms.sat"])
def test_readers_find_nothing_to_read(name):
    empty = {"ranges": {"vapbench.tick": [(0.0, 1.0)]}, "ops": []}
    assert _read(name, _ctx(empty)) is None
    assert _read(name, _ctx(None)) is None
