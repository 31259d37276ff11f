"""PyTorch port: the layer spans (`utils/spans.py`) of the serving tick
and the train step on the CPU: off by default at no cost, their nesting
and identifiers on, outputs unchanged by recording, the bounded store."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.vap import VapModel, init_vap_params
from vap_realtime_tpu_torch.parallel.worker import global_inputs
from vap_realtime_tpu_torch.runtime.arena import StreamArena
from vap_realtime_tpu_torch.runtime.incremental import STAGE_S
from vap_realtime_tpu_torch.train.trainer import (
    OptConfig, make_train_step, make_tx,
)
from vap_realtime_tpu_torch.utils import spans
from vap_realtime_tpu_torch.weights.convert import params_to_numpy

NARROW = dict(dim=64, encoder_dim=64, num_heads=4, frame_hz=20,
              context_len_sec=1.0)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    spans.enable(False)
    spans.take()
    yield
    spans.enable(False)
    spans.take()


def _arena(capacity=3):
    cfg = VapConfig(**NARROW)
    params = params_to_numpy(init_vap_params(
        torch.Generator().manual_seed(3), cfg))
    arena = StreamArena(cfg, params, capacity=capacity, path="fast",
                        wire_dtype=np.int16, device="cpu")
    arena.warmup()
    return arena


def _frames(arena, ticks, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(arena.capacity, 2, arena.chunk_samples) * 3000
             ).astype(np.int16) for _ in range(ticks)]


def _children(records, i):
    return [j for j, r in enumerate(records) if r.parent == i]


def test_off_span_is_one_shared_noop_and_records_nothing():
    assert not spans.enabled()
    assert spans.span("vap.tick") is spans.span("vap.merge", n=3, id=1)
    arena = _arena()
    slots = np.arange(arena.capacity)
    for f in _frames(arena, 2):
        arena.step_device_batch(f, slots)
    assert spans.take() == []


def test_fast_tick_spans_nest_share_the_tick_id_and_count_bytes():
    """A staged fast-path tick: vap.tick holds the two uploads, the
    encoder and the trunk; the encoder holds its conv stack, LSTM and
    downsample; the trunk holds the 7 attends, the heads, the
    probabilities and, on every STAGE_S-th tick alone, the merge."""
    arena = _arena()
    slots = np.arange(arena.capacity)
    frames = _frames(arena, 2 * STAGE_S)
    g0 = arena.state.kv.step
    spans.enable(True)
    for f in frames:
        arena.step_device_batch(f, slots)
    spans.enable(False)
    recs = spans.take()
    ticks = [i for i, r in enumerate(recs) if r.name == "vap.tick"]
    assert [recs[i].id for i in ticks] == list(range(g0, g0 + len(frames)))
    assert all(recs[i].parent == -1 for i in ticks)
    merged = []
    for i in ticks:
        tick = recs[i]
        kids = _children(recs, i)
        assert [recs[j].name for j in kids] == [
            "vap.upload", "vap.upload", "vap.encode", "vap.trunk"]
        assert [recs[j].n for j in kids[:2]] == [
            frames[0].nbytes, arena.capacity * np.dtype(bool).itemsize]
        assert [recs[j].name for j in _children(recs, kids[2])] == [
            "vap.encode.conv", "vap.encode.lstm", "vap.encode.down"]
        trunk = kids[-1]
        names = [recs[j].name for j in _children(recs, trunk)]
        assert names[:7] == ["vap.attend"] * 7
        assert names[-2:] == ["vap.heads", "vap.probs"]
        assert names[7:-2] in ([], ["vap.merge"])
        if names[7:-2]:
            merged.append(tick.id)
        inside = [r for r in recs if tick.start_ns <= r.start_ns
                  and r.end_ns <= tick.end_ns]
        assert len(inside) == 1 + 4 + 3 + len(names)
        assert all(r.id == tick.id for r in inside)
        assert all(recs[j].start_ns >= tick.start_ns
                   and recs[j].end_ns <= tick.end_ns for j in kids)
    assert merged == [g for g in range(g0, g0 + len(frames))
                      if (g + 1) % STAGE_S == 0]
    assert len(merged) == 2


def test_reset_span_counts_the_slots():
    arena = _arena(capacity=4)
    spans.enable(True)
    arena.reset_slots([0, 2, 2])
    recs = spans.take()
    assert [(r.name, r.n, r.parent) for r in recs] == [
        ("vap.reset", 2, -1), ("vap.upload", 4, 0)]
    assert recs[0].id == recs[1].id == arena.state.kv.step


def test_outputs_bit_equal_with_the_recorder_on_and_off():
    outs = []
    for on in (False, True):
        arena = _arena()
        slots = np.arange(arena.capacity)
        spans.enable(on)
        got = [{k: v.clone() for k, v in
                arena.step_device_batch(f, slots).items()}
               for f in _frames(arena, STAGE_S + 1, seed=5)]
        spans.enable(False)
        outs.append(got)
    assert spans.take()
    for a, b in zip(*outs):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_train_step_spans_in_order():
    """The step holds the optimizer's zero_grad, then forward (the
    encoder and the heads inside), loss, backward and the update, in
    that order, all with the step's index."""
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5, cross_layers=1)
    model = VapModel(cfg, init_vap_params(torch.Generator().manual_seed(0),
                                          cfg))
    step = make_train_step(make_tx(model, OptConfig()), cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in global_inputs(0, batch=2).items()}
    step(model, batch, None)
    spans.enable(True)
    m = step(model, batch, None)
    spans.enable(False)
    assert np.isfinite(float(m["loss"]))
    recs = spans.take()
    assert recs[0].name == "vap.train.step" and recs[0].id == 1
    assert all(r.id == 1 for r in recs)
    kids = _children(recs, 0)
    assert [recs[j].name for j in kids] == [
        "vap.optimizer", "vap.forward", "vap.loss", "vap.backward",
        "vap.optimizer"]
    assert all(recs[a].end_ns <= recs[b].start_ns
               for a, b in zip(kids, kids[1:]))
    fwd = [recs[j].name for j in _children(recs, kids[1])]
    assert fwd == ["vap.encode", "vap.heads"]


def test_store_keeps_the_newest_and_counts_drops(monkeypatch):
    monkeypatch.setattr(spans, "_rec", spans._Recorder(capacity=4))
    spans.enable(True)
    with spans.span("outer", id=9):
        for i in range(5):
            with spans.span("inner", n=i):
                pass
    spans.enable(False)
    assert spans.dropped() == 2
    recs = spans.take()
    assert spans.dropped() == 0
    # the outer span closed last, so it survives; two inner spans went
    assert [(r.name, r.n) for r in recs] == [
        ("outer", None), ("inner", 2), ("inner", 3), ("inner", 4)]
    assert [r.parent for r in recs] == [-1, 0, 0, 0]
    assert all(r.id == 9 for r in recs)


def test_self_times_subtract_children():
    recs = [spans.Span("a", 0, 10_000_000, -1, 0, None),
            spans.Span("b", 1_000_000, 4_000_000, 0, 0, 7),
            spans.Span("b", 5_000_000, 6_000_000, 0, 0, 1)]
    t = spans.self_times(recs)
    assert t["a"] == {"count": 1, "ms": 10.0, "self_ms": 6.0, "n": 0}
    assert t["b"] == {"count": 2, "ms": 4.0, "self_ms": 4.0, "n": 8}


def test_traced_keeps_the_function_and_records_on():
    @spans.traced("f")
    def f(x):
        """doc"""
        return x + 1

    assert f.__name__ == "f" and f.__doc__ == "doc" and f(1) == 2
    assert spans.take() == []
    spans.enable(True)
    assert f(2) == 3
    assert [r.name for r in spans.take()] == ["f"]
