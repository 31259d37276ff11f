"""The port's copies of the turn-taking events and metrics: the events
against the reference's golden (`tests/golden/events.npz`), and both
modules against the JAX package's on the same inputs."""

import numpy as np
import pytest

from tests.conftest import load_golden_stream
from vap_realtime_tpu.train import events as jev
from vap_realtime_tpu.train import metrics as jmet
from vap_realtime_tpu_torch.train import events as tev
from vap_realtime_tpu_torch.train import metrics as tmet


def test_events_golden_parity():
    golden = load_golden_stream("events.npz")
    out = tev.TurnTakingEvents(tev.EventConfig(equal_hold_shift=False))(
        golden["vad"])
    for key in ("shift", "hold", "long", "pred_shift", "short"):
        for b in range(golden["vad"].shape[0]):
            got = np.array(sorted(out[key][b]), np.int64).reshape(-1, 3)
            np.testing.assert_array_equal(got, golden[f"{key}_{b}"],
                                          err_msg=f"{key}[{b}]")
    for key in ("pred_shift_neg", "pred_backchannel_neg",
                "pred_backchannel"):
        assert (sum(len(x) for x in out[key])
                == golden[f"n_{key}"].sum()), key


@pytest.mark.parametrize("equal_hold_shift", [False, True])
def test_events_equal_jax(equal_hold_shift):
    """Every event list, the sampled ones included (same seeded sampler,
    same debt carried over two batches)."""
    golden = load_golden_stream("events.npz")
    conf = dict(equal_hold_shift=equal_hold_shift)
    tv = tev.TurnTakingEvents(tev.EventConfig(**conf))
    jv = jev.TurnTakingEvents(jev.EventConfig(**conf))
    for vad in (golden["vad"], golden["vad"][::-1, :, ::-1]):
        assert tv(vad) == jv(vad)
    assert tv.add_extra == jv.add_extra


def test_island_states_and_fill_equal_jax():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 3, size=200)
    for a, b in zip(tev.find_island_idx_len(x), jev.find_island_idx_len(x)):
        np.testing.assert_array_equal(a, b)
    vad = (rs.rand(300, 2) > 0.6).astype(np.float32)
    ds = tev.get_dialog_states(vad)
    np.testing.assert_array_equal(ds, jev.get_dialog_states(vad))
    np.testing.assert_array_equal(tev.fill_pauses(vad, ds),
                                  jev.fill_pauses(vad, ds))


def test_metrics_equal_jax():
    golden = load_golden_stream("events.npz")
    events = jev.TurnTakingEvents(jev.EventConfig(min_context_time=1.0))(
        golden["vad"])
    rs = np.random.RandomState(1)
    p_now = rs.rand(4, 1000, 2)
    p_fut = rs.rand(4, 1000, 2)
    tp, tt = tmet.extract_prediction_and_targets(p_now, p_fut, events)
    jp, jt = jmet.extract_prediction_and_targets(p_now, p_fut, events)
    assert tp.keys() == jp.keys()
    for k in tp:
        if jp[k] is None:
            assert tp[k] is None
            continue
        np.testing.assert_array_equal(tp[k], jp[k])
        np.testing.assert_array_equal(tt[k], jt[k])
    got, want = tmet.event_metrics(tp, tt), jmet.event_metrics(jp, jt)
    assert got == want and "hs2_balanced_accuracy" in got
    preds = np.array([0.9, 0.8, 0.2, 0.4, 0.6, 0.1])
    targets = np.array([1, 1, 1, 0, 0, 0])
    assert (tmet.binary_metrics(preds, targets)
            == jmet.binary_metrics(preds, targets))
    assert (tmet.f1_weighted(preds, targets)
            == jmet.f1_weighted(preds, targets))
