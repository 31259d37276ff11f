"""The plain reference against the port's CPU path at a small size, in
float32, over more ticks than the ring holds (so the ring wraps and the
staged merge runs), in both serving modes; and the training reference
against the port's train step (dropout on) for the checked steps."""

import copy

import pytest

from vapbench.tests.helpers import run_small, small_context, small_workload


@pytest.mark.parametrize("cell,cfg_name", [
    ("vap20-fast-open", "vap_jp_20hz_2500ms"),
    ("nod20-fast-open", "nod_erica_20hz_10000ms"),
])
def test_serving_reference_matches_the_port_in_float32(cell, cfg_name):
    cfg = small_context(cfg_name, 0.5)                  # T = 10 rows
    cfg["serving"]["dtype"] = "float32"
    wl = small_workload(cell)
    wl["check"]["limits"]["max_gap"] = 2e-5
    line = run_small(cell, 2 ** 40 + 3, 1.6, workload=wl, config=cfg,
                     streams=4)
    chk = line["info"]["check"]
    assert chk["first_tick"] == 10 and chk["compared"] == 4 * 22
    assert line["correct"], chk
    assert chk["max_gap"] < 2e-5


def test_training_reference_matches_the_port():
    wl = copy.deepcopy(small_workload("vap20-train-b8x20s"))
    wl["check"]["limits"] = {"loss_gap": 1e-5, "grad_gap": 1e-4,
                             "change_gap": 1e-3, "frozen_changed": 0}
    line = run_small("vap20-train-b8x20s", 2 ** 41 + 7, 0.1, workload=wl,
                     batch=1, clip_seconds=2.0)
    assert line["correct"], line["limits"]
    assert line["info"]["check"]["frozen_changed"] == 0
