"""A run whose timed path is broken underneath reads `correct` false,
and so does the control (the reference in float8 in the program's
place), with the limits the workload files hold; a sound run at the same
small size reads true.  Everything of a run but the look for a card runs
(`execute` on the CPU): the cell's driver, its window, its check.

Serving faults: a step that returns its state unchanged; half of the
batch left out (its answers the mean of the other half's); one answer
altered where it is produced.  Training faults: a step that leaves the
weights as they were; a step on half of the batch (its loss the mean
over the rest).  One chip, so no exchange between chips to leave out."""

import copy

import pytest
import torch

from vapbench.tests.helpers import run_small

SEED = 2 ** 35 + 99


def unchanged_state(sv):
    arena = sv.arena
    orig = arena.step_tensors

    def step(x, act, *a, **kw):
        saved = copy.deepcopy(arena.state)
        out = orig(x, act, *a, **kw)
        arena.state = saved
        return out
    arena.step_tensors = step


def half_batch(sv):
    arena = sv.arena
    orig = arena.step_tensors
    h = sv.N // 2

    def step(x, act, *a, **kw):
        act = act.clone()
        act[h:] = False
        out = orig(x, act, *a, **kw)
        for v in out.values():
            v[h:] = v[:h].float().mean(0).to(v.dtype)
        return out
    arena.step_tensors = step


def altered_answer(sv):
    arena = sv.arena
    orig = arena.step_tensors
    ticks = [0]
    stream = int(sv.sample[0])
    field = sv.fields[0]

    def step(x, act, *a, **kw):
        out = orig(x, act, *a, **kw)
        if bool(act.any()):
            ticks[0] += 1
            if ticks[0] == sv.T + 3:
                out[field][stream] = out[field][stream] + 0.25
        return out
    arena.step_tensors = step


# the open loop runs 20 ticks a second whatever the CPU's speed; the
# closed loop as many as it can, so it is held to 60, past the ring's 50
SERVING_CELLS = {"vap20-fast-open": {}, "vap20-fast-sat": {"min_ticks": 60}}


def _wrapped(line):
    chk = line["info"]["check"]
    assert chk["first_tick"] == 50 and chk["compared"] > 0, chk


@pytest.mark.parametrize("cell", sorted(SERVING_CELLS))
def test_sound_serving_run_is_correct(cell):
    line = run_small(cell, SEED, 3.0, streams=8, **SERVING_CELLS[cell])
    _wrapped(line)
    assert line["correct"], line["limits"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_answer])
@pytest.mark.parametrize("cell", sorted(SERVING_CELLS))
def test_serving_fault_reads_incorrect(cell, fault):
    line = run_small(cell, SEED, 3.0, streams=8, fault=fault,
                     **SERVING_CELLS[cell])
    _wrapped(line)
    assert not line["correct"], line["limits"]


def test_serving_control_reads_incorrect():
    line = run_small("vap20-fast-open", SEED, 3.0, streams=8,
                     control="fp8")
    assert not line["correct"], line["limits"]


def weights_unchanged(step, net):
    def f(model, batch, gen):
        saved = {n: p.detach().clone() for n, p in net.leaves.items()}
        m = step(model, batch, gen)
        with torch.no_grad():
            for n, p in net.leaves.items():
                p.copy_(saved[n])
        return m
    return f


def half_of_the_batch(step, net):
    def f(model, batch, gen):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step(model, half, gen)
    return f


TRAIN = dict(batch=2, clip_seconds=2.0)


def test_sound_training_run_is_correct():
    line = run_small("vap20-train-b8x20s", SEED, 0.1, **TRAIN)
    assert line["correct"], line["limits"]


@pytest.mark.parametrize("fault", [weights_unchanged, half_of_the_batch])
def test_training_fault_reads_incorrect(fault):
    line = run_small("vap20-train-b8x20s", SEED, 0.1, fault=fault, **TRAIN)
    assert not line["correct"], line["limits"]


@pytest.mark.chip
def test_training_control_reads_incorrect_on_the_card(cuda):
    """TF32 on (the control of a float32 configuration) at the cell's own
    batch, on the card."""
    from vapbench.run import execute
    import time

    line = execute("vap20-train-b8x20s", SEED, 0.5, False, cuda,
                   t_proc=time.time(), control="tf32")
    assert not line["correct"], line["limits"]


@pytest.mark.chip
def test_serving_control_reads_incorrect_on_the_card(cuda):
    from vapbench.run import execute
    import time

    line = execute("vap20-fast-open", SEED, 3.0, False, cuda,
                   t_proc=time.time(), control="fp8", streams=1024)
    assert not line["correct"], line["limits"]
