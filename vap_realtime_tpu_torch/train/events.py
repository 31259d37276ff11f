"""Turn-taking event extraction from VAD — numpy, host-side.

Behavioural contract from the reference (train/events.py): extract
hold / shift / long-onset / prediction regions and backchannel (+negative
sampling) regions from per-dialog VAD, with pre/post single-speaker
conditions, minimum-silence, minimum-context and max-frame gates, equal
hold/shift subsampling with cross-batch debt tracking (`add_extra`), and
0.5 s prediction regions.

Dialog-state encoding (events.py:71-79): 0 = only A, 1 = silence,
2 = both, 3 = only B.  Pause filling uses the [x, silence, x] triad
template (events.py:82-110).

Design note: this is irregular, data-dependent host logic that runs on
small (B, ~1000, 2) VAD arrays at validation time — numpy is the right
tool, NOT jit (ragged outputs, Python-side sampling state).

The port's own copy of `vap_realtime_tpu/train/events.py` (numpy only).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# dialog states
STATE_ONLY_A = 0
STATE_SILENCE = 1
STATE_BOTH = 2
STATE_ONLY_B = 3

# triad templates, one row per "next speaker" (events.py:9-12)
TRIAD_SHIFT = np.array([[3, 1, 0], [0, 1, 3]])
TRIAD_HOLD = np.array([[0, 1, 0], [3, 1, 3]])
TRIAD_BC = np.array([0, 1, 0])

Region = Tuple[int, int, int]  # (start, end, speaker)


@dataclass
class EventConfig:
    """Defaults from the reference EventConfig (events.py:21-45)."""

    min_context_time: float = 3.0
    metric_time: float = 0.2
    metric_pad_time: float = 0.05
    max_time: float = 20.0
    frame_hz: int = 50
    equal_hold_shift: bool = True
    prediction_region_time: float = 0.5

    sh_pre_cond_time: float = 1.0
    sh_post_cond_time: float = 1.0
    sh_prediction_region_on_active: bool = True

    bc_pre_cond_time: float = 1.0
    bc_post_cond_time: float = 1.0
    bc_max_duration: float = 1.0
    bc_negative_pad_left_time: float = 1.0
    bc_negative_pad_right_time: float = 2.0

    long_onset_region_time: float = 0.2
    long_onset_condition_time: float = 1.0


def time_to_frames(t: float, frame_hz: int) -> int:
    return int(t * frame_hz)


def get_dialog_states(vad: np.ndarray) -> np.ndarray:
    """(..., 2) VAD -> dialog state 0/1/2/3 (events.py:71-79)."""
    return (2 * vad[..., 1] - vad[..., 0]).astype(np.int64) + 1


def find_island_idx_len(x: np.ndarray):
    """Run-length encode a 1-D array -> (start_idx, durations, values)."""
    assert x.ndim == 1
    n = len(x)
    change = np.flatnonzero(x[1:] != x[:-1])
    ends = np.concatenate([change, [n - 1]])
    bounds = np.concatenate([[-1], ends])
    dur = bounds[1:] - bounds[:-1]
    starts = np.concatenate([[0], np.cumsum(dur)[:-1]])
    return starts, dur, x[ends]


def fill_pauses(vad: np.ndarray, ds: np.ndarray,
                islands=None) -> np.ndarray:
    """Fill [speaker, silence, same-speaker] pauses with activity
    (events.py:82-110)."""
    filled = vad.copy()
    if islands is None:
        s, d, v = find_island_idx_len(ds)
    else:
        s, d, v = islands
    if len(v) < 3:
        return filled
    triads = np.lib.stride_tricks.sliding_window_view(v, 3)
    for ns in (0, 1):
        hits = np.flatnonzero((triads == TRIAD_HOLD[ns]).sum(-1) == 3)
        for pre in hits:
            cur = pre + 1
            filled[s[cur]:s[cur] + d[cur], ns] = 1.0
    return filled


def _hs_regions_for_template(triads, filled_vad, template, start_of,
                             duration_of, *, pre_cond, post_cond,
                             pred_frames, pred_on_active, long_cond,
                             long_region, min_silence, min_context,
                             max_frame):
    """Hold or shift regions for one triad template (events.py:113-265).

    Returns (regions, prediction_regions, long_onset_regions)."""
    regions: List[Region] = []
    pred_regions: List[Region] = []
    long_regions: List[Region] = []

    is_hold = template[0, 0] == template[0, -1]
    for ns in (0, 1):
        steps = np.flatnonzero((triads == template[ns]).sum(-1) == 3)
        for last_onset in steps:
            silence = last_onset + 1
            next_onset = last_onset + 2
            prev = ns if is_hold else 1 - ns
            sil_start = start_of[silence]
            if sil_start < min_context or sil_start >= max_frame:
                continue
            if duration_of[silence] < min_silence:
                continue
            # pre condition: only `prev` active for pre_cond frames
            p0 = max(sil_start - pre_cond, 0)
            if filled_vad[p0:sil_start, prev].sum() != pre_cond:
                continue
            if filled_vad[p0:sil_start, 1 - prev].sum() != 0:
                continue
            # post condition: only `ns` active for post_cond frames
            on = start_of[next_onset]
            if filled_vad[on:on + post_cond, ns].sum() != post_cond:
                continue
            if filled_vad[on:on + post_cond, 1 - ns].sum() != 0:
                continue
            regions.append((int(sil_start), int(on), ns))

            if not is_hold and duration_of[next_onset] >= long_cond:
                long_regions.append((int(on), int(on + long_region), ns))

            if pred_on_active and duration_of[last_onset] < pred_frames:
                continue
            pred_start = sil_start - pred_frames
            if pred_start < min_context:
                continue
            pred_regions.append((int(pred_start), int(sil_start), ns))

    return regions, pred_regions, long_regions


def hold_shift_regions(vad, ds, *, pre_cond, post_cond, pred_frames,
                       pred_on_active, long_cond, long_region,
                       min_silence, min_context, max_frame):
    start_of, duration_of, states = find_island_idx_len(ds)
    filled = fill_pauses(vad, ds, islands=(start_of, duration_of, states))
    empty = {"shift": [], "hold": [], "long": [], "pred_shift": [],
             "pred_hold": []}
    if len(states) < 3:
        return empty
    triads = np.lib.stride_tricks.sliding_window_view(states, 3)
    kw = dict(pre_cond=pre_cond, post_cond=post_cond,
              pred_frames=pred_frames, pred_on_active=pred_on_active,
              long_cond=long_cond, long_region=long_region,
              min_silence=min_silence, min_context=min_context,
              max_frame=max_frame)
    shifts, pred_shifts, longs = _hs_regions_for_template(
        triads, filled, TRIAD_SHIFT, start_of, duration_of, **kw)
    holds, pred_holds, _ = _hs_regions_for_template(
        triads, filled, TRIAD_HOLD, start_of, duration_of, **kw)
    return {"shift": shifts, "hold": holds, "long": longs,
            "pred_shift": pred_shifts, "pred_hold": pred_holds}


def backchannel_regions(vad, ds, *, pre_cond, post_cond, pred_frames,
                        min_context, max_bc, max_frame):
    """Isolated short activity islands per speaker (events.py:337-413)."""
    filled = fill_pauses(vad, ds)
    bc: List[Region] = []
    pred_bc: List[Region] = []
    for speaker in (0, 1):
        start_of, duration_of, states = find_island_idx_len(
            filled[:, speaker])
        if len(states) < 3:
            continue
        triads = np.lib.stride_tricks.sliding_window_view(states, 3)
        for pre_sil in np.flatnonzero((triads == TRIAD_BC).sum(-1) == 3):
            seg = pre_sil + 1
            post_sil = pre_sil + 2
            if start_of[seg] < min_context or start_of[seg] >= max_frame:
                continue
            if duration_of[seg] > max_bc:
                continue
            if duration_of[pre_sil] < pre_cond:
                continue
            if duration_of[post_sil] < post_cond:
                continue
            bc.append((int(start_of[seg]), int(start_of[post_sil]), speaker))
            pred_start = start_of[seg] - pred_frames
            if pred_start < min_context:
                continue
            pred_bc.append((int(pred_start), int(start_of[seg]), speaker))
    return {"backchannel": bc, "pred_backchannel": pred_bc}


def negative_sample_regions(vad, ds, *, pad_left, pad_right, min_region,
                            min_context, max_frame):
    """Long single-speaker stretches usable as negatives
    (events.py:416-479)."""
    filled = fill_pauses(vad, ds)
    ds_fill = get_dialog_states(filled)
    index_of, duration_of, state_of = find_island_idx_len(ds_fill)
    out: List[Region] = []
    for cur, cur_state in enumerate([STATE_ONLY_A, STATE_ONLY_B]):
        nxt = 1 - cur
        sel = state_of == cur_state
        for i, d in zip(index_of[sel], duration_of[sel]):
            if d < pad_left + pad_right:
                continue
            start = max(int(i + pad_left), min_context)
            end = min(int(i + d - pad_right), max_frame)
            if end - start < min_region:
                continue
            out.append((start, end, nxt))
    return out


class TurnTakingEvents:
    """Batch-level event extractor with equal-subsampling debt tracking
    (events.py:709-838)."""

    def __init__(self, conf: Optional[EventConfig] = None,
                 rng: Optional[random.Random] = None):
        self.conf = conf or EventConfig()
        self.rng = rng or random.Random(0)
        self.add_extra = {"shift": 0, "pred_shift": 0,
                          "pred_backchannel": 0}
        c = self.conf
        hz = c.frame_hz
        self.min_silence = time_to_frames(
            c.metric_time + c.metric_pad_time, hz)
        self.hs_kw = dict(
            pre_cond=time_to_frames(c.sh_pre_cond_time, hz),
            post_cond=time_to_frames(c.sh_post_cond_time, hz),
            pred_frames=time_to_frames(c.prediction_region_time, hz),
            pred_on_active=c.sh_prediction_region_on_active,
            long_cond=time_to_frames(c.long_onset_condition_time, hz),
            long_region=time_to_frames(c.long_onset_region_time, hz),
            min_silence=self.min_silence,
            min_context=time_to_frames(c.min_context_time, hz),
        )
        self.bc_kw = dict(
            pre_cond=time_to_frames(c.bc_pre_cond_time, hz),
            post_cond=time_to_frames(c.bc_post_cond_time, hz),
            pred_frames=time_to_frames(c.prediction_region_time, hz),
            min_context=time_to_frames(c.min_context_time, hz),
            max_bc=time_to_frames(c.bc_max_duration, hz),
        )
        self.neg_kw = dict(
            pad_left=time_to_frames(c.bc_negative_pad_left_time, hz),
            pad_right=time_to_frames(c.bc_negative_pad_right_time, hz),
            min_region=time_to_frames(c.prediction_region_time, hz),
            min_context=time_to_frames(c.min_context_time, hz),
        )

    def _sample_equal(self, n: int, b_set: List[List[Region]],
                      event_type: str, is_backchannel: bool = False):
        """Random subset of size n (+- cross-batch debt; events.py:759-796)."""
        batch_size = len(b_set)
        subset: List[List[Region]] = [[] for _ in range(batch_size)]
        flat: List[Region] = []
        b_idx: List[int] = []
        for b in range(batch_size):
            flat += b_set[b]
            b_idx += [b] * len(b_set[b])
        n_max = len(flat)
        if n_max < n:
            self.add_extra[event_type] += n - n_max
            n = n_max
        else:
            extra = min(n_max - n, self.add_extra[event_type])
            n += extra
            self.add_extra[event_type] -= extra
        for idx in self.rng.sample(range(n_max), k=n):
            entry = flat[idx]
            if is_backchannel:
                # sample a prediction-sized sub-segment
                s, e, spk = entry
                pf = self.bc_kw["pred_frames"]
                start = self.rng.randint(s, e - pf)
                entry = (start, start + pf, spk)
            subset[b_idx[idx]].append(entry)
        return subset

    def __call__(self, vad: np.ndarray,
                 max_time: Optional[float] = None
                 ) -> Dict[str, List[List[Region]]]:
        """vad: (B, N, 2) -> dict of per-batch region lists with keys
        shift/hold/long/short/pred_shift/pred_shift_neg/
        pred_backchannel/pred_backchannel_neg."""
        vad = np.asarray(vad)
        assert vad.ndim == 3, f"expected (B, N, 2), got {vad.shape}"
        max_frame = time_to_frames(
            self.conf.max_time if max_time is None else max_time,
            self.conf.frame_hz)
        ds = get_dialog_states(vad)

        ret: Dict[str, List[List[Region]]] = {
            k: [] for k in ("shift", "hold", "long", "pred_shift",
                            "pred_hold", "backchannel", "pred_backchannel",
                            "pred_backchannel_neg")}
        for b in range(vad.shape[0]):
            hs = hold_shift_regions(vad[b], ds[b], max_frame=max_frame,
                                    **self.hs_kw)
            bc = backchannel_regions(vad[b], ds[b], max_frame=max_frame,
                                     **self.bc_kw)
            neg = negative_sample_regions(vad[b], ds[b],
                                          max_frame=max_frame,
                                          **self.neg_kw)
            for k in ("shift", "hold", "long", "pred_shift", "pred_hold"):
                ret[k].append(hs[k])
            ret["backchannel"].append(bc["backchannel"])
            ret["pred_backchannel"].append(bc["pred_backchannel"])
            ret["pred_backchannel_neg"].append(neg)

        n_pred_shift = sum(len(x) for x in ret["pred_shift"])
        ret["pred_shift_neg"] = self._sample_equal(
            n_pred_shift, ret.pop("pred_hold"), "pred_shift")
        # NOTE: the reference sizes bc-negatives by len(pred_shift), not
        # len(pred_backchannel) (events.py:823) — behavior preserved.
        ret["pred_backchannel_neg"] = self._sample_equal(
            n_pred_shift, ret["pred_backchannel_neg"],
            "pred_backchannel", is_backchannel=True)
        if self.conf.equal_hold_shift:
            n_shift = sum(len(x) for x in ret["shift"])
            ret["hold"] = self._sample_equal(n_shift, ret["hold"], "shift")
        ret["short"] = ret.pop("backchannel")
        return ret
