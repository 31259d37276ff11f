"""Event-region prediction extraction + turn-taking metrics.

Mirrors the reference's evaluation contract:
- `extract_prediction_and_targets` maps hold/shift/backchannel/long-short
  event regions to flat prediction/target vectors, including the "ver2"
  per-region-mean variants (rvap/vap_main/objective.py:312-468).
- test-time metrics: accuracy/F1 per event type + hs2 confusion matrix ->
  balanced accuracy / precision / recall / F1 (train/train.py:368-581).

All numpy/host-side (ragged regions).

The port's own copy of `vap_realtime_tpu/train/metrics.py` (numpy only).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

Region = Tuple[int, int, int]


def extract_prediction_and_targets(
    p_now: np.ndarray, p_fut: np.ndarray,
    events: Dict[str, List[List[Region]]],
) -> Tuple[Dict[str, Optional[np.ndarray]], Dict[str, Optional[np.ndarray]]]:
    """p_now/p_fut: (B, T, 2).  Returns (preds, targets) dicts with keys
    hs, hs2, pred_shift, pred_shift2, pred_backchannel, pred_backchannel2,
    ls — Holds=0 / Shifts=1 convention (objective.py:325-341)."""
    keys = ("hs", "hs2", "pred_shift", "pred_shift2", "pred_backchannel",
            "pred_backchannel2", "ls")
    preds: Dict[str, list] = {k: [] for k in keys}
    targets: Dict[str, list] = {k: [] for k in keys}
    B = len(events["hold"])

    def add(key, vals, label):
        preds[key].append(np.atleast_1d(vals))
        targets[key].append(np.full(np.atleast_1d(vals).shape, label,
                                    np.int64))

    for b in range(B):
        for s, e, spk in events["shift"][b]:
            v = p_now[b, s:e, spk]
            add("hs", v, 1)
            add("hs2", v.mean(), 1)
        for s, e, spk in events["hold"][b]:
            v = 1.0 - p_now[b, s:e, spk]
            add("hs", v, 0)
            add("hs2", v.mean(), 0)
        for s, e, spk in events["pred_shift"][b]:
            v = p_fut[b, s:e, spk]
            add("pred_shift", v, 1)
            add("pred_shift2", v.mean(), 1)
        for s, e, spk in events["pred_shift_neg"][b]:
            v = 1.0 - p_fut[b, s:e, spk]
            add("pred_shift", v, 0)
            add("pred_shift2", v.mean(), 0)
        for s, e, spk in events["pred_backchannel"][b]:
            v = p_now[b, s:e, spk]
            add("pred_backchannel", v, 1)
            add("pred_backchannel2", v.mean(), 1)
        for s, e, spk in events["pred_backchannel_neg"][b]:
            v = p_now[b, s:e, spk]  # low prob expected; labels 0
            add("pred_backchannel", v, 0)
            add("pred_backchannel2", v.mean(), 0)
        for s, e, spk in events["long"][b]:
            add("ls", p_fut[b, s:e, spk], 1)
        for s, e, spk in events["short"][b]:
            add("ls", p_fut[b, s:e, spk], 0)

    out_p: Dict[str, Optional[np.ndarray]] = {}
    out_t: Dict[str, Optional[np.ndarray]] = {}
    for k in keys:
        if preds[k]:
            out_p[k] = np.concatenate(preds[k]).astype(np.float64)
            out_t[k] = np.concatenate(targets[k])
        else:
            out_p[k] = None
            out_t[k] = None
    return out_p, out_t


def confusion(preds: np.ndarray, targets: np.ndarray,
              threshold: float = 0.5) -> np.ndarray:
    """2x2 confusion matrix m[target, pred] (train.py:496-533 hs2 path)."""
    hard = (preds >= threshold).astype(np.int64)
    m = np.zeros((2, 2), np.int64)
    for t, p in ((0, 0), (0, 1), (1, 0), (1, 1)):
        m[t, p] = int(((targets == t) & (hard == p)).sum())
    return m


def binary_metrics(preds: np.ndarray, targets: np.ndarray,
                   threshold: float = 0.5) -> Dict[str, float]:
    """accuracy, balanced accuracy, precision, recall, F1 for class 1
    (train/train.py:534-581 manual confusion-matrix path)."""
    m = confusion(preds, targets, threshold)
    tn, fp, fn, tp = m[0, 0], m[0, 1], m[1, 0], m[1, 1]
    total = tn + fp + fn + tp

    def safe(a, b):
        return float(a) / float(b) if b > 0 else 0.0

    recall0 = safe(tn, tn + fp)
    recall1 = safe(tp, tp + fn)
    precision = safe(tp, tp + fp)
    f1 = (2 * precision * recall1 / (precision + recall1)
          if precision + recall1 > 0 else 0.0)
    return {
        "accuracy": safe(tp + tn, total),
        "balanced_accuracy": 0.5 * (recall0 + recall1),
        "precision": precision,
        "recall": recall1,
        "f1": f1,
        "support": int(total),
    }


def f1_weighted(preds: np.ndarray, targets: np.ndarray,
                threshold: float = 0.5) -> float:
    """Support-weighted mean of per-class F1 (torchmetrics
    F1Score(average="weighted") used at train.py:376-450)."""
    m = confusion(preds, targets, threshold)
    tn, fp, fn, tp = m[0, 0], m[0, 1], m[1, 0], m[1, 1]

    def f1_of(tp_, fp_, fn_):
        denom = 2 * tp_ + fp_ + fn_
        return 2 * tp_ / denom if denom > 0 else 0.0

    f1_1 = f1_of(tp, fp, fn)
    f1_0 = f1_of(tn, fn, fp)
    n0, n1 = tn + fp, fn + tp
    total = n0 + n1
    return float((n0 * f1_0 + n1 * f1_1) / total) if total else 0.0


def event_metrics(preds: Dict[str, Optional[np.ndarray]],
                  targets: Dict[str, Optional[np.ndarray]]
                  ) -> Dict[str, float]:
    """Flat metric dict over all event types, reference naming
    (score.csv columns; train/README.md:110-135)."""
    out: Dict[str, float] = {}
    for key, p in preds.items():
        t = targets.get(key)
        if p is None or t is None or len(p) == 0:
            continue
        out[f"{key}_accuracy"] = binary_metrics(p, t)["accuracy"]
        out[f"{key}_f1"] = f1_weighted(p, t)
        if key == "hs2":
            bm = binary_metrics(p, t)
            out["hs2_balanced_accuracy"] = bm["balanced_accuracy"]
            out["hs2_precision"] = bm["precision"]
            out["hs2_recall"] = bm["recall"]
            out["hs2_f1_shift"] = bm["f1"]
    return out
