"""Training data pipeline — CSV manifest -> batched (waveform, vad) arrays.

Data contract from the reference (train/dataset.py, train/datamodule.py,
train/README.md:26-59):
- CSV rows: `audio_path,start,end,vad_list,session,dataset`; `vad_list`
  is JSON `[[ch0 [start,end] pairs], [ch1 pairs]]` in seconds, covering
  `horizon` (2 s) beyond the audio window.
- audio: stereo 16 kHz segments of `end - start` (typically 20 s)
- vad: onehot at frame_hz over duration + horizon
  (train/utils.py:170-196 `vad_list_to_onehot`).

The loader is a plain-numpy prefetching iterator that yields fixed-shape
batches (pad/trim to the nominal duration); the trainer moves each batch
(or, across processes, the rank's slice of it) to the device.  The
port's own copy of `vap_realtime_tpu/train/data.py`: the same rows, the
same epoch-seeded shuffles and flips, so both packages' loaders give the
same batches.
"""

from __future__ import annotations

import json
import math
import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from vap_realtime_tpu_torch.io.audio import read_wav


@dataclass
class DataConfig:
    """Reference DataConfig defaults (train/train.py:67-104)."""

    train_path: Optional[str] = None
    val_path: Optional[str] = None
    test_path: Optional[str] = None
    flip_channels: bool = True
    flip_probability: float = 0.5
    mask_vad: bool = False
    mask_vad_probability: float = 0.4
    batch_size: int = 8
    audio_duration: float = 20.0
    sample_rate: int = 16000
    frame_hz: int = 50
    horizon: float = 2.0


def time_to_frames(t: float, hop_time: float) -> int:
    return int(t / hop_time)


def vad_list_to_onehot(vad_list: List[List[List[float]]], duration: float,
                       frame_hz: int) -> np.ndarray:
    """JSON vad_list (seconds) -> (n_frames, 2) onehot
    (train/utils.py:170-196)."""
    hop = 1.0 / frame_hz
    n = time_to_frames(duration, hop)
    out = np.zeros((n, 2), np.float32)
    for ch, segs in enumerate(vad_list[:2]):
        for seg in segs:
            s = time_to_frames(seg[0], hop)
            e = time_to_frames(seg[1], hop)
            out[s:e, ch] = 1.0
    return out


def load_manifest(path: str) -> List[Dict]:
    """CSV manifest -> list of row dicts with parsed vad_list."""
    import csv

    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            row["start"] = float(row["start"])
            row["end"] = float(row["end"])
            row["vad_list"] = json.loads(row["vad_list"])
            rows.append(row)
    return rows


def load_sample(row: Dict, cfg: DataConfig) -> Dict[str, np.ndarray]:
    """One manifest row -> fixed-shape waveform (2, L) + vad (Tv, 2)."""
    dur = round(row["end"] - row["start"])
    wav, sr = read_wav(row["audio_path"])
    if sr != cfg.sample_rate:
        raise ValueError(f"{row['audio_path']}: {sr} != {cfg.sample_rate}")
    s = int(row["start"] * sr)
    e = int(row["end"] * sr)
    seg = wav[s:e]
    if seg.ndim == 1:  # mono -> duplicate-free: channel 2 silent
        seg = np.stack([seg, np.zeros_like(seg)], axis=-1)
    seg = seg.T.astype(np.float32)  # (2, L)

    L = int(cfg.audio_duration * cfg.sample_rate)
    if seg.shape[1] < L:
        seg = np.pad(seg, ((0, 0), (0, L - seg.shape[1])))
    seg = seg[:, :L]

    vad = vad_list_to_onehot(row["vad_list"], dur + cfg.horizon,
                             cfg.frame_hz)
    Tv = int((cfg.audio_duration + cfg.horizon) * cfg.frame_hz)
    if vad.shape[0] < Tv:
        vad = np.pad(vad, ((0, Tv - vad.shape[0]), (0, 0)))
    return {"waveform": seg, "vad": vad[:Tv]}


def flip_channels(batch: Dict[str, np.ndarray], mask: np.ndarray
                  ) -> Dict[str, np.ndarray]:
    """Symmetric-speakers augmentation: flip waveform + VAD channels for
    the masked batch entries (train/callbacks.py:33-79)."""
    wav = batch["waveform"].copy()
    vad = batch["vad"].copy()
    wav[mask] = wav[mask][:, ::-1]
    vad[mask] = vad[mask][:, :, ::-1]
    return {"waveform": wav, "vad": vad}


class VapDataLoader:
    """Shuffling, prefetching batch iterator over a CSV manifest.

    Drops the last partial batch (fixed shapes).  A background
    thread overlaps WAV decode with device compute.
    """

    def __init__(self, path: str, cfg: DataConfig, shuffle: bool = True,
                 train: bool = True, seed: int = 0, prefetch: int = 2):
        self.rows = load_manifest(path)
        self.cfg = cfg
        self.shuffle = shuffle
        self.train = train
        self.seed = seed
        self._epoch = 0
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch index that seeds the next iteration's shuffle
        order and flip masks.  Epoch-indexed seeding (instead of one
        RandomState advanced across epochs) makes any epoch reproducible
        in isolation — required for exact training resume."""
        self._epoch = epoch

    def _epoch_rng(self) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 100003 + self._epoch) % (2 ** 31 - 1))

    def __len__(self) -> int:
        return len(self.rows) // self.cfg.batch_size

    def _make_batch(self, rows: List[Dict],
                    rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        samples = [load_sample(r, self.cfg) for r in rows]
        batch = {
            "waveform": np.stack([s["waveform"] for s in samples]),
            "vad": np.stack([s["vad"] for s in samples]),
        }
        if self.train and self.cfg.flip_channels:
            mask = rng.rand(len(rows)) < self.cfg.flip_probability
            batch = flip_channels(batch, mask)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = self._epoch_rng()
        self._epoch += 1  # standalone use: next iteration = next epoch
        order = np.arange(len(self.rows))
        if self.shuffle:
            rng.shuffle(order)
        bs = self.cfg.batch_size
        n_batches = len(self)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)

        def producer():
            for i in range(n_batches):
                rows = [self.rows[j] for j in order[i * bs:(i + 1) * bs]]
                q.put(self._make_batch(rows, rng))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item


def synthetic_manifest(tmpdir: str, n_rows: int = 8,
                       duration: float = 5.0, seed: int = 0) -> str:
    """Build a tiny on-disk dataset (WAV + CSV) for tests/smoke training."""
    import csv
    import os

    from vap_realtime_tpu_torch.io.audio import write_wav
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    rs = np.random.RandomState(seed)
    path = os.path.join(tmpdir, "manifest.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["audio_path", "start", "end", "vad_list", "session",
                    "dataset"])
        for i in range(n_rows):
            wav_path = os.path.join(tmpdir, f"d{i}.wav")
            audio = synthetic_audio(int(duration * 16000), seed=seed + i)
            write_wav(wav_path, audio.T, 16000)
            vad_list = [[], []]
            for ch in range(2):
                t = 0.0
                while t < duration + 1.5:
                    on = float(rs.uniform(0.2, 1.5))
                    off = float(rs.uniform(0.2, 1.0))
                    vad_list[ch].append([round(t, 2), round(t + on, 2)])
                    t += on + off
            w.writerow([wav_path, 0.0, duration, json.dumps(vad_list),
                        f"s{i}", "synthetic"])
    return path
