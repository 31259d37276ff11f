"""WAV file IO via stdlib `wave` (no soundfile dependency).

Reads 8-, 16- and 32-bit PCM WAVs as float32 in [-1, 1], matching
``soundfile.read(dtype='float32')`` which the reference uses
(rvap/vap_main/vap_offline.py:42-43); writes 16-bit PCM.  The port's own
copy of `vap_realtime_tpu/io/audio.py`.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples (N,) or (N, C) float32, sample_rate)."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = (np.frombuffer(raw, dtype="<i4").astype(np.float32)
                / 2147483648.0)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch)
    return data, rate


def write_wav(path: str, data: np.ndarray, rate: int = 16000) -> None:
    """data: (N,) or (N, C) float in [-1, 1] -> 16-bit PCM."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    pcm = np.clip(data * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(data.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
