"""Seeded, speech-like stereo audio, made in bulk on the device.

Each clip channel talks in spurts and pauses (exponential lengths with
the means the traffic file gives, a floor on each), on a voiced carrier:
six harmonics of a pitch that drifts slowly around a base drawn per
channel, plus breath noise, at a gain drawn per channel.  The on/off
track at 10 ms is also the clip's voice activity, from which the
training traffic takes its VAD labels.

One generator reads the parameters of every traffic file:

    "audio": {"clips": 128, "seconds": 32, "spurt_s": 1.2, "pause_s": 0.8,
              "min_s": 0.2, "gain_db": [-30, -6], "pitch_hz": [90, 260]}
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

SR = 16000
HOP = 160                      # 10 ms on/off resolution


def _on_off(rs: np.random.RandomState, n_tracks: int, n_hops: int,
            a: Dict) -> np.ndarray:
    """(n_tracks, n_hops) bool: alternating spurts and pauses, each at
    least `min_s`, starting in either state."""
    mean_on = a["spurt_s"] * SR / HOP
    mean_off = a["pause_s"] * SR / HOP
    floor = a["min_s"] * SR / HOP
    n_seg = int(2 * n_hops / (mean_on + mean_off)) + 16
    on = floor + rs.exponential(mean_on, (n_tracks, n_seg))
    off = floor + rs.exponential(mean_off, (n_tracks, n_seg))
    first_on = rs.rand(n_tracks) < 0.5
    lens = np.where(first_on[:, None],
                    np.stack([on, off], -1).reshape(n_tracks, -1),
                    np.stack([off, on], -1).reshape(n_tracks, -1))
    ends = np.cumsum(lens, axis=1)
    hops = np.arange(n_hops) + 0.5
    out = np.empty((n_tracks, n_hops), bool)
    for i in range(n_tracks):
        seg = np.searchsorted(ends[i], hops)
        out[i] = (seg % 2 == 0) == first_on[i]
    return out


def make_clips(a: Dict, n_clips: int, seconds: float, seed: int, device
               ) -> Tuple["torch.Tensor", np.ndarray]:
    """(clips (n_clips, 2, L) float32 in [-1, 1) on `device`, exactly
    representable as int16 / 32768; on/off (n_clips, 2, L // 160) bool)."""
    import torch

    n_hops = int(seconds * SR) // HOP
    L = n_hops * HOP
    rs = np.random.RandomState(seed % 2 ** 32)
    act = _on_off(rs, n_clips * 2, n_hops, a)
    lo, hi = a["pitch_hz"]
    f0 = torch.tensor(rs.uniform(lo, hi, (n_clips * 2, 1)),
                      dtype=torch.float64, device=device)
    ph = torch.tensor(rs.uniform(0, 2 * math.pi, (n_clips * 2, 1)),
                      dtype=torch.float64, device=device)
    g_lo, g_hi = a["gain_db"]
    gain = torch.tensor(10 ** (rs.uniform(g_lo, g_hi, (n_clips * 2, 1)) / 20),
                        dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(rs.randint(2 ** 31)))

    t = torch.arange(L, dtype=torch.float64, device=device)[None] / SR
    # pitch f0 (1 + 0.06 sin(2 pi 0.4 t + ph)): its phase in closed form
    vib = 0.06 / (2 * math.pi * 0.4)
    phase = 2 * math.pi * f0 * (t - vib * torch.cos(2 * math.pi * 0.4 * t
                                                    + ph))
    carrier = torch.zeros((n_clips * 2, L), dtype=torch.float32,
                          device=device)
    for h in range(1, 7):
        carrier += (torch.sin(h * phase) / h).float()
    carrier += 0.3 * torch.randn((n_clips * 2, L), generator=gen,
                                 device=device)
    env = torch.tensor(act, dtype=torch.float32, device=device)
    # 10 ms ramps between spurts and pauses, and a 2% floor of room noise
    env = torch.nn.functional.interpolate(env[:, None], size=L,
                                          mode="linear",
                                          align_corners=False)[:, 0]
    env = 0.02 + 0.98 * env
    x = carrier * env * gain / 2.2
    x = torch.clamp(torch.round(x * 32768.0), -32768, 32767) / 32768.0
    return (x.reshape(n_clips, 2, L).float(),
            act.reshape(n_clips, 2, n_hops))


class StreamAudio:
    """The serving traffic's audio: a pool of clips cut into frames of
    `frame` fresh samples, in host memory as int16, and each stream's
    clip and starting frame, drawn from the seed.  Stream i's frame at
    tick k is the pool's frame (clip_i, (start_i + k) mod n_frames)."""

    def __init__(self, a: Dict, streams: int, frame: int, seed: int,
                 device):
        import torch

        from vapbench.common import sub_seed

        clips, _ = make_clips(a, a["clips"], a["seconds"],
                              sub_seed(seed, 2), device)
        n_clips, _, L = clips.shape
        self.frame = frame
        self.n_frames = L // frame
        L = self.n_frames * frame
        pool = (clips[:, :, :L] * 32768.0).to(torch.int16)
        pool = pool.reshape(n_clips, 2, self.n_frames, frame)
        # (clip * n_frames + k, 2, frame): one frame of a stream, contiguous
        self.pool = pool.permute(0, 2, 1, 3).contiguous().reshape(
            n_clips * self.n_frames, 2, frame).cpu()
        rs = np.random.RandomState(sub_seed(seed, 3) % 2 ** 32)
        self.clip = rs.randint(0, n_clips, streams)
        self.start = rs.randint(0, self.n_frames, streams)
        self._base = torch.from_numpy(self.clip * self.n_frames)

    def rows(self, tick: int):
        """The pool rows of every stream's frame at `tick` ((N,) int64)."""
        import torch

        return self._base + torch.from_numpy(
            (self.start + tick) % self.n_frames)

    def fill(self, tick: int, out) -> None:
        """Every stream's frame at `tick` into `out` ((N, 2, frame) int16,
        pinned on a card)."""
        import torch

        torch.index_select(self.pool, 0, self.rows(tick), out=out)

    def history(self, stream: int, ticks: int) -> np.ndarray:
        """Stream `stream`'s audio over ticks 0..ticks-1 as int16
        (2, ticks * frame): what its frames carried, end to end."""
        k = (self.start[stream] + np.arange(ticks)) % self.n_frames
        rows = self.pool[self.clip[stream] * self.n_frames + k].numpy()
        return rows.transpose(1, 0, 2).reshape(2, -1)


def train_batches(a: Dict, n_batches: int, batch: int, seconds: float,
                  frame_hz: int, horizon_s: float, seed: int, device):
    """[{"waveform": (batch, 2, L) float32, "vad": (batch, Tv, 2) float32}]
    on `device`, Tv = (seconds + horizon_s) * frame_hz: each clip's voice
    activity at the model's frame rate (a frame is active when most of
    its 10 ms hops are), holding shifts, holds and backchannels as the
    spurts of the two channels overlap and alternate."""
    import torch

    L = int(seconds * SR)
    total = seconds + horizon_s
    clips, act = make_clips(a, n_batches * batch, total, seed, device)
    per = 100 // frame_hz                      # 10 ms hops per frame
    Tv = int(total * frame_hz)
    vad = act[:, :, :Tv * per].reshape(n_batches * batch, 2, Tv, per)
    vad = (vad.mean(-1) >= 0.5).astype(np.float32).transpose(0, 2, 1)
    vad = torch.from_numpy(np.ascontiguousarray(vad)).to(device)
    wav = clips[:, :, :L].contiguous()
    return [{"waveform": wav[i * batch:(i + 1) * batch],
             "vad": vad[i * batch:(i + 1) * batch]}
            for i in range(n_batches)]
