"""Model / runtime configuration.

Mirrors the behavioural contract of the reference `VapConfig`
(reference: rvap/vap_main/vap_main.py:35-85) — same defaults, same
frame-rate arithmetic (reference: rvap/vap_main/vap_main.py:224-230 and
SURVEY.md Appendix B) — but expressed as a frozen dataclass.

The port's own copy of `vap_realtime_tpu/config.py`: the PyTorch package
imports nothing of the JAX package, so the two stay independent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

BIN_TIMES: Tuple[float, ...] = (0.2, 0.4, 0.6, 0.8)

SAMPLE_RATE = 16000
# Reference streams audio in 160-sample (10 ms) hops
# (reference: rvap/vap_main/vap_main.py:356, input/wav.py).
HOP_SAMPLES = 160
# 320-sample left-context overlap prepended to every model frame
# (reference: rvap/vap_main/vap_main.py:224 `frame_contxt_padding`).
FRAME_CONTEXT_PADDING = 320
# CPC conv stack total downsampling factor (reference: encoder_components.py:93).
CPC_DOWNSAMPLE = 160


@dataclass(frozen=True)
class VapConfig:
    """Static model configuration.

    Defaults match the reference `VapConfig` (rvap/vap_main/vap_main.py:35-64):
    dim 256, 1 channel layer, 3 cross layers, 4 heads, dropout 0.1.

    `frame_hz` here is the *operating* frame rate (the reference passes it
    separately as `--vap_process_rate`); it controls the downsample conv
    kernel (= 100 // frame_hz, reference: train/encoder.py:33-34) and all
    frame-size arithmetic.
    """

    sample_rate: int = SAMPLE_RATE
    frame_hz: int = 20
    bin_times: Tuple[float, ...] = BIN_TIMES

    # Encoder
    encoder_dim: int = 256
    freeze_encoder: bool = True

    # Transformer trunk
    dim: int = 256
    channel_layers: int = 1
    cross_layers: int = 3
    num_heads: int = 4
    dff_k: int = 3
    dropout: float = 0.1
    context_limit: int = -1  # optional attention band mask (modules.py:196-200)
    # train-time truncated-context CPC mode: each frame's embedding is
    # recomputed from only the trailing N seconds of audio
    # (reference train/encoder.py:119-247); <= 0 disables.
    context_limit_cpc_sec: float = -1.0

    # Streaming
    context_len_sec: float = 2.5

    # Head variant: "vap" | "bc" | "nod"
    mode: str = "vap"

    # Language-ID multi-task head (reference train/model.py:66-69,149-156):
    # 0 = off, 1 = classify from the combined last layer, 2 = from the
    # concatenated channel streams ("middle").
    lid_classify: int = 0
    lid_classify_num_class: int = 3

    # Where va_classifier taps the trunk.  The reference is inconsistent:
    # realtime uses the channel-GPT outputs o1/o2 (vap_main.py:292-293),
    # training uses the post-stereo tower streams x1/x2
    # (train/model.py:305-308).  "channel" reproduces realtime behaviour.
    vad_tap: str = "channel"  # "channel" | "stereo"

    # ----- derived quantities (frame-rate arithmetic, SURVEY.md App. B) -----

    @property
    def frame_samples(self) -> int:
        """Samples per model frame = 16000//frame_hz + 320."""
        return self.sample_rate // self.frame_hz + FRAME_CONTEXT_PADDING

    @property
    def frame_shift(self) -> int:
        """Fresh samples per frame (frame minus the 320-sample overlap)."""
        return self.sample_rate // self.frame_hz

    @property
    def cpc_frames_per_chunk(self) -> int:
        """CPC frames per chunk after the edge trim: 100//frame_hz."""
        return 100 // self.frame_hz

    @property
    def downsample_kernel(self) -> int:
        """Downsample conv kernel = stride = 100//frame_hz
        (fixed by checkpoint weights; reference train/encoder.py:33-34)."""
        return 100 // self.frame_hz

    @property
    def context_frames(self) -> int:
        """Embedding ring-buffer capacity = context_len_sec * frame_hz
        (reference: rvap/vap_main/vap_main.py:221)."""
        return int(self.context_len_sec * self.frame_hz)

    @property
    def ffn_dim(self) -> int:
        return self.dim * self.dff_k

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def n_bins(self) -> int:
        return len(self.bin_times)

    @property
    def n_classes(self) -> int:
        """Discrete VA-projection codebook size: 2^(2*n_bins) = 256."""
        return 2 ** (2 * self.n_bins)

    def bin_frames(self, frame_hz: int | None = None) -> List[int]:
        """Projection-bin widths in frames (objective.py:10-11)."""
        hz = self.frame_hz if frame_hz is None else frame_hz
        return [int(t * hz) for t in self.bin_times]

    def replace(self, **kw) -> "VapConfig":
        return dataclasses.replace(self, **kw)


def add_argparse_args(parser, prefix: str = "vap_"):
    """Auto-generate ``--vap_*`` flags from the dataclass fields, mirroring
    the reference's prefix convention (rvap/vap_main/vap_main.py:65-75)."""
    for f in dataclasses.fields(VapConfig):
        name = f"--{prefix}{f.name}"
        if f.name == "bin_times":
            parser.add_argument(name, nargs="+", type=float,
                                default=list(BIN_TIMES))
        elif f.type in ("bool", bool):
            parser.add_argument(name, type=int, default=int(f.default))
        else:
            typ = type(f.default)
            parser.add_argument(name, type=typ, default=f.default)
    return parser


def args_to_conf(args, prefix: str = "vap_") -> VapConfig:
    """Strip the prefix back into a VapConfig (vap_main.py:77-85)."""
    kw = {}
    for f in dataclasses.fields(VapConfig):
        v = getattr(args, prefix + f.name, None)
        if v is None:
            continue
        if f.name == "bin_times":
            v = tuple(v)
        elif f.type in ("bool", bool):
            v = bool(v)
        kw[f.name] = v
    return VapConfig(**kw)
