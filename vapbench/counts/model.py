"""Model FLOPs of a whole serving tick and of a whole training step,
from the configuration's shapes (2 per multiply-add; norms, softmax and
activations not counted).

Serving tick (the fast path, per stream): for each of the 2 channels the
streaming conv stack over `frame_shift` fresh samples (`conv_stack_fused`'s
count), the LSTM's input and hidden products over the tick's CPC frames,
and the downsample conv; then the trunk for one frame: every layer
phase's q / k / v / proj and FFN products, and each attention over the
T positions it reads (4 * T * D: scores and values); the combinator and
the heads.

Training step (per clip): the frozen encoder's forward over the whole
clip (the conv stack with its padding, the LSTM over the trimmed CPC
frames, the downsample), the trunk and heads over all frames with full
T x T attention scores (as the causal einsum computes them), and the
backward: twice the trunk's and heads' forward, plus the downsample's
weight gradient (its input is frozen).  AdamW's elementwise update is
not counted."""

from vapbench.counts import conv_stack_fused

CPC = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))


def _layers_ops(model: dict, frames: int, attended: int) -> int:
    """The trunk's products for `frames` query frames of one stream,
    each attending over `attended` positions (both channels / towers)."""
    D = model["dim"]
    F = D * model["dff_k"]
    lin = 4 * 2 * D * D              # q, k, v, proj
    att = 4 * attended * D           # scores and values
    ffn = 2 * 2 * D * F
    per_frame = (2 * model["channel_layers"] * (lin + att + ffn)
                 + 2 * model["cross_layers"] * (2 * (lin + att) + ffn))
    heads = 2 * 2 * D * D + 2 * D * 256 + 2 * 2 * D
    if model["mode"] == "nod":
        heads += 2 * D * 5
    elif model["mode"] == "bc":
        heads += 2 * D * 3
    return frames * (per_frame + heads)


def tick_flops(model: dict, streams: int) -> int:
    E = model["encoder_dim"]
    D = model["dim"]
    hz = model["frame_hz"]
    fresh = 16000 // hz
    cpc_frames = fresh // 160
    kd = 100 // hz
    T = int(model["context_len_sec"] * hz)
    enc = (conv_stack_fused.call_ops(1, fresh, E)
           + cpc_frames * 2 * (2 * E * 4 * E)
           + 2 * D * E * kd)
    return streams * (2 * enc + _layers_ops(model, 1, T))


def _conv_frames(samples: int):
    n = samples
    out = []
    for k, s, p in CPC:
        n = (n + 2 * p - k) // s + 1
        out.append(n)
    return out


def train_step_flops(model: dict, batch: int, samples: int) -> int:
    E = model["encoder_dim"]
    D = model["dim"]
    kd = 100 // model["frame_hz"]
    frames = _conv_frames(samples)
    conv = 0
    cin = 1
    for (k, _s, _p), n in zip(CPC, frames):
        conv += 2 * n * E * cin * k
        cin = E
    steps = frames[-1] - 2
    lstm = steps * 2 * (2 * E * 4 * E)
    T = steps // kd
    down = T * 2 * D * E * kd
    per_clip_enc = 2 * (conv + lstm)            # two channels
    trunk = _layers_ops(model, T, T)
    return batch * (per_clip_enc + 2 * 2 * down + 3 * trunk)


def train_frames(samples: int, frame_hz: int) -> int:
    return (_conv_frames(samples)[-1] - 2) // (100 // frame_hz)
