"""The serving arena's fenced upload, on the CPU: the piece plan taken
from the fused conv stack's own body rule, `in_pieces` waiting on piece
j's event right before body call j, the one-pass int16 normalisation
bit-equal to a cast followed by the 2^-15 scale, and the CPU arena's
served fields bit-equal to that cast-then-scale over 5 Hz and 20 Hz
ticks past a merge tick, with no piece counted on the CPU."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.ops.cuda import encoder as k7
from vap_realtime_tpu_torch.runtime.arena import (
    StreamArena, normalise, upload_piece,
)
from vap_realtime_tpu_torch.runtime.incremental import STAGE_S
from vapbench.common import load_config
from vapbench.serving import vap_config
from vapbench.weights import make_params

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
BF16, F32 = torch.bfloat16, torch.float32


def _fits(limit, asked):
    """A body rule that takes frames of at most `limit` samples and notes
    each frame length it is asked about."""
    def fits(L):
        asked.append(L)
        return L <= limit
    return fits


@pytest.mark.parametrize("path,conv_impl,dtype,L,device,limit,want", [
    ("fast", "fused", BF16, 3200, CUDA, 1600, 800),    # 5 Hz: 4 pieces
    ("fast_hybrid", "fused", BF16, 3200, CUDA, 1600, 800),
    ("fast", "fused", F32, 3200, CUDA, 800, 800),      # float32 body
    ("fast", "fused", BF16, 1600, CUDA, 1600, 1600),   # 10 Hz: one piece
    ("fast", "fused", BF16, 800, CUDA, 1600, 800),     # 20 Hz: one piece
    ("fast", "conv", BF16, 3200, CUDA, 1600, 3200),
    ("fast", "normk", BF16, 3200, CUDA, 1600, 3200),
    ("kv", "fused", BF16, 3520, CUDA, 1600, 3520),
    ("full", "conv", BF16, 1120, CUDA, 1600, 1120),
    ("fast", "fused", BF16, 3200, CPU, 1600, 3200),
    ("fast", "fused", BF16, 800, CPU, 1600, 800),
])
def test_upload_piece_plan(path, conv_impl, dtype, L, device, limit, want):
    """The piece is the body call's (`piece_samples` with the injected
    body rule) only where the fused stack reads the frame on the card;
    every other case is one piece, and the body rule is not asked."""
    asked = []
    got = upload_piece(path, conv_impl, L, dtype, device,
                       fits=_fits(limit, asked))
    assert got == want
    assert L % got == 0
    fused_on_card = (conv_impl == "fused" and device.type == "cuda"
                     and path in ("fast", "fast_hybrid"))
    assert bool(asked) == fused_on_card


class _Event:
    """A stand-in for a CUDA event: `wait()` notes its piece."""

    def __init__(self, log, j):
        self.log, self.j = log, j

    def wait(self):
        self.log.append(("wait", self.j))


def _k7_inputs(B=3, L=3200, seed=0):
    g = torch.Generator().manual_seed(seed)
    new = torch.randn(B, L, generator=g)
    c0 = torch.randn(B, 5, generator=g)
    carries = tuple(torch.randn(B, k - s, k7.C, generator=g)
                    for k, s in k7.TAIL_KS)
    return c0, new, carries


def test_in_pieces_waits_on_each_piece_right_before_its_call():
    """A fake stack and fence: piece j's event is waited on once, in
    order, right before body call j, which reads piece j's samples; the
    result equals the unfenced call's."""
    log = []
    c0, new, carries = _k7_inputs()

    def stack(c0_, x, cs, w0, wts, aux):
        at = len([e for e in log if e[0] == "call"])
        assert torch.equal(x, new[:, 800 * at:800 * (at + 1)])
        log.append(("call", at))
        z = x[:, :5, None].expand(-1, -1, 2)
        return z, (x[:, -5:], *[c + 1 for c in cs])

    fence = [_Event(log, j) for j in range(4)]
    z, tails = k7.in_pieces(stack, c0, new, carries, None, None, None, 800,
                            fence)
    assert log == [(kind, j) for j in range(4) for kind in ("wait", "call")]
    log.clear()
    z0, tails0 = k7.in_pieces(stack, c0, new, carries, None, None, None, 800)
    assert [e[0] for e in log] == ["call"] * 4
    assert torch.equal(z, z0)
    assert all(torch.equal(a, b) for a, b in zip(tails, tails0))


def test_conv_stack_fused_on_the_cpu_waits_on_the_whole_fence_first():
    """On a CPU tensor the stack runs its plain version over the whole
    frame: every event is waited on once, before it, and the result is
    the unfenced one's."""
    from vap_realtime_tpu_torch.models.encoder import init_cpc_encoder_params

    enc = init_cpc_encoder_params(torch.Generator().manual_seed(1))
    log = []
    c0, new, carries = _k7_inputs(B=2, L=1600, seed=2)
    packed = k7.pack_fused_params(enc, F32)
    got = k7.conv_stack_fused(c0, new, carries, *packed,
                              fence=[_Event(log, j) for j in range(2)])
    want = k7.conv_stack_fused(c0, new, carries, *packed)
    assert log == [("wait", 0), ("wait", 1)]
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_normalise_every_int16_value_as_cast_then_scale(dtype):
    """One pass (int16 times 2^-15, rounded once) gives, for every int16
    value, the bits of a cast to the compute dtype followed by the scale,
    into a fresh tensor and into a strided view of a buffer."""
    x = torch.arange(-32768, 32768, dtype=torch.int16)
    want = x.to(dtype) * (1.0 / 32768.0)
    got = normalise(x, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    buf = torch.zeros((2, x.numel()), dtype=dtype)
    normalise(x.view(256, 256)[:, 64:192], dtype,
              buf.view(512, 256)[:256, 64:192])
    assert torch.equal(buf.view(512, 256)[:256, 64:192],
                       want.view(256, 256)[:, 64:192])
    f = torch.randn(4, 8)
    assert torch.equal(normalise(f, dtype), f.to(dtype))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Keep PyTorch to two CPU threads while this file runs: the suite
    runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", ["nod_erica_5hz_10000ms",
                                    "vap_jp_20hz_2500ms"])
def test_cpu_arena_bit_equal_to_cast_then_scale(config):
    """The benchmark's serving options on the CPU, two streams, bf16,
    seeded weights: STAGE_S + 2 ticks of fresh int16 frames through
    `step_device_batch` (one merges the stage) serve the fields, bit for
    bit, of the same ticks given the frame cast to bf16 and scaled by
    2^-15 on their own; no upload piece is counted on the CPU."""
    cfg = load_config(config)
    serve, model = cfg["serving"], cfg["model"]
    vcfg = vap_config(model)
    params = make_params(model, 2 ** 33 + 7, CPU, BF16)

    def arena():
        a = StreamArena(
            vcfg, params, capacity=2, path=serve["path"], dtype=BF16,
            slots=serve["slots"], attend_impl=serve["attend_impl"],
            wire_dtype=np.dtype(serve["wire_dtype"]).type,
            conv_impl=serve["conv_impl"], conv_chunks=serve["conv_chunks"],
            device="cpu")
        a.warmup()
        return a

    got, want = arena(), arena()
    rs = np.random.RandomState(11)
    slots = np.arange(2)
    act = torch.ones(2, dtype=torch.bool)
    pieces = StreamArena.upload_pieces
    for _ in range(STAGE_S + 2):
        f = rs.randint(-20000, 20000, (2, 2, vcfg.frame_shift)
                       ).astype(np.int16)
        a = got.step_device_batch(f, slots)
        b = want.step_tensors(
            torch.from_numpy(f).to(BF16) * (1.0 / 32768.0), act)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert got.state.kv.step == want.state.kv.step >= STAGE_S
    assert StreamArena.upload_pieces == pieces
