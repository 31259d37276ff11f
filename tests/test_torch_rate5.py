"""PyTorch port at 5 Hz (the nod ERICA 5 Hz / 10 s checkpoint's shape):
the serving arena on the benchmark's serving options against the plain
float64 reference, K7's long-frame route (a 3,200-sample frame as four
800-sample body calls) against the whole-frame stack, and the encoder's
three child spans, on the CPU."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.models.encoder import init_cpc_encoder_params
from vap_realtime_tpu_torch.ops.cuda import encoder as k7
from vap_realtime_tpu_torch.runtime.arena import StreamArena
from vap_realtime_tpu_torch.utils import spans
from vapbench.common import load_config
from vapbench.reference.serving import FIELDS, stream_outputs
from vapbench.serving import vap_config
from vapbench.weights import make_params

CONFIG = "nod_erica_5hz_10000ms"
STREAMS, FRAMES = 4, 60          # 60 frames: the 50-row ring wraps
# the port in float32 against the float64 reference, every field at
# every frame: float32 rounding through the conv stack, the LSTM carried
# from the stream's start and the trunk reads ~2.4e-7; 1e-5 leaves 40x
# room, and the same path in bf16 reads ~5e-3, over 500x the limit
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Keep PyTorch to two CPU threads while this file runs: the suite
    runs several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arena(dtype, seed=2 ** 33 + 5):
    """The benchmark's serving options (`vapbench/serving.py`) on the
    5 Hz configuration, seeded weights, on the CPU (K7 and K2 run their
    plain versions)."""
    cfg = load_config(CONFIG)
    serve = cfg["serving"]
    model = cfg["model"]
    vcfg = vap_config(model)
    params = make_params(model, seed, torch.device("cpu"), dtype)
    arena = StreamArena(
        vcfg, params, capacity=STREAMS, path=serve["path"], dtype=dtype,
        slots=serve["slots"], attend_impl=serve["attend_impl"],
        wire_dtype=np.dtype(serve["wire_dtype"]).type,
        conv_impl=serve["conv_impl"], conv_chunks=serve["conv_chunks"],
        device="cpu")
    arena.warmup()
    return arena, params, model


def _serve(dtype, frames):
    """(served fields (S, F, n) by the arena, by the reference)."""
    arena, params, model = _arena(dtype)
    assert arena.chunk_samples == 3200
    slots = np.arange(STREAMS)
    got = []
    for f in frames:
        out = arena.step_device_batch(f, slots)
        got.append(np.concatenate([out[k].float().numpy().reshape(
            STREAMS, -1) for k in FIELDS["nod"]], axis=1))
    audio = np.stack(frames, axis=2).reshape(STREAMS, 2, -1)
    ref = stream_outputs(params, model, audio, torch.device("cpu"))
    return np.stack(got, axis=1), ref


def _frames(n, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.randn(STREAMS, 2, 3200) * 3000).astype(np.int16)
            for _ in range(n)]


def test_arena_at_5hz_matches_the_reference_every_frame():
    """StreamArena on the fast path (fused K7, staged slots, the kernel
    attend, int16 wire) at 5 Hz with the nod heads, float32: every served
    field at every frame, before and after the ring wraps and across the
    staged merges, within ATOL of the float64 reference."""
    got, ref = _serve(torch.float32, _frames(FRAMES))
    assert got.shape == ref.shape == (STREAMS, FRAMES, 4)
    gap = np.abs(got - ref)
    assert np.isfinite(got).all()
    assert gap.max() < ATOL, (gap.max(), np.unravel_index(gap.argmax(),
                                                          gap.shape))


def test_arena_at_5hz_in_bf16_fails_the_float32_limit():
    """The limit sees a precision fault: the same path computing in bf16
    strays past ATOL within its first frames."""
    got, ref = _serve(torch.bfloat16, _frames(8))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() > 10 * ATOL


def _k7_inputs(dtype, B=6, seed=0):
    enc = init_cpc_encoder_params(torch.Generator().manual_seed(seed), 256,
                                  20)
    g = torch.Generator().manual_seed(seed + 1)
    c0 = torch.randn(B, 5, generator=g).to(dtype)
    carries = tuple(torch.randn(B, k - s, 256, generator=g).abs().to(dtype)
                    for k, s in k7.TAIL_KS)
    news = [(0.1 * torch.randn(B, 3200, generator=g)).to(dtype)
            for _ in range(3)]
    return c0, carries, news, k7.pack_fused_params(enc, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_pieces_are_bit_equal_to_the_whole_frame(dtype):
    """K7's long-frame route (`in_pieces`: four 800-sample calls, each
    one's carries the next one's) against one call over the whole
    3,200-sample frame, both the plain version, over 3 frames each
    carrying its own state: z and every carry bit-equal."""
    c0, carries, news, packed = _k7_inputs(dtype)
    whole = pieces = (c0, *carries)
    for f, new in enumerate(news):
        zw, whole = k7.conv_stack_fused_plain(whole[0], new, whole[1:],
                                              *packed)
        zp, pieces = k7.in_pieces(k7.conv_stack_fused_plain, pieces[0], new,
                                  pieces[1:], *packed)
        assert zw.shape == (6, 20, 256) and zw.dtype == dtype
        assert torch.equal(zw, zp), f"z frame {f}"
        for i, (a, b) in enumerate(zip(whole, pieces)):
            assert torch.equal(a, b), f"c{i} frame {f}"


def _fits(dtype):
    """The body's rule for one call (`conv_stack_fused_smem` > 0 within
    the shared memory): bf16 takes conv1 rows T1 <= 80, float32 frames
    of at most 800 samples."""
    def fits(L):
        T1 = k7.tail_lens(L // 5)[0][1]
        return T1 <= 80 if dtype == torch.bfloat16 else L <= 800
    return fits


@pytest.mark.parametrize("dtype,L,piece", [
    (torch.bfloat16, 800, 800), (torch.bfloat16, 1600, 1600),
    (torch.bfloat16, 3200, 800), (torch.bfloat16, 16000, 800),
    (torch.float32, 800, 800), (torch.float32, 1600, 800),
    (torch.float32, 3200, 800)])
def test_k7_piece_choice(dtype, L, piece):
    """A frame one call takes runs as one call (the 20 Hz frame's call
    is unchanged, and 10 Hz stays one bf16 call); a longer one runs in
    800-sample pieces."""
    assert k7.piece_samples(L, _fits(dtype)) == piece


def test_k7_refuses_a_long_frame_it_cannot_cut_and_names_the_limit():
    with pytest.raises(ValueError, match="at most 1600 samples in bf16"):
        k7.piece_samples(1760, _fits(torch.bfloat16))


def test_k7_counters_count_only_the_card():
    """`conv_stack_fused.launches` (body calls) and `.samples` (the
    channel-stream samples they computed) exist; CPU calls run the plain
    version and count nothing."""
    c0, carries, news, packed = _k7_inputs(torch.bfloat16)
    before = (k7.conv_stack_fused.launches, k7.conv_stack_fused.samples)
    assert all(isinstance(x, int) for x in before)
    k7.conv_stack_fused(c0, news[0], carries, *packed)
    assert (k7.conv_stack_fused.launches,
            k7.conv_stack_fused.samples) == before


def test_encoder_child_spans_once_a_tick_at_5hz():
    """With the recorder on, each tick's `vap.encode` holds
    `vap.encode.conv`, `.lstm` and `.down` once each, in that order."""
    arena, _, _ = _arena(torch.float32)
    slots = np.arange(STREAMS)
    spans.enable(True)
    try:
        for f in _frames(3, seed=4):
            arena.step_device_batch(f, slots)
    finally:
        spans.enable(False)
    recs = spans.take()
    encs = [i for i, r in enumerate(recs) if r.name == "vap.encode"]
    assert len(encs) == 3
    for i in encs:
        kids = [r for r in recs if r.parent == i]
        assert [r.name for r in kids] == [
            "vap.encode.conv", "vap.encode.lstm", "vap.encode.down"]
        assert all(r.id == recs[i].id for r in kids)
        assert all(recs[i].start_ns <= r.start_ns and r.end_ns
                   <= recs[i].end_ns for r in kids)
