"""PyTorch port: the probability step's bin-sum tables
(`models/objective.py` `bin_sum_table`) are built once per bins, dtype
and device and reused: p_now / p_future bit-equal to a table built on
every call, a warm serving tick builds none and copies nothing from host
memory to its device, and a `torch.export` trace leaves no traced tensor
in the cache."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models import objective as obj
from vap_realtime_tpu_torch.runtime.arena import StreamArena
from vap_realtime_tpu_torch.tools import export_static
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _per_call(probs, from_bin, to_bin):
    """The aggregation with its table built from the codebook on every
    call: class i's bit 4c + b is speaker c's activity in bin b."""
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1
    table = bits.reshape(256, 2, 4)[:, :, from_bin:to_bin + 1].sum(-1)
    abp = torch.as_tensor(table.astype(np.float32), dtype=probs.dtype,
                          device=probs.device)
    p = probs @ abp
    return p / (p.sum(dim=-1, keepdim=True) + 1e-5)


@pytest.mark.parametrize("shape", [(5, 2, 256), (5, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_p_now_p_future_bit_equal_to_a_table_built_per_call(dtype, shape):
    g = torch.Generator().manual_seed(7)
    probs = torch.softmax(3 * torch.randn(shape, generator=g), dim=-1)
    probs = probs.to(dtype)
    for _ in range(2):                   # cold, then from the cache
        assert torch.equal(obj.p_now(probs), _per_call(probs, 0, 1))
        assert torch.equal(obj.p_future(probs), _per_call(probs, 2, 3))


def test_one_build_per_key_and_the_same_tensor_after():
    obj._bin_sum_table_cached.cache_clear()
    n = obj.bin_sum_table.builds
    a = obj.bin_sum_table(0, 1, 4, torch.float16, CPU)
    assert obj.bin_sum_table.builds == n + 1
    b = obj.bin_sum_table(0, 1, 4, torch.float16, CPU)
    assert b.data_ptr() == a.data_ptr()
    assert obj.bin_sum_table.builds == n + 1
    np.testing.assert_array_equal(a.float().numpy(),
                                  obj.bin_sum_matrix(0, 1, 4))
    obj.bin_sum_table(2, 3, 4, torch.float16, CPU)           # new bins
    assert obj.bin_sum_table.builds == n + 2
    obj.bin_sum_table(0, 1, 4, torch.float32, CPU)           # new dtype
    assert obj.bin_sum_table.builds == n + 3
    probs = torch.full((3, 256), 1 / 256, dtype=torch.bfloat16)
    for _ in range(3):
        obj.p_now(probs)
        obj.p_future(probs)
    assert obj.bin_sum_table.builds == n + 5


def test_a_table_first_built_under_inference_mode_takes_a_backward():
    """Serving under `torch.inference_mode` must not leave an inference
    tensor in the cache: autograd saves the table for the backward."""
    obj._bin_sum_table_cached.cache_clear()
    with torch.inference_mode():
        obj.p_now(torch.full((2, 256), 1 / 256, dtype=torch.float64))
    logits = torch.randn(2, 256, dtype=torch.float64, requires_grad=True)
    obj.p_now(torch.softmax(logits, dim=-1)).sum().backward()
    assert torch.isfinite(logits.grad).all()


@pytest.mark.parametrize("mode", ["vap", "nod"])
def test_warm_staged_fast_ticks_build_and_upload_nothing(mode, monkeypatch):
    """Warm ticks of the serving arena (fast path, staged slots, bf16, the
    int16 wire), past a merge tick: no table is built and no tensor is
    made from host data with a `device=` (on the card a copy from
    pageable memory, which waits for the queued work)."""
    cfg = VapConfig(mode=mode, frame_hz=20, context_len_sec=2.5)
    arena = StreamArena(cfg, synthetic_params(20, mode), capacity=2,
                        path="fast", dtype=torch.bfloat16, slots="staged",
                        attend_impl="kernel", wire_dtype=np.int16,
                        conv_impl="fused", device=CPU)
    arena.warmup()
    rs = np.random.RandomState(3)
    slots = np.arange(2)

    def frames():
        return rs.randint(-3000, 3000, (2, 2, cfg.frame_samples)
                          ).astype(np.int16)

    arena.step_device_batch(frames(), slots)
    uploads = []

    def counted(make):
        def call(*args, **kw):
            if kw.get("device") is not None or (
                    make is torch.as_tensor and len(args) > 2):
                uploads.append(make.__name__)
            return make(*args, **kw)
        return call

    monkeypatch.setattr(torch, "as_tensor", counted(torch.as_tensor))
    monkeypatch.setattr(torch, "tensor", counted(torch.tensor))
    n = obj.bin_sum_table.builds
    for _ in range(9):                   # 9 ticks: one merges the stage
        out = arena.step_device_batch(frames(), slots)
        assert torch.isfinite(out["p_now"].float()).all()
    assert obj.bin_sum_table.builds == n
    assert uploads == []


def test_export_leaves_no_traced_table_in_the_cache():
    """Tracing the static step for export builds its tables anew and
    caches none; an eager call afterwards returns a plain tensor equal to
    the table."""
    obj._bin_sum_table_cached.cache_clear()
    n = obj.bin_sum_table.builds
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    export_static.export_artifact(synthetic_params(20), cfg, 7, device="cpu")
    assert obj._bin_sum_table_cached.cache_info().currsize == 0
    assert obj.bin_sum_table.builds == n
    for lo, hi in ((0, 1), (2, 3)):
        t = obj.bin_sum_table(lo, hi, 4, torch.float32, CPU)
        assert type(t) is torch.Tensor
        np.testing.assert_array_equal(t.numpy(), obj.bin_sum_matrix(lo, hi))
    assert obj.bin_sum_table.builds == n + 2
