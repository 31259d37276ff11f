"""PyTorch port: the chunked encoder's conv tail (K9, `cpc_conv_tail`).
Its plain version against the TPU kernel in interpret mode and against
the port's `cpc_conv_stack`; the wrapper runs the plain version on CPU
tensors.  The CUDA kernel runs only on the card (chip_smoke.py holds it
against this plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu.ops.pallas import cpc_conv as jtail
from vap_realtime_tpu_torch.models.encoder import cpc_conv_stack
from vap_realtime_tpu_torch.ops.basic import channel_norm, conv1d
from vap_realtime_tpu_torch.ops.cuda.cpc_conv import (
    cpc_conv_tail, cpc_conv_tail_plain, pack_tail_params, tail_out_len,
)
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def enc():
    return synthetic_params(20)["encoder"]


def _x0(enc_t, wav):
    """conv0 + ChannelNorm + ReLU of (B, L) audio, time-major (B, L0, C),
    as the chunked encoder computes it."""
    c, n = enc_t["conv0"], enc_t["norm0"]
    y = torch.relu(channel_norm(conv1d(wav[:, None], c["w"], c["b"], 5, 3),
                                n["w"], n["b"]))
    return y.transpose(1, 2).contiguous()


def _wav(B, L, seed):
    rs = np.random.RandomState(seed)
    return torch.as_tensor((0.1 * rs.randn(B, L)).astype(np.float32))


def test_tail_out_len():
    assert tail_out_len(224) == [56, 28, 14, 7]    # 20 Hz chunk
    assert tail_out_len(384) == [96, 48, 24, 12]   # 10 Hz chunk
    assert tail_out_len(128) == [32, 16, 8, 4]     # 50 Hz chunk
    for L0 in (224, 384, 128, 57):
        assert tail_out_len(L0) == jtail.tail_out_len(L0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2 ** -7)])
def test_plain_matches_jax_kernel(enc, dtype, atol):
    """cpc_conv_tail_plain against the TPU kernel in interpret mode at
    B=4, L0=224 on the same x0 and weights.  float32: 1e-5 (float32
    products summed in another order).  bf16 x0 and weights: both compute
    in float32 inside and round only the output, so they agree to one
    bf16 step of outputs below 1 (2^-7, and rtol 2^-7 above)."""
    enc_t = params_to_torch(enc)
    x0 = _x0(enc_t, _wav(4, 1120, 0)).to(dtype)
    packed = pack_tail_params(params_to_torch(enc, dtype=dtype))
    got = cpc_conv_tail_plain(x0, packed)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jtail.cpc_conv_tail(
        jnp.asarray(x0.float().numpy()).astype(jdt),
        jtail.pack_tail_params(
            {k: {n: jnp.asarray(v).astype(jdt) for n, v in d.items()}
             for k, d in enc.items() if k.startswith(("conv", "norm"))}),
        block_b=4, interpret=True)
    assert got.shape == (4, 7, 256) and got.dtype == dtype
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=0 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("L", [1120, 1920, 640])
def test_tail_matches_cpc_conv_stack(enc, L):
    """The wrapper (plain version on CPU tensors) after conv0 equals the
    port's cpc_conv_stack at 1e-4 (tests/test_pallas.py:26-43), at the
    20, 10 and 50 Hz chunk lengths (L0 = 224, 384, 128)."""
    enc_t = params_to_torch(enc)
    wav = _wav(4, L, 1)
    x0 = _x0(enc_t, wav)
    assert x0.shape[1] == {1120: 224, 1920: 384, 640: 128}[L]
    got = cpc_conv_tail(x0, pack_tail_params(enc_t))
    np.testing.assert_allclose(got.numpy(),
                               cpc_conv_stack(enc_t, wav).numpy(), atol=1e-4)


def test_bf16_x0_computes_in_float32(enc):
    """With a bf16 x0 the tail still computes in float32: the result is the
    float32 tail of the (exactly widened) bf16 input, rounded once."""
    enc_t = params_to_torch(enc)
    x0 = _x0(enc_t, _wav(3, 1120, 2)).to(torch.bfloat16)
    packed = pack_tail_params(enc_t)
    got = cpc_conv_tail(x0, packed)
    assert got.dtype == torch.bfloat16
    ref = cpc_conv_tail_plain(x0.float(), packed)
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_wrapper_checks_its_arguments(enc):
    packed = pack_tail_params(params_to_torch(enc))
    with pytest.raises(ValueError, match="16 tensors"):
        cpc_conv_tail(torch.zeros(1, 224, 256), packed[:8])
