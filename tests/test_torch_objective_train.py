"""The train side of the port's objective against the JAX package's:
labels bit for bit (and the original reference's `unit.npz` labels),
the bc labels bit for bit, every loss at 1e-6 on the same numpy
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_realtime_tpu.models import objective as jobj
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models import objective as tobj

T = torch.from_numpy


def test_labels_equal_golden(golden_unit):
    """`unit.npz` labels come from the reference's 50 Hz objective."""
    cfg = VapConfig(frame_hz=50)
    got = tobj.get_labels(T(golden_unit["vad_in"]), cfg.bin_frames())
    np.testing.assert_array_equal(got.numpy(), golden_unit["labels"])


@pytest.mark.parametrize("frame_hz", [10, 20, 50])
def test_labels_and_windows_bit_equal_jax(frame_hz):
    rs = np.random.RandomState(frame_hz)
    cfg = VapConfig(frame_hz=frame_hz)
    va = (rs.rand(3, 8 * frame_hz, 2) > 0.4).astype(np.float32)
    bf = cfg.bin_frames()
    np.testing.assert_array_equal(
        tobj.projection_windows(T(va), bf).numpy(),
        np.asarray(jobj.projection_windows(jnp.asarray(va), bf)))
    np.testing.assert_array_equal(
        tobj.get_labels(T(va), bf).numpy(),
        np.asarray(jobj.get_labels(jnp.asarray(va), bf)))


@pytest.mark.parametrize("frame_hz", [10, 20, 50])
def test_labels_bc_bit_equal_jax(frame_hz):
    rs = np.random.RandomState(frame_hz + 1)
    bc = (rs.rand(3, 8 * frame_hz) > 0.8).astype(np.float32)
    got = tobj.get_labels_bc(T(bc), frame_hz).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jobj.get_labels_bc(bc, frame_hz)))
    assert got.shape == (3, 6 * frame_hz)


def _loss_inputs():
    rs = np.random.RandomState(5)
    return dict(
        logits=rs.randn(2, 30, 256).astype(np.float32) * 2,
        labels=rs.randint(0, 256, size=(2, 33)),
        vad_logits=rs.randn(2, 30, 2).astype(np.float32) * 3,
        vad=(rs.rand(2, 36, 2) > 0.5).astype(np.float32),
        bc_logits=rs.randn(2, 40).astype(np.float32),
        bc_labels=(rs.rand(2, 42) > 0.7).astype(np.float32),
        mono_logits=rs.randn(2, 30, 1).astype(np.float32),
    )


LOSSES = {
    "loss_vap": lambda o, d: o.loss_vap(d["logits"], d["labels"]),
    "loss_vap_none": lambda o, d: o.loss_vap(d["logits"], d["labels"],
                                            reduction="none"),
    "loss_vad": lambda o, d: o.loss_vad(d["vad_logits"], d["vad"]),
    "loss_bc": lambda o, d: o.loss_bc(d["bc_logits"], d["bc_labels"]),
    "loss_bc_pw": lambda o, d: o.loss_bc(d["bc_logits"], d["bc_labels"],
                                         3.5),
    "loss_vad_mono": lambda o, d: o.loss_vad_mono(d["mono_logits"],
                                                  d["vad"]),
    "loss_lid": lambda o, d: o.loss_lid(d["logits"], d["labels"]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    d = _loss_inputs()
    got = LOSSES[name](tobj, {k: T(v) for k, v in d.items()}).numpy()
    want = np.asarray(LOSSES[name](jobj, {k: jnp.asarray(v)
                                          for k, v in d.items()}))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_encode_codebook_and_bin_frames():
    bins = np.zeros((1, 2, 4), np.float32)
    bins[0, 1, 3] = 1.0                       # speaker 1, bin 3: bit 7
    bins[0, 0, 0] = 1.0                       # speaker 0, bin 0: bit 0
    assert tobj.encode_codebook(T(bins)).tolist() == [129]
    assert tobj.bin_times_to_frames([0.2, 0.4, 0.6, 0.8], 20) == \
        jobj.bin_times_to_frames([0.2, 0.4, 0.6, 0.8], 20) == [4, 8, 12, 16]
