"""PyTorch port: the reference's .pt checkpoints through
`load_torch_checkpoint`, `VapEngine(vap_model=, cpc_model=)` and the
entry points' --vap_model / --cpc_model, against the JAX package on the
same files."""

import numpy as np
import pytest
import torch

from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.runtime.engine import VapEngine as JaxEngine
from vap_realtime_tpu.weights.convert import (
    load_torch_checkpoint as jax_load_torch_checkpoint,
)
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io.audio import write_wav
from vap_realtime_tpu_torch.runtime import offline, server_native
from vap_realtime_tpu_torch.runtime.engine import VapEngine
from vap_realtime_tpu_torch.weights.convert import (
    _flatten, convert_state_dict, load_torch_checkpoint,
)
from vap_realtime_tpu_torch.weights.synthetic import (
    synthetic_audio, synthetic_cpc_weights, synthetic_vap_state_dict,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Keep PyTorch to one CPU thread while this file runs: the suite runs
    several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pt_files(tmp_path_factory):
    """The synthetic weights saved as the reference's checkpoints: a flat
    VAP state_dict, and a CPC checkpoint with its arrays under
    "weights"."""
    tmp = tmp_path_factory.mktemp("pt")
    vap, cpc = str(tmp / "vap.pt"), str(tmp / "cpc.pt")
    torch.save({k: torch.from_numpy(v)
                for k, v in synthetic_vap_state_dict(20).items()}, vap)
    torch.save({"weights": {k: torch.from_numpy(v)
                            for k, v in synthetic_cpc_weights().items()}},
               cpc)
    return vap, cpc


def test_pt_checkpoint_matches_convert_and_jax(pt_files):
    """load_torch_checkpoint gives the same pytree as the port's
    convert_state_dict on the raw arrays and as the JAX package's
    load_torch_checkpoint on the same files: same leaf paths, every leaf
    bit-equal float32."""
    got = _flatten(load_torch_checkpoint(*pt_files))
    direct = _flatten(convert_state_dict(synthetic_vap_state_dict(20),
                                         synthetic_cpc_weights()))
    ref = _flatten(jax_load_torch_checkpoint(*pt_files))
    assert got.keys() == direct.keys() == ref.keys()
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], direct[k], err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_engine_from_pt_matches_jax_engine(pt_files):
    """VapEngine(vap_model=, cpc_model=, device="cpu") on the kv path
    against the JAX engine built from the same files: 6 overlapped frames
    through process_batch, every output at atol 1e-4."""
    vap, cpc = pt_files
    kw = dict(frame_hz=20, context_len_sec=1.0)
    te = VapEngine(VapConfig(**kw), vap_model=vap, cpc_model=cpc,
                   device="cpu")
    je = JaxEngine(JaxConfig(**kw), vap_model=vap, cpc_model=cpc)
    assert te.path == je.path == "kv"
    te.warmup()
    je.warmup()
    rs = np.random.RandomState(11)
    for f in range(6):
        chunk = (0.1 * rs.randn(1, 2, te.chunk_samples)).astype(np.float32)
        want, got = je.process_batch(chunk), te.process_batch(chunk)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-4, err_msg=f"{k} frame {f}")


def test_engine_without_weights_names_every_source():
    """With no params, no .npz and not both .pt files the engine raises,
    and the message names the three sources, as the JAX engine's does."""
    for kw in ({}, {"vap_model": "v.pt"}, {"cpc_model": "c.pt"}):
        with pytest.raises(ValueError) as err:
            VapEngine(VapConfig(), device="cpu", **kw)
        msg = str(err.value)
        assert all(s in msg for s in ("params", "checkpoint_npz",
                                      "vap_model", "cpc_model")), msg
    with pytest.raises(ValueError, match="vap_model"):
        JaxEngine(JaxConfig())


def test_offline_main_takes_pt_checkpoints(pt_files, tmp_path):
    """offline.main --vap_model --cpc_model writes the same CSV, byte for
    byte, as --synthetic_weights (the .pt files hold those weights)."""
    audio = synthetic_audio(16000, seed=5)
    left, right = str(tmp_path / "l.wav"), str(tmp_path / "r.wav")
    write_wav(left, audio[0])
    write_wav(right, audio[1])
    base = ["--input_wav_left", left, "--input_wav_right", right,
            "--engine_path", "kv", "--device", "cpu",
            "--context_len_sec", "1.0"]
    csv = {}
    for name, weights in (("pt", ["--vap_model", pt_files[0],
                                  "--cpc_model", pt_files[1]]),
                          ("synthetic", ["--synthetic_weights"])):
        csv[name] = str(tmp_path / f"{name}.csv")
        offline.main(base + weights + ["--filename_output", csv[name]])
    with open(csv["pt"]) as a, open(csv["synthetic"]) as b:
        text = a.read()
        assert text == b.read() and len(text.splitlines()) == 20


@pytest.mark.parametrize("argv,ok", [
    (["--vap_model", "v.pt", "--cpc_model", "c.pt"], True),
    (["--checkpoint_npz", "w.npz"], True),
    (["--synthetic_weights"], True),
    (["--vap_model", "v.pt"], False),
    ([], False)])
def test_native_server_weight_options(argv, ok, capsys):
    """server_native takes --vap_model with --cpc_model as a third source
    of weights; without a whole source its parser exits naming all
    three."""
    if ok:
        args = server_native.parse_args(argv)
        assert (args.vap_model, args.cpc_model) == (
            ("v.pt", "c.pt") if "--cpc_model" in argv else (None, None))
        return
    with pytest.raises(SystemExit):
        server_native.parse_args(argv)
    err = capsys.readouterr().err
    assert all(s in err for s in ("--checkpoint_npz", "--vap_model",
                                  "--cpc_model", "--synthetic_weights"))
