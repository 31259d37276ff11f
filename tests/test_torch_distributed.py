"""Multi-process training on the CPU: two gloo processes
(`python -m vap_realtime_tpu_torch.parallel.worker`) each take half of
one global batch and run one trainer step under DistributedDataParallel;
the counterpart of `tests/test_multihost.py`.

Their averaged gradient equals one process's gradient on the whole batch
(1e-7 abs + 1e-5 rel), the port's AdamW on that averaged gradient gives
the ranks' params on every element at 1e-6, and one process's whole-batch
step agrees at 1e-6 on every element whose gradient is at least 100x
Adam's eps (below that, Adam's first update g / (|g| + eps) amplifies the
float32 rounding of the gradient; see tests/test_torch_train.py).
`all_host_metrics` sums over the processes as the JAX package's does.
Every spawn and join has a timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.vap import VapModel, init_vap_params
from vap_realtime_tpu_torch.parallel import distributed as tdist
from vap_realtime_tpu_torch.parallel.mesh import (
    local_slice, replicate, shard_batch,
)
from vap_realtime_tpu_torch.parallel.worker import global_inputs
from vap_realtime_tpu_torch.train.trainer import (
    OptConfig, loss_fn, make_train_step, make_tx,
)
from vap_realtime_tpu_torch.weights.convert import params_to_numpy, tree_items

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs (the suite runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    paths = [str(out / f"w{i}.npz") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vap_realtime_tpu_torch.parallel.worker",
         "--address", f"tcp://localhost:{port}", "--world_size", "2",
         "--rank", str(i), "--out", paths[i], "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(p)) for p in paths]


@pytest.fixture(scope="module")
def single():
    """One process, the whole global batch: its gradient and its step."""
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5, cross_layers=1)
    model = VapModel(cfg, init_vap_params(torch.Generator().manual_seed(0),
                                          cfg))
    tx = make_tx(model, OptConfig())
    batch = shard_batch(global_inputs(0), "cpu")
    m = make_train_step(tx, cfg)(model, batch, None)
    grads = {k: v.grad.numpy().copy() for k, v in tree_items(model.params)
             if v.requires_grad}
    params = dict(tree_items(params_to_numpy(model.params)))
    return cfg, float(m["loss"]), grads, params


def test_ranks_agree_and_sum_metrics(ranks):
    for i, r in enumerate(ranks):
        assert int(r["rank"]) == i and int(r["world_size"]) == 2
        assert int(r["local_batch"]) == 2             # half of 4
        assert float(r["fleet_streams"]) == 30.0      # 10 * (1 + 2)
        assert float(r["fleet_frames"]) == 10.0
        assert float(r["loss_sum"]) == float(ranks[0]["loss"]) + float(
            ranks[1]["loss"])
    keys = [k for k in ranks[0] if k.startswith(("params/", "grads/"))]
    assert len(keys) == 2 * 38
    for k in keys:  # DDP keeps the replicas identical
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_averaged_gradient_equals_whole_batch_gradient(ranks, single):
    _, loss, grads, _ = single
    assert loss == pytest.approx(
        (float(ranks[0]["loss"]) + float(ranks[1]["loss"])) / 2, abs=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(ranks[0]["grads/" + k], g, rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_ddp_step_equals_single_process_step(ranks, single):
    """Every element: the port's AdamW on the ranks' averaged gradient
    gives the ranks' params (1e-6).  The single process's own step: 1e-6
    where its gradient is at least 100x eps, within two lr everywhere."""
    cfg, _, grads, params = single
    model = VapModel(cfg, init_vap_params(torch.Generator().manual_seed(0),
                                          cfg))
    tx = make_tx(model, OptConfig())
    for k, t in tree_items(model.params):
        if t.requires_grad:
            t.grad = torch.from_numpy(ranks[0]["grads/" + k].copy())
    tx.step()
    fed = dict(tree_items(params_to_numpy(model.params)))
    n_cond = n_all = 0
    d_all = 0.0
    for k, g in grads.items():
        got = ranks[0]["params/" + k]
        np.testing.assert_allclose(got, fed[k], rtol=0, atol=1e-6, err_msg=k)
        cond = np.abs(g) >= 100 * EPS
        n_cond, n_all = n_cond + int(cond.sum()), n_all + cond.size
        np.testing.assert_allclose(got[cond], params[k][cond], rtol=0,
                                   atol=1e-6, err_msg=k)
        d_all = max(d_all, float(np.abs(got - params[k]).max()))
        assert d_all <= 2 * 3.63e-4, k
    print(f"DDP vs one process: {n_cond} of {n_all} elements with |g| >= "
          f"1e-6; max |d| over all {d_all:.3g}")
    assert n_cond > 0.8 * n_all


def test_single_process_helpers():
    """Outside a process group: rank 0 of 1, metrics and batches pass
    through, DDP is not used; slices must divide evenly."""
    assert tdist.world() == (0, 1)
    tdist.init_distributed(None, 1, 0, "cpu")          # a no-op
    assert tdist.world() == (0, 1)
    assert tdist.all_host_metrics({"b": 2, "a": 1.5}) == {"a": 1.5,
                                                          "b": 2.0}
    x = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(tdist.global_batch({"x": x})["x"], x)
    np.testing.assert_array_equal(
        tdist.global_batch({"x": x}, rank=1, world_size=2)["x"], x[2:])
    np.testing.assert_array_equal(local_slice(x, 3, 4), x[3:])
    with pytest.raises(ValueError):
        local_slice(x, 0, 3)
    m = torch.nn.Linear(2, 2)
    assert tdist.wrap_model(m, "cpu") is m
    t = replicate({"a": [np.ones(2, np.float32)], "b": torch.zeros(1)},
                  "cpu")
    assert isinstance(t["a"][0], torch.Tensor) and t["b"].dtype == \
        torch.float32
    b = shard_batch({"w": np.zeros((4, 2), np.float32)}, "cpu", 1, 2)
    assert b["w"].shape == (2, 2)


def test_loss_fn_accepts_the_wrapped_model():
    """The trainer's loss goes through the module's forward (what DDP
    wraps): the same loss as the functional forward."""
    cfg = VapConfig(frame_hz=20, cross_layers=1)
    model = VapModel(cfg, init_vap_params(torch.Generator().manual_seed(2),
                                          cfg))
    batch = shard_batch(global_inputs(2, batch=2), "cpu")
    from vap_realtime_tpu_torch.train.step import compute_loss

    a = loss_fn(model, batch, cfg, None)[0]
    b = compute_loss(model.params, batch, cfg)[0]
    assert float(a) == float(b)


def test_trainer_cli_trains_across_two_processes(tmp_path):
    """`python -m vap_realtime_tpu_torch.train.trainer` in two gloo
    processes (--dist_address / --world_size / --rank): one epoch of two
    global batches of 2, each rank on one clip; rank 0 writes the
    checkpoints, the frozen encoder leaves stay as `fit` drew them, the
    trainable ones moved."""
    from vap_realtime_tpu_torch.train.data import synthetic_manifest
    from vap_realtime_tpu_torch.train.trainer import load_train_state
    from vap_realtime_tpu_torch.weights.convert import _flatten

    path = synthetic_manifest(str(tmp_path), n_rows=4, duration=2.0)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    run = tmp_path / "run"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vap_realtime_tpu_torch.train.trainer",
         "--data_train_path", path, "--data_val_path", path,
         "--data_batch_size", "2", "--data_audio_duration", "2",
         "--vap_frame_hz", "20", "--vap_cross_layers", "1",
         "--opt_max_epochs", "1", "--ckpt_dir", str(run), "--device", "cpu",
         "--dist_address", f"tcp://localhost:{port}", "--world_size", "2",
         "--rank", str(i)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert all("epoch 0: train_loss=" in log for log in logs)
    params, opt, _, meta = load_train_state(str(run / "last.npz"))
    assert meta["epoch"] == 0 and len(opt) == 38
    cfg = VapConfig(frame_hz=20, cross_layers=1)
    start = _flatten(params_to_numpy(init_vap_params(
        torch.Generator().manual_seed(0), cfg)))
    got = _flatten(params)
    for k in start:
        if k.startswith(("encoder/conv", "encoder/norm", "encoder/lstm")):
            np.testing.assert_array_equal(got[k], start[k], err_msg=k)
    assert np.abs(got["vap_head/w"] - start["vap_head/w"]).max() > 1e-4
    assert len([f for f in os.listdir(run) if f.startswith("vap_epoch")]) \
        == 1
