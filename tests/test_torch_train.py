"""The port's training path against the JAX package's, on the CPU.

- the whole-waveform forward (`encode_sequence`, its truncated form,
  `forward_waveform`, the heads of every mode) at 1e-5 in float32;
- dropout where JAX puts it (a deterministic mask patched into both
  packages' `_dropout`, in call order);
- the loss terms of every mode, and the trainable leaves' gradients
  against `jax.grad` (1e-5 abs + 1e-4 rel, and 1e-4 of each leaf's
  largest gradient);
- AdamW steps against a CORRECTED JAX reference: the JAX `loss_fn` with
  `optax.multi_transform` (AdamW on the leaves `freeze_encoder_mask`
  marks trainable, `set_to_zero` on the rest).  The JAX package's own
  `optax.masked` freeze adds the raw gradient to the frozen leaves
  (ROADMAP Queue 3); a test pins that fault.  The optimiser alone, fed
  the JAX gradients, equals the reference on every element at 1e-6
  (1 step) / 1e-5 (3 steps); end to end (each side on its own
  gradients) on every element whose first gradient is at least 100x
  Adam's eps.  Below that, Adam's first update g / (|g| + eps) turns a
  float32 rounding difference of the gradient into up to lr / (4 eps)
  times as much, ~1e-5 on these inputs: a property of Adam, not of
  either package.  The frozen leaves stay bit-equal;
- `fit` (exact resume), `run_evaluation` and both CLIs, checkpoints
  across the two packages, and the CUDA default of every entry point.
"""

import csv
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vap_realtime_tpu.config import VapConfig as JaxConfig
from vap_realtime_tpu.models import encoder as jenc
from vap_realtime_tpu.models import transformer as jtf
from vap_realtime_tpu.models import vap as jvap
from vap_realtime_tpu.train import step as jstep
from vap_realtime_tpu.train import trainer as jtrainer
from vap_realtime_tpu.weights.convert import save_pytree_npz as jsave
from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models import encoder as tenc
from vap_realtime_tpu_torch.models import transformer as ttf
from vap_realtime_tpu_torch.models import vap as tvap
from vap_realtime_tpu_torch.train import step as tstep
from vap_realtime_tpu_torch.train import trainer as ttrainer
from vap_realtime_tpu_torch.train.data import (
    DataConfig, load_manifest, synthetic_manifest, vad_list_to_onehot,
)
from vap_realtime_tpu_torch.train.events import EventConfig, TurnTakingEvents
from vap_realtime_tpu_torch.weights.convert import (
    _flatten, params_to_numpy, params_to_torch, tree_items,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, EPS = 3.63e-4, 1e-8
KW = dict(frame_hz=20, cross_layers=1)   # one stereo layer, full width


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs six
    workers at once, and the CPU LSTM scan's small ops slow down many
    times over when each worker spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=1, seconds=3, batch=2):
    rs = np.random.RandomState(seed)
    n_vad = seconds * 20 + 40                 # audio frames + 2 s horizon
    return {"waveform": (0.1 * rs.randn(batch, 2, 16000 * seconds)
                         ).astype(np.float32),
            "vad": (rs.rand(batch, n_vad, 2) > 0.5).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def p0():
    return _np(jvap.init_vap_params(jax.random.PRNGKey(0),
                                    JaxConfig(**KW)))


@pytest.fixture(scope="module")
def steps(p0):
    """Three steps, dropout off, on the JAX side (corrected reference,
    jitted) and on the port's; params after 1 and 3 steps, the JAX
    gradients of every step, the port's first gradients, both losses."""
    jc, tc = JaxConfig(**KW), VapConfig(**KW)
    batch = _batch()
    labels = jax.tree_util.tree_map(lambda m: "train" if m else "freeze",
                                    jstep.freeze_encoder_mask(p0))
    tx = optax.multi_transform(
        {"train": optax.adamw(LR, b1=0.9, b2=0.999, weight_decay=1e-3),
         "freeze": optax.set_to_zero()}, labels)

    @jax.jit
    def ref_step(p, s):
        (loss, _), g = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)(
            p, batch, jc, None)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g

    out = {"jax": {}, "port": {}, "fed": {}, "jax_grads": [],
           "jax_loss": [], "port_loss": []}
    jp, js = p0, tx.init(p0)
    port = params_to_torch(p0)
    fed = params_to_torch(p0)      # the port's AdamW fed the JAX gradients
    opt, opt_fed = tstep.make_optimizer(port), tstep.make_optimizer(fed)
    tb = _torch_batch(batch)
    for i in range(1, 4):
        jp, js, jl, jg = ref_step(jp, js)
        jg = _flatten(_np(jg))
        out["jax_grads"].append(jg)
        out["jax_loss"].append(float(jl))
        opt.zero_grad()
        loss, _ = tstep.compute_loss(port, tb, tc)
        loss.backward()
        if i == 1:
            out["port_grads"] = {n: t.grad.numpy().copy()
                                 for n, t in tree_items(port)
                                 if t.grad is not None}
        opt.step()
        out["port_loss"].append(float(loss.detach()))
        for n, t in tree_items(fed):
            if t.requires_grad:
                t.grad = torch.from_numpy(jg[n].copy())
        opt_fed.step()
        if i in (1, 3):
            out["jax"][i] = _flatten(_np(jp))
            out["port"][i] = _flatten(params_to_numpy(port))
            out["fed"][i] = _flatten(params_to_numpy(fed))
    out["port_tree"] = port
    return out


# --- the whole-waveform forward ------------------------------------------

def test_encode_sequence_matches_jax(p0):
    wav = _batch(seconds=1)["waveform"].reshape(4, -1)
    want = np.asarray(jenc.encode_sequence(p0["encoder"], wav, 5))
    got = tenc.encode_sequence(params_to_torch(p0["encoder"]),
                               torch.from_numpy(wav), 5)
    assert got.shape == want.shape == (4, 19, 256)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_encode_sequence_limited_matches_jax(p0):
    wav = _batch(seed=2, seconds=1)["waveform"][:, 0]
    want = np.asarray(jenc.encode_sequence_limited(p0["encoder"], wav, 5,
                                                   0.3))
    got = tenc.encode_sequence_limited(params_to_torch(p0["encoder"]),
                                       torch.from_numpy(wav), 5, 0.3,
                                       max_rows=7)
    assert got.shape == want.shape == (2, 19, 256)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


MODES = {"vap": {}, "bc": dict(mode="bc"), "nod": dict(mode="nod"),
         "lid1": dict(lid_classify=1), "lid2": dict(lid_classify=2),
         "stereo_tap": dict(vad_tap="stereo")}


@pytest.mark.parametrize("mode", ["vap", "bc", "nod", "lid1", "lid2"])
def test_forward_waveform_matches_jax(p0, mode):
    """Every head of the mode from whole waveforms, no generator."""
    jc, tc = JaxConfig(**KW, **MODES[mode]), VapConfig(**KW, **MODES[mode])
    params = (p0 if mode == "vap" else
              _np(jvap.init_vap_params(jax.random.PRNGKey(3), jc)))
    batch = _batch(seed=3, seconds=1)
    want = jvap.forward_waveform(params, batch["waveform"], jc)
    got = tvap.forward_waveform(params_to_torch(params),
                                torch.from_numpy(batch["waveform"]), tc)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_init_tree_and_heads_match_jax(mode):
    """`init_vap_params` gives the JAX tree (names, shapes, dtypes, the
    init distributions); the heads of every mode on the same params and
    embeddings agree at 1e-5."""
    jc, tc = JaxConfig(**KW, **MODES[mode]), VapConfig(**KW, **MODES[mode])
    jp = _np(jvap.init_vap_params(jax.random.PRNGKey(4), jc))
    tp = tvap.init_vap_params(torch.Generator().manual_seed(4), tc)
    jf, tf = _flatten(jp), dict(tree_items(tp))
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape and tf[k].dtype == \
            torch.float32, k
    w = tf["encoder/lstm/w_hh"]
    assert 0.9 / 16 < float(w.abs().max()) <= 1 / 16
    assert abs(float(tf["ar/layers/0#/ffn/w1"].std()) - 0.02) < 1e-3
    assert float(tf["vap_head/b"].abs().max()) == 0.0
    rs = np.random.RandomState(5)
    e1, e2 = (rs.randn(2, 12, 256).astype(np.float32) for _ in range(2))
    want = jvap.forward_context(jp, e1, e2, jc)
    got = tvap.forward_context(params_to_torch(jp), torch.from_numpy(e1),
                               torch.from_numpy(e2), tc)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_dropout_sits_where_jax_puts_it(p0, monkeypatch):
    """Both packages' `_dropout` replaced by one deterministic mask per
    call, drawn in call order from the same numpy stream: the trunk
    outputs agree at 1e-5, with the same number of calls, and differ
    from the dropout-free trunk."""

    def patched(calls):
        rs = np.random.RandomState(11)

        def drop(x, rate, rng):
            if rng is None or rate <= 0.0:
                return x
            calls.append(tuple(x.shape))
            mask = rs.rand(*x.shape) < 1.0 - rate
            if isinstance(x, torch.Tensor):
                return torch.where(torch.from_numpy(mask), x / (1 - rate),
                                   0.0)
            return jnp.where(mask, x / (1.0 - rate), 0.0)
        return drop

    jcalls, tcalls = [], []
    monkeypatch.setattr(jtf, "_dropout", patched(jcalls))
    monkeypatch.setattr(ttf, "_dropout", patched(tcalls))
    rs = np.random.RandomState(6)
    e1, e2 = (rs.randn(2, 10, 256).astype(np.float32) for _ in range(2))
    cfg_kw = dict(KW, dropout=0.3)
    want = jvap.trunk_forward(p0, e1, e2, JaxConfig(**cfg_kw),
                              jax.random.PRNGKey(0))
    got = tvap.trunk_forward(params_to_torch(p0), torch.from_numpy(e1),
                             torch.from_numpy(e2), VapConfig(**cfg_kw),
                             torch.Generator().manual_seed(0))
    assert jcalls == tcalls and len(tcalls) == 2 * 5 + 2 * 8
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    plain = tvap.trunk_forward(params_to_torch(p0), torch.from_numpy(e1),
                               torch.from_numpy(e2), VapConfig(**cfg_kw))
    assert float((plain["x"] - got["x"]).abs().max()) > 1e-2


def test_dropout_streams_follow_the_generator(p0):
    """Same generator seed, same masks; another seed, other masks; no
    generator, the inference trunk."""
    cfg = VapConfig(**KW)
    p = params_to_torch(p0)
    e = torch.randn(2, 8, 256, generator=torch.Generator().manual_seed(1))
    run = lambda g: tvap.trunk_forward(p, e, e.flip(0), cfg, g)["x"]
    a, b = (run(torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, run(torch.Generator().manual_seed(6)))
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    child = ttf.fold_in(g, 3)
    assert torch.equal(g.get_state(), state)
    assert child.initial_seed() != g.initial_seed()
    assert ttf.fold_in(None, 3) is None


# --- losses and gradients --------------------------------------------------

@pytest.mark.parametrize("mode", ["vap", "bc", "nod", "lid1", "lid2"])
def test_loss_terms_match_jax_compute_loss(mode, monkeypatch):
    """The loss wiring of every mode on the SAME head outputs (the JAX
    forward replaced by these outputs): loss and terms at 1e-6.  For lid
    2 the JAX step reads a key no head writes (KeyError); the port's
    term is the JAX objective's loss_lid on "lid_logits"."""
    rs = np.random.RandomState(7)
    B, Tn = 2, 20
    outs = {"logits": rs.randn(B, Tn, 256), "vad1": rs.randn(B, Tn, 1),
            "vad2": rs.randn(B, Tn, 1), "bc_logits": rs.randn(B, Tn, 3),
            "nod_logits": rs.randn(B, Tn, 4),
            "lid_logits": rs.randn(B, Tn, 3)}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    batch = {"waveform": np.zeros((B, 2, 10), np.float32),
             "vad": (rs.rand(B, Tn + 40, 2) > 0.5).astype(np.float32),
             "bc_class": rs.randint(0, 3, (B, Tn)),
             "nod_class": rs.randint(0, 4, (B, Tn)),
             "bc_frame": (rs.rand(B, Tn + 40) > 0.7).astype(np.float32),
             "lid_class": rs.randint(0, 3, (B, Tn))}
    kw = {"vap": {}, "bc": dict(mode="bc"), "nod": dict(mode="nod"),
          "lid1": dict(lid_classify=1), "lid2": dict(lid_classify=2)}[mode]
    if mode == "nod":
        outs["bc_logits"] = outs["bc_logits"][..., :1]
    jc, tc = JaxConfig(**KW, **kw), VapConfig(**KW, **kw)
    got, gm = tstep.loss_from_outputs(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        _torch_batch(batch), tc)
    monkeypatch.setattr(jstep, "forward_waveform",
                        lambda *a, **k: {k2: jnp.asarray(v)
                                         for k2, v in outs.items()})
    if mode == "lid2":
        with pytest.raises(KeyError, match="lid_middle_logits"):
            jstep.compute_loss(None, batch, jc)
        base, jm = jstep.compute_loss(None, {k: batch[k] for k in
                                             ("waveform", "vad")}, jc)
        lid = jvap.obj.loss_lid(outs["lid_logits"], batch["lid_class"])
        want, jm = base + lid, dict(jm, loss_lid=lid, loss=base + lid)
    else:
        want, jm = jstep.compute_loss(None, batch, jc)
    assert gm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(gm[k]), float(jm[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert len(gm) == {"vap": 3, "bc": 4, "nod": 5, "lid1": 4,
                       "lid2": 4}[mode]


def test_gradients_match_jax_grad(steps):
    """The trainable leaves' gradients at the first step: 1e-5 abs +
    1e-4 rel per element, and within 1e-4 of each leaf's largest
    gradient (the attention's q / k gradients are ~1e-6 at init, far
    below the 1e-5 abs)."""
    jg, tg = steps["jax_grads"][0], steps["port_grads"]
    mask = dict(tree_items(jstep.freeze_encoder_mask(
        jax.tree_util.tree_map(lambda x: 0, _np(
            jvap.init_vap_params(jax.random.PRNGKey(0), JaxConfig(**KW)))))))
    assert sorted(tg) == sorted(k for k, m in mask.items() if m)
    for k, g in tg.items():
        np.testing.assert_allclose(g, jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert np.abs(g - jg[k]).max() <= 1e-4 * np.abs(jg[k]).max(), k
    np.testing.assert_allclose(steps["port_loss"][0], steps["jax_loss"][0],
                               rtol=1e-6)


@pytest.mark.parametrize("n", [1, 3])
def test_adamw_equals_corrected_reference_on_jax_gradients(steps, n):
    """The port's optimiser fed the JAX gradients: every element of every
    leaf equals the corrected optax reference (1e-6 after 1 step, 1e-5
    after 3); the frozen leaves stay bit-equal."""
    tol = {1: 1e-6, 3: 1e-5}[n]
    want, got = steps["jax"][n], steps["fed"][n]
    p0 = steps["jax"][1]
    for k in want:
        if k.startswith("encoder/") and not k.startswith("encoder/down"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert p0.keys() == want.keys()


@pytest.mark.parametrize("n", [1, 3])
def test_train_steps_match_corrected_reference(steps, p0, n):
    """End to end, each side on its own gradients: 1e-6 after 1 step,
    1e-5 after 3, on every element whose first gradient is at least
    100x Adam's eps; every element within two steps' size (Adam's
    update is at most about lr); losses at 1e-5 rel; the frozen leaves
    bit-equal to the start on both sides."""
    tol = {1: 1e-6, 3: 1e-5}[n]
    want, got, g1 = steps["jax"][n], steps["port"][n], steps["jax_grads"][0]
    start = _flatten(p0)
    n_cond = n_all = 0
    d_all = 0.0
    for k in want:
        if k not in g1 or not (k.startswith(("ar", "vap_head", "va_"))
                               or k.startswith("encoder/down")):
            np.testing.assert_array_equal(got[k], start[k], err_msg=k)
            continue
        cond = np.abs(g1[k]) >= 100 * EPS
        n_cond += int(cond.sum())
        n_all += cond.size
        np.testing.assert_allclose(got[k][cond], want[k][cond], rtol=0,
                                   atol=tol, err_msg=k)
        d_all = max(d_all, float(np.abs(got[k] - want[k]).max()))
        assert d_all <= 2 * LR, k
    print(f"after {n} step(s): {n_cond} of {n_all} trainable elements "
          f"with |g| >= 1e-6; max |d| over all {d_all:.3g}")
    assert n_cond > 0.8 * n_all
    np.testing.assert_allclose(steps["port_loss"][:n], steps["jax_loss"][:n],
                               rtol=1e-5)


def test_frozen_encoder_stays_bit_equal_and_off_the_optimizer(steps, p0):
    port = steps["port_tree"]
    start = _flatten(p0)
    for name, leaf in tree_items(port["encoder"]):
        frozen = not name.startswith("down")
        assert leaf.requires_grad == (not frozen), name
        if frozen:
            assert leaf.grad is None, name
            np.testing.assert_array_equal(leaf.detach().numpy(),
                                          start["encoder/" + name])
    opt = tstep.make_optimizer(params_to_torch(p0))
    n_opt = sum(p.numel() for g in opt.param_groups for p in g["params"])
    n_train = sum(v.size for k, v in start.items()
                  if not re.match(r"encoder/(conv|norm|lstm)", k))
    assert n_opt == n_train
    assert opt.defaults["lr"] == LR and opt.defaults["eps"] == EPS
    assert opt.defaults["weight_decay"] == 1e-3


def test_jax_masked_freeze_adds_the_gradient_to_frozen_leaves(p0):
    """The fault the port does not copy (ROADMAP Queue 3): one step of
    the JAX package's own `make_train_step` (`optax.masked` AdamW) moves
    `encoder.conv0` by exactly its gradient (same rng), at 1e-6, and the
    LSTM likewise, far more than the lr-sized steps of the trainable
    leaves."""
    jc = JaxConfig(**KW)
    batch = _batch(seed=8, seconds=1)
    rng = jax.random.PRNGKey(1)
    params = jax.tree_util.tree_map(jnp.array, p0)
    tx = jtrainer.make_tx(params, jtrainer.OptConfig())
    grads = jax.jit(jax.grad(
        lambda p: jtrainer.loss_fn(p, batch, jc, rng)[0]))(params)
    new, _, _ = jtrainer.make_train_step(tx, jc)(
        jax.tree_util.tree_map(jnp.array, p0), tx.init(params), batch, rng)
    for leaf in ("conv0", "lstm"):
        moved = _flatten(_np(new["encoder"][leaf]))
        start, g = _flatten(p0["encoder"][leaf]), _flatten(
            _np(grads["encoder"][leaf]))
        for k in moved:
            np.testing.assert_allclose(moved[k] - start[k], g[k], rtol=0,
                                       atol=1e-6, err_msg=f"{leaf}/{k}")
    size = lambda *path: max(
        np.abs(a - b).max() for a, b in zip(
            jax.tree_util.tree_leaves(_np(new[path[0]][path[1]] if
                                          len(path) == 2 else new[path[0]])),
            jax.tree_util.tree_leaves(p0[path[0]][path[1]] if len(path) == 2
                                      else p0[path[0]])))
    d_conv0, d_lstm, d_head = (size("encoder", "conv0"),
                               size("encoder", "lstm"), size("vap_head"))
    print(f"one JAX step moved conv0 by {d_conv0:.3g}, the LSTM by "
          f"{d_lstm:.3g}, vap_head by {d_head:.3g} (lr {LR})")
    assert min(d_conv0, d_lstm) > 10 * d_head and d_head <= 1.01 * LR


# --- the trainer, evaluation, checkpoints, entry points --------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    path = synthetic_manifest(str(d), n_rows=4, duration=3.0)
    return d, path, DataConfig(train_path=path, val_path=path, batch_size=2,
                               audio_duration=3.0, frame_hz=20)


def test_fit_resume_equals_uninterrupted(data):
    """fit 1 epoch, then resume from `last.npz` for 1 more == a 2-epoch
    run (dropout on): params at 1e-7, the same train loss."""
    d, _, dc = data
    cfg = VapConfig(**KW, context_len_sec=2.5)
    quiet = lambda m: None
    h2 = ttrainer.fit(cfg, dc, ttrainer.OptConfig(max_epochs=2, seed=3),
                      ckpt_dir=str(d / "full"), device="cpu", log_fn=quiet)
    ttrainer.fit(cfg, dc, ttrainer.OptConfig(max_epochs=1, seed=3),
                 ckpt_dir=str(d / "a"), device="cpu", log_fn=quiet)
    last = str(d / "a" / "last.npz")
    assert ttrainer.is_full_train_state(last)
    hr = ttrainer.fit(cfg, dc, ttrainer.OptConfig(max_epochs=2, seed=3),
                      ckpt_dir=str(d / "b"), resume_from=last, device="cpu",
                      log_fn=quiet)
    assert hr["epoch"] == h2["epoch"] == 1
    a, b = _flatten(h2["params"]), _flatten(hr["params"])
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-7, err_msg=k)
    assert hr["train_loss"] == h2["train_loss"]
    _, opt, rng, meta = ttrainer.load_train_state(last)
    assert meta == {"epoch": 0, "lr": 3.63e-4, "best_val": meta["best_val"],
                    "plateau": 0, "early": 0}
    assert len(opt) == 4 + 10 + 16 + 4 + 4 and rng.dtype == np.uint8


def test_plateau_decay_and_early_stop(data):
    """A run whose validation never improves (lr 0): the lr halves after
    `patience` + 1 epochs without a gain, and early stopping ends it."""
    d, _, dc = data
    logs = []
    h = ttrainer.fit(VapConfig(**KW), dc,
                     ttrainer.OptConfig(max_epochs=9, learning_rate=0.0,
                                        lr_scheduler_patience=1,
                                        early_stopping_patience=2),
                     ckpt_dir=str(d / "plateau"), device="cpu",
                     log_fn=logs.append)
    assert h["epoch"] == 2 and "[early stop]" in logs[-1]
    assert "[lr -> 0.00e+00]" in logs[-1]
    assert len([f for f in os.listdir(d / "plateau")
                if f.startswith("vap_epoch")]) == 1


def turn_taking_vad(duration: float, offset: float):
    """A 7.8 s cycle, started `offset` s before 0: A speaks, pauses 0.4 s
    and goes on (a hold), B takes the turn (a shift), A backchannels 0.3 s
    into B's turn, and B hands the turn back (a shift)."""
    segs, c = [[], []], -offset
    while c < duration + 2.0:
        for ch, a, b in ((0, 0.0, 1.5), (0, 1.9, 3.4), (1, 3.8, 7.4),
                         (0, 5.0, 5.3)):
            if c + b > 0:
                segs[ch].append([round(max(c + a, 0.0), 2), round(c + b, 2)])
        c += 7.8
    return segs


def turn_taking_manifest(tmpdir: str, n_rows: int, duration: float) -> str:
    """`synthetic_manifest` with each row's VAD from `turn_taking_vad`,
    offset so that in a 3 s clip row 0 holds, rows 1 and 3 shift and row
    2 backchannels."""
    path = synthetic_manifest(tmpdir, n_rows=n_rows, duration=duration)
    with open(path) as f:
        rows = list(csv.reader(f))
    for i, row in enumerate(rows[1:]):
        row[3] = json.dumps(turn_taking_vad(duration,
                                            (0.0, 2.0, 3.4, 6.0)[i % 4]))
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def test_fit_evaluate_and_cross_package_checkpoints(data, p0, tmp_path):
    """The port trains 2 epochs (with events); its best checkpoint goes
    through the JAX package's `run_evaluation` and the port's on a
    manifest whose VAD gives shift, hold and backchannel events: every
    metric equal at rtol 1e-5 (the loss, and the turn-taking metrics); a
    checkpoint the JAX package wrote goes through the port's
    `run_evaluation` CLI."""
    from vap_realtime_tpu.train.data import DataConfig as JaxData
    from vap_realtime_tpu.train.evaluation import (
        run_evaluation as jax_eval,
    )
    from vap_realtime_tpu.train.events import EventConfig as JaxEvents
    from vap_realtime_tpu_torch.train import evaluation as tev

    d, path, dc = data
    ev = dict(frame_hz=20, max_time=3.0, min_context_time=0.5)
    cfg = VapConfig(**KW, context_len_sec=2.5)
    logs = []
    hist = ttrainer.fit(cfg, dc, ttrainer.OptConfig(max_epochs=2,
                                                    learning_rate=1e-3),
                        EventConfig(**ev), ckpt_dir=str(d / "run"),
                        device="cpu", log_fn=logs.append)
    assert np.isfinite(hist["train_loss"]) and hist["train_loss"] < 7.0
    assert "val_loss" in logs[-1]
    ckpt = ttrainer.find_best_checkpoint(str(d / "run"))
    assert ckpt is not None and "val_" in ckpt

    tt_path = turn_taking_manifest(str(tmp_path), 4, 3.0)
    test_dc = DataConfig(test_path=tt_path, batch_size=2, audio_duration=3.0,
                         frame_hz=20)
    vad = np.stack([vad_list_to_onehot(r["vad_list"], 3.0 + test_dc.horizon,
                                       20) for r in load_manifest(tt_path)])
    events = TurnTakingEvents(EventConfig(**ev))(vad)
    for kind in ("shift", "hold", "pred_backchannel"):
        assert sum(map(len, events[kind])) > 0, kind
    ours = tev.run_evaluation(ckpt, cfg, test_dc, EventConfig(**ev),
                              out_root=str(tmp_path / "port"), device="cpu")
    theirs = jax_eval(ckpt, JaxConfig(**KW, context_len_sec=2.5),
                      JaxData(test_path=tt_path, batch_size=2,
                              audio_duration=3.0, frame_hz=20),
                      JaxEvents(**ev), out_root=str(tmp_path / "jax"))
    read = lambda p: {r["metric"]: float(r["value"])
                      for r in csv.DictReader(open(p))}
    a, b = read(ours), read(theirs)
    assert a.keys() == b.keys() and "test_loss" in a and len(a) == 19
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)

    jax_ckpt = str(tmp_path / "jax_vap_epoch0-val_1.00000.npz")
    jsave(jax_ckpt, p0)
    # the CLI keeps the reference's event config (3 s of context before an
    # event), so 3 s clips give the loss alone
    out = tev.main(["--checkpoint", jax_ckpt, "--data_test_path", tt_path,
                    "--data_batch_size", "2", "--data_audio_duration", "3",
                    "--vap_frame_hz", "20", "--vap_cross_layers", "1",
                    "--out_root", str(tmp_path / "cli"), "--device", "cpu"])
    c = read(out)
    assert set(c) == {"test_loss"} and np.isfinite(c["test_loss"])


def test_trainer_cli_on_the_cpu(data, tmp_path):
    _, path, _ = data
    run = tmp_path / "cli_run"
    ttrainer.main(["--data_train_path", path, "--data_val_path", path,
                   "--data_batch_size", "2", "--data_audio_duration", "3",
                   "--vap_frame_hz", "20", "--vap_cross_layers", "1",
                   "--opt_max_epochs", "1", "--ckpt_dir", str(run),
                   "--augment", "--device", "cpu"])
    assert (run / "last.npz").exists()
    assert ttrainer.find_best_checkpoint(str(run)) is not None


def test_augmented_step_keeps_the_encoder_frozen(p0):
    cfg = VapConfig(**KW)
    model = tvap.VapModel(cfg, p0)
    tx = ttrainer.make_tx(model, ttrainer.OptConfig())
    step = ttrainer.make_train_step(tx, cfg, augment=True)
    b = _torch_batch(_batch(seed=9, seconds=1))
    for seed in range(3):
        m = step(model, b, torch.Generator().manual_seed(seed))
        assert np.isfinite(float(m["loss"]))
    after = dict(tree_items(params_to_numpy(model.params)))
    start = _flatten(p0)
    for k in ("encoder/conv0/w", "encoder/norm3/b", "encoder/lstm/w_hh"):
        np.testing.assert_array_equal(after[k], start[k])
    assert np.abs(after["vap_head/w"] - start["vap_head/w"]).max() > 0


def test_entry_points_default_to_cuda(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from vap_realtime_tpu_torch.train import evaluation as tev

    _, path, dc = data
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.fit(VapConfig(**KW), dc, ttrainer.OptConfig(max_epochs=1),
                     ckpt_dir=str(tmp_path / "x"), log_fn=lambda m: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.main(["--data_train_path", path, "--opt_max_epochs", "1",
                       "--ckpt_dir", str(tmp_path / "y")])
    ckpt = str(tmp_path / "p.npz")
    jsave(ckpt, {"a": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        tev.run_evaluation(ckpt, VapConfig(), dc, EventConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tev.main(["--checkpoint", ckpt, "--data_test_path", path])


def test_training_modules_import_neither_jax_nor_optax():
    pkg = os.path.join(REPO, "vap_realtime_tpu_torch")
    mods = ["models/objective.py", "models/encoder.py", "models/vap.py",
            "models/transformer.py", "utils/vad.py", "parallel/mesh.py",
            "parallel/distributed.py", "parallel/worker.py"] + [
        f"train/{m}.py" for m in ("data", "events", "metrics", "step",
                                  "trainer", "evaluation", "transforms")]
    bad = re.compile(r"^\s*(import|from)\s+(jax|optax|vap_realtime_tpu)\b",
                     re.MULTILINE)
    for m in mods:
        with open(os.path.join(pkg, m)) as f:
            assert not bad.search(f.read()), m
