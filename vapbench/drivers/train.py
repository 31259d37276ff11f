"""Fine-tuning: the port's train step (`train/trainer.py` `make_train_step`:
AdamW over the trainable leaves, the encoder frozen, dropout on) on
batches of stereo clips with VAD labels, steps back to back with one in
flight behind the one being dispatched (as `fit` runs them, without its
loader: a small pool of seeded batches lives on the device).

Set-up builds the one model and optimiser that the window drives and
runs its first three steps through the same call on three different
batches; those are what the check follows: each step's loss, the first
gradient as AdamW holds it after one step (exp_avg / (1 - beta1)), and
each trainable leaf's change after the three.  After the window, the
frozen encoder must still equal the weights it started from, bit for
bit."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from vapbench.audio import train_batches
from vapbench.common import sub_seed
from vapbench.counts.model import _conv_frames
from vapbench.drivers.closed import quarter_rates
from vapbench.serving import vap_config
from vapbench.weights import make_params, tree_leaves

CHECKED = 3


def step_generator(seed: int, i: int, device):
    import torch

    return torch.Generator(device=device).manual_seed(sub_seed(seed, 6, i))


def setup(ctx) -> Dict:
    """The model, optimiser and step the window drives, the batch pool,
    and the first CHECKED steps through that step: what the check
    follows (losses, the first gradient, the weights after them)."""
    import torch

    from vap_realtime_tpu_torch.models.vap import VapModel
    from vap_realtime_tpu_torch.train.trainer import (
        OptConfig, make_train_step, make_tx,
    )

    wl, cfg, seed = ctx["workload"], ctx["config"], ctx["seed"]
    model = cfg["model"]
    tr = wl["train"]
    device = torch.device(ctx["device"])
    batch = int(ctx.get("batch") or tr["batch"])
    clip_s = float(ctx.get("clip_seconds") or tr["clip_seconds"])
    # the configuration trains in float32 with TF32 off; the control is
    # the same program with TF32 on
    tf32 = ctx.get("control") == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    vcfg = vap_config(model)
    t = time.perf_counter()
    params = make_params(model, seed, device, torch.float32)
    batches = train_batches(wl["audio"], tr["pool_batches"], batch, clip_s,
                            vcfg.frame_hz, tr["horizon_s"],
                            sub_seed(seed, 5), device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks = {"inputs_s": time.perf_counter() - t}
    net = VapModel(vcfg, params=params, device=device, dtype=torch.float32)
    hp = cfg["training"]
    opt = OptConfig(learning_rate=hp["learning_rate"],
                    weight_decay=hp["weight_decay"],
                    betas=tuple(hp["betas"]))
    tx = make_tx(net, opt)
    step = make_train_step(tx, vcfg)
    fault = ctx.get("fault")
    if fault is not None:        # tests: break the timed path
        step = fault(step, net)
    trained = {n: p for n, p in net.leaves.items() if p.requires_grad}
    losses = []
    grad1 = None
    for i in range(CHECKED):
        m = step(net, batches[i % len(batches)],
                 step_generator(seed, i, device))
        losses.append(float(m["loss"]))
        if i == 0:
            b1 = opt.betas[0]
            grad1 = {n: (tx.state[p]["exp_avg"] / (1 - b1)).double().clone()
                     if p in tx.state else torch.zeros_like(p).double()
                     for n, p in trained.items()}
    after = {n: p.detach().double().clone() for n, p in trained.items()}
    marks["model_and_checked_steps_s"] = (time.perf_counter() - t
                                          - marks["inputs_s"])
    return {"marks": marks, "net": net, "tx": tx, "step": step,
            "batches": batches, "params": params, "losses": losses,
            "grad1": grad1, "after": after, "device": device,
            "batch": batch, "clip_s": clip_s, "model": model}


def run(ctx):
    import torch

    wl, seed = ctx["workload"], ctx["seed"]
    hp = ctx["config"]["training"]
    st = setup(ctx)
    net, step, batches = st["net"], st["step"], st["batches"]
    device, batch, clip_s = st["device"], st["batch"], st["clip_s"]
    model, params = st["model"], st["params"]
    cuda = device.type == "cuda"
    nb = len(batches)

    prof, p0, p1 = None, -1, -1
    if ctx["trace"]:
        from vapbench.trace import Profile, layer_spans

        ctx["stack"].enter_context(layer_spans())
        prof = Profile(cpu=wl["trace"].get("host_ops", True))
        prof.warm()
        p0 = wl["trace"]["start"]
        p1 = p0 + wl["trace"]["steps"]
    setup_s = time.time() - ctx["t_proc"]

    spans = {"step": []}
    ends = []
    starts = []
    t0 = time.perf_counter()
    end = t0 + ctx["seconds"]
    prev = None
    k = 0
    done = t0
    while True:
        stop = time.perf_counter() >= end
        if not stop:
            if prof is not None and k == p0:
                prof.start()
            with torch.profiler.record_function("vapbench.step"):
                starts.append(time.perf_counter())
                step(net, batches[(CHECKED + k) % nb],
                     step_generator(seed, CHECKED + k, device))
                ev = torch.cuda.Event() if cuda else None
                if ev is not None:
                    ev.record()
        if prev is not None:
            with torch.profiler.record_function("vapbench.wait"):
                if prev is not True:
                    prev.synchronize()
            done = time.perf_counter()
            ends.append(done)
            j = k - 1
            if not p0 <= j < p1:
                spans["step"].append((starts[j], done))
            if prof is not None and j == p1 - 1:
                prof.stop()
        if stop:
            break
        prev = ev if ev is not None else True
        k += 1
    K = k
    window = done - t0
    losses, grad1, after = st["losses"], st["grad1"], st["after"]
    marks = st["marks"]
    if prof is not None and K < p1:
        raise SystemExit(f"the window ran {K} steps, fewer than the traced "
                         f"stretch's end {p1}")
    e2e = {"train_audio_s_per_s": K * batch * clip_s / window,
           "setup_s": setup_s}
    mem = int(torch.cuda.max_memory_allocated()) if cuda else 0
    summary = prof.summary() if prof is not None else None

    start = dict(tree_leaves(params))
    frozen_changed = sum(
        int(not np.array_equal(p.detach().cpu().numpy(), start[n]))
        for n, p in net.leaves.items() if not p.requires_grad)
    finite = all(bool(torch.isfinite(p).all()) for p in net.leaves.values())
    st.clear()
    del net, step
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    chk = check(params, model, hp, batches[:CHECKED], seed, device,
                losses, grad1, after)
    chk["frozen_changed"] = frozen_changed
    lim = wl["check"]["limits"]
    checks = {k: (chk[k], lim[k]) for k in lim}
    T_lstm = _conv_frames(int(clip_s * 16000))[-1] - 2
    reader = {"model": model, "batch": batch,
              "samples": int(clip_s * 16000), "lstm_steps": T_lstm,
              "host": spans, "summary": summary, "n_traced": p1 - p0,
              "tick_names": ("vapbench.step", "vapbench.wait"),
              "counters": prof.counters if prof is not None else {}}
    return {"e2e": e2e, "attempted": K, "failed": 0 if finite else K,
            "checks": checks, "sound": finite,
            "memory_peak_bytes": mem,
            "info": {"steps": K, "window_s": window, "losses": losses,
                     "setup": marks,
                     "quarter_rates": quarter_rates(ends, t0,
                                                    batch * clip_s),
                     "check": chk},
            "reader": reader}


def check(params, model, opt, batches, seed, device, losses, grad1,
          after) -> Dict:
    """The float64 reference's three steps against the program's."""
    import torch

    from vapbench.reference.train import run_steps

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    gens = [step_generator(seed, i, device) for i in range(len(batches))]
    ref = run_steps(params, model, opt, batches, gens, device)
    start = {n: torch.as_tensor(a, dtype=torch.float64, device=device)
             for n, a in tree_leaves(params)}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"]))
    gn_ref = {n: float(g.norm()) for n, g in ref["grad1"].items()}
    gn_got = {n: float(grad1[n].norm()) for n in gn_ref}
    med = float(np.median(list(gn_ref.values())))
    grad_gap = max(abs(gn_got[n] - gn_ref[n]) / max(gn_ref[n], med)
                   for n in gn_ref)
    moved = [n for n in gn_ref if gn_ref[n] >= 1e-3 * med]
    dn_ref = {n: float(ref["delta"][n].norm()) for n in moved}
    dn_got = {n: float((after[n] - start[n]).norm()) for n in moved}
    dmed = float(np.median(list(dn_ref.values())))
    change_gap = max(abs(dn_got[n] - dn_ref[n]) / max(dn_ref[n], dmed)
                     for n in moved)
    worst = max(moved, key=lambda n: abs(dn_got[n] - dn_ref[n])
                / max(dn_ref[n], dmed))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "change_worst_leaf": worst,
            "left_out": sorted(set(gn_ref) - set(moved)),
            "ref_losses": ref["loss"], "ref_s": time.perf_counter() - t}
