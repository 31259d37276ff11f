"""Component-level timing of the serving steps on the card.

Port of `tools/component_bench.py`.  It splits the kv and fast serving
steps (vap, 20 Hz, 2.5 s context, synthetic weights, bf16, B streams)
into their stages and times each with CUDA events over a chain of
`--iters` iterations after two warm-up iterations; every iteration's
input evolves from the previous one's output, and the chain's last
output is read, so no iteration can be skipped or hoisted.

    python -m vap_realtime_tpu_torch.tools.component_bench [--batch 4096]
        [--stages step,encoder,...] [--iters 24] [--device cpu]

Stages (the JAX tool's names; where a JAX name says `pallas` the port
says `kernel`, as `attend_impl` does: `trunk_pallas` -> `trunk_kernel`):

  step                 kv_step (chunked encoder + KV trunk, stream slots)
  encoder              encode_chunk (conv stack + LSTM + downsample)
  conv / conv_im2col   cpc_conv_stack; the same with each conv as unfold +
                       one matmul (`conv1d_im2col`)
  lstm / lstm5         the LSTM over a chunked (frame_samples) / fresh
                       (frame_shift) frame's 100 Hz features
  trunk                step - encoder (by difference)
  fast / fast_einsum / fast_q8
                       fast_step, global slots: the attend kernel; the
                       einsum attend; the kernel on the int8 row cache
  enc_stream           encode_chunk_streaming
  conv_stream / conv_stream_im2col / conv_stream_blocked
                       the streaming conv stack: PyTorch convs; unfold +
                       matmul; stride-block matmuls
  heads                heads_forward + probs_from_outputs
  trunk_kernel         _kv_core (global slots, the attend kernel) with its
                       row write; `trunk_einsum` the same with the einsum
                       attend
  trunk_nowrite / trunk_einsum_nowrite
                       trunk_kernel / trunk_einsum - cachewrite (by
                       difference: the JAX tool let XLA drop the write as
                       dead code; PyTorch drops nothing)
  cachewrite           the step's bare row write, cache[:, :, g % T] = rows
  cacheread            the cache-read floor: the whole bf16 cache read by
                       the K12 kernel (`cache_read_all`), GB/s
  hbm                  x *= c in place over a bf16 buffer of the cache's
                       size: the card's streaming read + write rate
  opchain              per-op cost of chained (B, 256) x (256, 256) bf16
                       matmuls (slope between 10 and 50 per iteration)
  mxu                  the tensor cores: chained (B, B) bf16 matmuls,
                       TFLOP/s
  trunk_fast           fast - enc_stream (by difference)

The default is the JAX tool's (its `all`): step, encoder, conv,
conv_im2col, lstm, trunk; here `all` runs every stage.  Stages measured
by difference run the stages they need.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.models.encoder import (
    CPC_CONV_SPECS, cpc_conv_stack, cpc_conv_stack_streaming,
    cpc_conv_stack_streaming_blocked, encode_chunk, encode_chunk_streaming,
    init_conv_stream_state,
)
from vap_realtime_tpu_torch.models.vap import heads_forward, probs_from_outputs
from vap_realtime_tpu_torch.ops.basic import channel_norm, lstm
from vap_realtime_tpu_torch.ops.cuda.lab import cache_read_all
from vap_realtime_tpu_torch.runtime import incremental as inc
from vap_realtime_tpu_torch.runtime.arena import resolve_device
from vap_realtime_tpu_torch.weights.convert import params_to_torch
from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

DEFAULT_STAGES = ("step", "encoder", "conv", "conv_im2col", "lstm", "trunk")
# stages measured by difference: (minuend, subtrahend)
DIFFERENCES = {"trunk": ("step", "encoder"),
               "trunk_fast": ("fast", "enc_stream"),
               "trunk_nowrite": ("trunk_kernel", "cachewrite"),
               "trunk_einsum_nowrite": ("trunk_einsum", "cachewrite")}
STAGES = ("step", "encoder", "conv", "conv_im2col", "lstm", "fast",
          "fast_einsum", "fast_q8", "enc_stream", "conv_stream",
          "conv_stream_im2col", "conv_stream_blocked", "lstm5", "heads",
          "trunk_kernel", "trunk_einsum", "cachewrite", "cacheread", "hbm",
          "opchain", "mxu") + tuple(DIFFERENCES)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def conv1d_im2col(x, w, b, stride: int, padding: int):
    """conv1d as patch extraction + ONE matmul: x (B, C_in, L), w (C_out,
    C_in, K), b (C_out,) -> (B, C_out, L_out).  The patches go
    channels-last, so the contraction is a (B * L_out, C_in * K) x
    (C_in * K, C_out) matmul (the JAX tool's `conv1d_im2col`)."""
    k = w.shape[-1]
    B, C, _ = x.shape
    patches = F.pad(x, (padding, padding)).unfold(-1, k, stride)
    pt = patches.permute(0, 2, 1, 3).reshape(B, -1, C * k)  # (B, L_out, CK)
    y = torch.matmul(pt, w.reshape(w.shape[0], -1).T).to(x.dtype) + b
    return y.transpose(1, 2)


def _leaf(x) -> Optional[torch.Tensor]:
    """A tensor of a carry (the last one of a tuple that holds one)."""
    if isinstance(x, torch.Tensor):
        return x
    items = (list(x.values()) if isinstance(x, dict)
             else list(x) if isinstance(x, (tuple, list)) else [])
    for item in reversed(items):
        t = _leaf(item)
        if t is not None:
            return t
    return None


def timed(body: Callable, carry, iters: int, device) -> float:
    """ms per iteration of carry = body(carry) (CUDA events on the card,
    the host clock on the CPU), after two warm-up iterations; the chain's
    last carry is read."""
    for _ in range(2):
        carry = body(carry)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            carry = body(carry)
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1) / iters
    else:
        t = time.perf_counter()
        for _ in range(iters):
            carry = body(carry)
        ms = (time.perf_counter() - t) * 1e3 / iters
    _leaf(carry).float().sum().item()
    return ms


def _evolve(x, out):
    """x nudged by the output: the next iteration depends on this one."""
    return x * 0.999 + 1e-4 * out.float().sum().to(x.dtype)


def main(argv: Optional[list] = None) -> Dict[str, float]:
    """Returns {stage: ms per iteration} (opchain: ms per op)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--stages", default=",".join(DEFAULT_STAGES),
                    help="comma list of " + ",".join(STAGES) + " or 'all'")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    asked = STAGES if args.stages == "all" else tuple(args.stages.split(","))
    unknown = set(asked) - set(STAGES)
    if unknown:
        raise SystemExit(f"unknown stages {sorted(unknown)}")
    run = set(asked)
    for name in asked:
        run |= set(DIFFERENCES.get(name, ()))

    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    B, B2, T, n = args.batch, 2 * args.batch, cfg.context_frames, args.iters
    bf = torch.bfloat16
    params = params_to_torch(synthetic_params(cfg.frame_hz), device, bf)
    enc = params["encoder"]
    g = torch.Generator(device=device).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=device)
    chunk = (rn(B, 2, cfg.frame_samples) * 0.1).to(bf)
    fresh = (rn(B, 2, cfg.frame_shift) * 0.1).to(bf)
    zeros = lambda *s: torch.zeros(*s, dtype=bf, device=device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (host clock)")
    log(f"device: {where}  B={B}  frame={cfg.frame_samples}")
    res: Dict[str, float] = {}

    def stage(name, body, carry, what):
        if name in run:
            res[name] = timed(body, carry, n, device)
            log(f"{name:22s} {res[name]:9.3f} ms  {what}")

    def kv_body(st_ch):
        st, ch = st_ch
        st, out = inc.kv_step(params, st, ch, cfg)
        return st, _evolve(ch, out["p_now"])
    if "step" in run:
        stage("step", kv_body, (inc.init_kv_state(cfg, B, bf, device=device),
                                chunk), "kv_step")

    def enc_body(c):
        ch, h, cc = c
        e, h2, c2 = encode_chunk(enc, ch, h, cc, cfg.downsample_kernel)
        return _evolve(ch, e), h2, c2
    stage("encoder", enc_body, (chunk.reshape(B2, -1), zeros(B2, cfg.dim),
                                zeros(B2, cfg.dim)), "conv + lstm + ds")
    stage("conv", lambda ch: _evolve(ch, cpc_conv_stack(enc, ch)),
          chunk.reshape(B2, -1), "PyTorch convs")

    def stack_im2col(x):
        x = x[:, None, :]
        for i, (k, s, p) in enumerate(CPC_CONV_SPECS):
            c, nrm = enc[f"conv{i}"], enc[f"norm{i}"]
            x = conv1d_im2col(x, c["w"], c["b"], s, p)
            x = torch.relu(channel_norm(x, nrm["w"], nrm["b"]))
        return x
    stage("conv_im2col", lambda ch: _evolve(ch, stack_im2col(ch)),
          chunk.reshape(B2, -1), "unfold + matmul")

    def lstm_body(c):
        z, h, cc = c
        gw = enc["lstm"]
        y, h2, c2 = lstm(z, h, cc, gw["w_ih"], gw["w_hh"], gw["b_ih"],
                         gw["b_hh"])
        return _evolve(z, y), h2, c2
    for name, steps in (("lstm", cfg.frame_samples // 160 - 2),
                        ("lstm5", cfg.frame_shift // 160)):
        stage(name, lstm_body, (rn(B2, steps, cfg.dim).to(bf),
                                zeros(B2, cfg.dim), zeros(B2, cfg.dim)),
              f"{steps} steps")

    def fast_body(impl):
        def body(st_ch):
            st, ch = st_ch
            st, out = inc.fast_step(params, st, ch, cfg, slots="global",
                                    attend_impl=impl)
            return st, _evolve(ch, out["p_now"])
        return body
    for name, impl, quant in (("fast", "kernel", False),
                              ("fast_einsum", "einsum", False),
                              ("fast_q8", "kernel", "row")):
        if name in run:
            stage(name, fast_body(impl), (inc.init_fast_state(
                cfg, B, bf, device=device, quant=quant), fresh),
                f"fast_step ({impl}{', int8 cache' if quant else ''})")

    def enc_stream_body(c):
        ch, st, h, cc = c
        e, st2, h2, c2 = encode_chunk_streaming(enc, ch, st, h, cc,
                                                cfg.downsample_kernel)
        return _evolve(ch, e), st2, h2, c2
    conv_state = lambda: init_conv_stream_state(B2, cfg.encoder_dim, bf,
                                                device)
    if "enc_stream" in run:
        stage("enc_stream", enc_stream_body, (fresh.reshape(B2, -1),
                                              conv_state(),
                                              zeros(B2, cfg.dim),
                                              zeros(B2, cfg.dim)),
              "conv + lstm + ds")

    def stream_im2col(new, state):
        x, new_state = new[:, None, :], {}
        for i, (k, s, _p) in enumerate(CPC_CONV_SPECS):
            carry = state[f"c{i}"].to(x.dtype)
            x = torch.cat([carry if i == 0 else carry.transpose(1, 2), x],
                          dim=-1)
            tail = x[..., x.shape[-1] - (k - s):]
            new_state[f"c{i}"] = (tail.clone() if i == 0
                                  else tail.transpose(1, 2).contiguous())
            c, nrm = enc[f"conv{i}"], enc[f"norm{i}"]
            x = conv1d_im2col(x, c["w"], c["b"], s, 0)
            x = torch.relu(channel_norm(x, nrm["w"], nrm["b"]))
        return x, new_state
    for name, fn, what in (
            ("conv_stream", lambda x, s: cpc_conv_stack_streaming(enc, x, s),
             "PyTorch convs"),
            ("conv_stream_im2col", stream_im2col, "unfold + matmul"),
            ("conv_stream_blocked",
             lambda x, s: cpc_conv_stack_streaming_blocked(enc, x, s),
             "stride-block matmuls")):
        if name in run:
            def body(c, fn=fn):
                z, st2 = fn(c[0], c[1])
                return _evolve(c[0], z), st2
            stage(name, body, (fresh.reshape(B2, -1), conv_state()), what)

    def heads_body(x):
        trunk = {"x": x, "o1": x, "o2": x, "x1": x, "x2": x}
        probs = probs_from_outputs(heads_forward(params, trunk, cfg), cfg)
        return _evolve(x, probs["p_now"])
    stage("heads", heads_body, rn(B, 1, cfg.dim).to(bf), "heads + probs")

    # the KV trunk alone, and the bare row write it ends with
    ones = torch.ones((B,), dtype=torch.bool, device=device)
    h0 = zeros(B, 2, cfg.dim)

    def trunk_body(impl):
        def body(c):
            st, e = c
            out = inc._kv_core(params, st, e, h0, h0, cfg, ones, "global",
                               impl)
            return st, _evolve(e, out["p_now"])
        return body
    for name, impl in (("trunk_kernel", "kernel"), ("trunk_einsum",
                                                    "einsum")):
        if name in run:
            stage(name, trunk_body(impl), (inc.init_kv_state(
                cfg, B, bf, device=device), rn(B, 2, cfg.dim).to(bf)),
                f"_kv_core ({impl}) with its row write")
    if "cachewrite" in run:
        cache = inc.init_kv_state(cfg, B, bf, device=device).cache
        row = torch.ones(cache[:, :, 0].shape, dtype=bf, device=device)

        def write_body(c):
            cache, step = c
            cache[:, :, step % T] = row * (step % 100)
            return cache, step + 1
        stage("cachewrite", write_body, (cache, 0), "bare row write")
        del cache

    if "cacheread" in run:
        cache = inc.init_kv_state(cfg, B, bf, device=device).cache + 1.0
        gb = cache.numel() * cache.element_size() / 1e9

        def read_body(c):
            cache, acc = c
            acc = acc + cache_read_all(cache).sum()
            # perturb ONE small slice so the read is not loop-invariant
            cache[0, 0, 0, :128] = (acc * 1e-20).to(cache.dtype)
            return cache, acc
        stage("cacheread", read_body,
              (cache, torch.zeros((), device=device)),
              f"K12 over the {gb:.2f} GB cache")
        if "cacheread" in res:
            log(f"{'':22s} -> {gb / res['cacheread'] * 1e3:,.0f} GB/s")
        del cache

    if "hbm" in run:
        # a bf16 buffer of the cache's size, read and written once each
        x = torch.ones(B * len(inc.cache_layout(cfg)) * T * cfg.dim,
                       dtype=bf, device=device)
        gb = 2 * x.numel() * 2 / 1e9

        def hbm_body(c):
            x, s = c
            x.mul_(s.to(bf))
            return x, s * 1.000001 + 1e-9
        stage("hbm", hbm_body, (x, torch.ones((), device=device)),
              f"{gb:.2f} GB read + written")
        if "hbm" in res:
            log(f"{'':22s} -> {gb / res['hbm'] * 1e3:,.0f} GB/s")
        del x

    if "opchain" in run:
        def chain(k):
            def body(c):
                y, w = c
                for _ in range(k):
                    y = torch.matmul(y, w)
                return y, w * 1.0000001
            return body
        y0 = torch.ones(B, 256, dtype=bf, device=device)
        w0 = torch.eye(256, dtype=bf, device=device) * 0.999
        t10 = timed(chain(10), (y0, w0), n, device)
        t50 = timed(chain(50), (y0, w0), n, device)
        res["opchain"] = (t50 - t10) / 40
        log(f"{'opchain':22s} {t10:9.3f} ms @10, {t50:.3f} ms @50 -> "
            f"{res['opchain'] * 1e3:,.1f} us/op")

    if "mxu" in run:
        a0 = torch.ones(B, B, dtype=bf, device=device)
        stage("mxu", lambda a: torch.matmul(a, a) * 1e-3, a0,
              f"({B}, {B}) bf16 matmul")
        if "mxu" in res:
            log(f"{'':22s} -> {2 * B ** 3 / res['mxu'] / 1e9:,.1f} TFLOP/s")

    for name, (a, b) in DIFFERENCES.items():
        if name in asked:
            res[name] = res[a] - res[b]
            log(f"{name:22s} {res[name]:9.3f} ms  {a} - {b} (by difference)")
    log("---")
    for k, v in res.items():
        log(f"{k:22s} {v:9.3f} ms")
    return res


if __name__ == "__main__":
    main()
