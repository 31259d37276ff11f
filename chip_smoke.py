"""Drive the PyTorch/CUDA port of VAP on one NVIDIA card (H100) and check it.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

  build  nvcc builds every kernel under vap_realtime_tpu_torch/csrc/ (one
         process per source, all started together) while g++ builds the
         native ingest engine.
  (a)    Each kernel against its plain PyTorch version on the card at the
         serving shapes (B=4096 streams and the server run's 64, T=50,
         S=8, all 7 phases, both bodies): float32 at atol 1e-4 (TF32 off), bfloat16 at atol/rtol
         2e-2 (the plain version rounds (k - kc) * q and w * v to bf16, the
         kernel keeps them in float32), a mixed live/DEAD case and an
         all-DEAD case.
  (b)    The full-width fast staged step (vap, 20 Hz, 2.5 s context,
         synthetic weights): on a small input, float32 on the card equals
         the CPU path (which the CPU tests hold against the JAX package) at
         atol 1e-4; at B=4096 bf16 over 17 frames (two merges) the kernel
         run equals the same step with `attend_pair_plain` (p_now atol
         2e-2) and the launch counter rises by exactly 7 per step.
  (d)    Times with CUDA events after warm-up, each beside the card's name
         and power limit: kernel ms per launch and its bound, the plain
         version, one scaled_dot_product_attention call over the same
         problem as a yardstick (the port never calls it), and the fast
         step's ms/step at B=4096 with the streams per card it implies.
  (c)    The main path through its user entry point: the native server
         (capacity 64, bf16, int16 wire) answers 8 loopback connections
         streaming 1 s of synthetic audio each (>= 15 results on each);
         the launch counters are zeroed just before and read just after.

The last lines: the card's name and power limit, one JSON line listing
each kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import json
import socket
import sys
import threading
import time

import numpy as np
import torch

B, T, S, P, D, H = 4096, 50, 8, 7, 256, 4
SERVER_CAPACITY = 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # H100 SXM, float32 outside tensor cores


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def build() -> None:
    """nvcc for every kernel source and g++ for the ingest engine, all
    started together."""
    from vap_realtime_tpu_torch.io.native_ingest import build_lib
    from vap_realtime_tpu_torch.ops.cuda.build import build_all

    t = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(build_lib)
        reports = build_all()
        gxx.result()
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(regs), flush=True)
    print(f"[build] kernels + native ingest built in {time.time() - t:.1f} s",
          flush=True)


def attend_inputs(dtype, case: str, seed: int, nb: int = B):
    """Serving-shaped attend inputs for nb streams, made on the card from
    a seed: live ages in [1, T+S), about a third DEAD ("mixed") or all
    DEAD ("dead")."""
    from vap_realtime_tpu_torch.ops.cuda.attend import DEAD

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    cache, stage = rn(nb, P, T, 4 * D), rn(S, nb, P * 4 * D)
    q2, kc2, vc2 = rn(nb, 2, D), rn(nb, 2, D), rn(nb, 2, D)
    age = torch.randint(1, T + S, (nb, T), generator=g, device=dev).float()
    sage = torch.randint(1, T + S, (S, nb), generator=g, device=dev).float()
    if case == "dead":
        age.fill_(DEAD)
        sage.fill_(DEAD)
    else:
        age[torch.rand(nb, T, generator=g, device=dev) < 0.35] = DEAD
        sage[torch.rand(S, nb, generator=g, device=dev) < 0.35] = DEAD
    return cache, q2, kc2, vc2, age, stage, sage


def phase_a() -> float:
    """Kernel vs plain at the serving shapes (B=4096, and the server
    run's capacity); returns the max abs error of the bf16 staged body
    (the main path's)."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )

    worst_main = 0.0
    for dtype, atol, rtol in ((torch.float32, 1e-4, 0.0),
                              (torch.bfloat16, 2e-2, 2e-2)):
        for nb, case in ((B, "mixed"), (B, "dead"),
                         (SERVER_CAPACITY, "mixed")):
            cache, q2, kc2, vc2, age, stage, sage = attend_inputs(
                dtype, case, seed=1 if case == "mixed" else 2, nb=nb)
            for staged in (True, False):
                st = (stage, sage) if staged else (None, None)
                err = 0.0
                for ph in range(P):
                    kw = dict(pair_base=2 * ph, num_heads=H)
                    got = attend_pair(cache, q2, kc2, vc2, age, *st, **kw)
                    want = attend_pair_plain(cache, q2, kc2, vc2, age, *st,
                                             **kw)
                    torch.cuda.synchronize()
                    d = (got.float() - want.float()).abs()
                    bad = d > atol + rtol * want.float().abs()
                    check(torch.isfinite(got).all().item(),
                          f"non-finite kernel output ({dtype}, {case})")
                    check(not bad.any().item(),
                          f"kernel vs plain {dtype} {case} staged={staged} "
                          f"phase {ph}: max |d| {d.max().item():.3e}")
                    if case == "dead":
                        check(torch.equal(got, vc2),
                              "all-DEAD rows: output must equal v_cur")
                    err = max(err, d.max().item())
                print(f"[a] attend_pair {str(dtype)[6:]} B={nb} {case:5s} "
                      f"{'staged' if staged else 'ring  '} 7 phases: "
                      f"max |kernel - plain| {err:.3e} (atol {atol:g}, "
                      f"rtol {rtol:g})", flush=True)
                if dtype == torch.bfloat16 and staged:
                    worst_main = max(worst_main, err)
            del cache, stage
    torch.cuda.empty_cache()
    return worst_main


def fast_inputs(cfg, n_streams, frames, seed, device, dtype):
    g = torch.Generator(device=device).manual_seed(seed)
    x = 0.1 * torch.randn(frames, n_streams, 2, cfg.frame_shift,
                          generator=g, device=device)
    return x.to(dtype)


def phase_b(cfg, params_np):
    """The full-width fast staged step on the card."""
    from vap_realtime_tpu_torch.ops.cuda.attend import attend_pair
    from vap_realtime_tpu_torch.runtime import incremental as inc
    from vap_realtime_tpu_torch.weights.convert import params_to_torch

    # small input, float32: the card (kernel) equals the CPU path
    nb, nf = 3, 12
    outs = {}
    for dev in ("cpu", "cuda"):
        p = params_to_torch(params_np, dev)
        st = inc.init_fast_state(cfg, nb, staged=True, device=dev)
        frames = fast_inputs(cfg, nb, nf, 5, "cpu", torch.float32).to(dev)
        res = []
        for f in range(nf):
            act = torch.tensor([True, f % 2 == 0, f % 3 != 0], device=dev)
            st, o = inc.fast_step(p, st, frames[f], cfg, act,
                                  slots="staged", attend_impl="kernel")
            res.append(torch.stack([o["p_now"], o["p_future"], o["vad"]])
                       .cpu())
        outs[dev] = torch.stack(res)
    d = (outs["cuda"] - outs["cpu"]).abs().max().item()
    check(d <= 1e-4, f"f32 card vs CPU path: max |d| {d:.3e} > 1e-4")
    print(f"[b] full width f32, B={nb}, {nf} frames, card vs CPU path: "
          f"max |d| {d:.3e} (atol 1e-4)", flush=True)

    # serving size, bf16: kernel vs plain attend, 7 launches per step
    p = params_to_torch(params_np, "cuda", torch.bfloat16)
    nf = 17
    frames = fast_inputs(cfg, B, nf, 6, "cuda", torch.bfloat16)
    idx = torch.arange(B, device="cuda")
    runs = {}
    for impl in ("kernel", "plain"):
        st = inc.init_fast_state(cfg, B, torch.bfloat16, staged=True,
                                 device="cuda")
        attend_pair.launches = 0
        res = []
        for f in range(nf):
            act = (idx + f) % 7 != 0
            st, o = inc.fast_step(p, st, frames[f], cfg, act,
                                  slots="staged", attend_impl=impl)
            res.append(o["p_now"].float())
        torch.cuda.synchronize()
        want = 7 * nf if impl == "kernel" else 0
        check(attend_pair.launches == want,
              f"{impl} run: {attend_pair.launches} attend launches, "
              f"expected {want}")
        runs[impl] = torch.stack(res)
        del st
    pk = runs["kernel"]
    check(pk.shape == (nf, B, 2) and torch.isfinite(pk).all().item(),
          "p_now shape / finiteness")
    check(((pk >= 0) & (pk <= 1.0 + 1e-2)).all().item(), "p_now in [0, 1]")
    d = (pk - runs["plain"]).abs().max().item()
    check(d <= 2e-2, f"bf16 kernel vs plain step: max |d p_now| {d:.3e}")
    print(f"[b] full width bf16, B={B}, {nf} frames (2 merges): kernel vs "
          f"plain attend max |d p_now| {d:.3e} (atol 2e-2); "
          f"{7 * nf} launches = 7/step", flush=True)
    return p, frames


def phase_d(cfg, p_bf16, frames, gpu):
    """Times on the card; returns the kernel's numbers for the JSON line."""
    from vap_realtime_tpu_torch.ops.cuda.attend import (
        attend_pair, attend_pair_plain,
    )
    from vap_realtime_tpu_torch.profile_step import cuda_ms
    from vap_realtime_tpu_torch.runtime import incremental as inc

    dt = torch.bfloat16
    cache, q2, kc2, vc2, age, stage, sage = attend_inputs(dt, "mixed", 3)
    es = 2
    nbytes = (B * T * 4 * D * es + S * B * 4 * D * es   # plane + stage slice
              + 3 * B * 2 * D * es + B * T * 4 + S * B * 4
              + B * 2 * D * es)                         # out
    flops = B * 2 * (T + S) * D * 5                     # sub, fma; fma (v)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    ph = iter(range(10 ** 9))
    kern = lambda st: attend_pair(cache, q2, kc2, vc2, age, *st,
                                  pair_base=2 * (next(ph) % P), num_heads=H)
    ms = cuda_ms(lambda: kern((stage, sage)), reps=70, warm=7)
    ms_ring = cuda_ms(lambda: kern((None, None)), reps=70, warm=7)
    plain_ms = cuda_ms(lambda: attend_pair_plain(
        cache, q2, kc2, vc2, age, stage, sage, pair_base=2, num_heads=H),
        reps=7, warm=2)
    ring_bytes = nbytes - S * B * 4 * D * es - S * B * 4
    print(f"[d] attend_pair bf16 staged (K2), B={B} T={T} S={S}: "
          f"{ms:.4f} ms/launch, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e9:.3f} GB at 3.35 TB/s) = "
          f"{100 * bound_ms / ms:.1f}% of bound | {gpu}", flush=True)
    print(f"[d] attend_pair bf16 ring-only (K1): {ms_ring:.4f} ms/launch, "
          f"bound {ring_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms | {gpu}",
          flush=True)
    print(f"[d] attend_pair_plain bf16 staged: {plain_ms:.4f} ms/call | "
          f"{gpu}", flush=True)

    # yardstick: one SDPA call over the same (B*2, H, 1, T+S+1) problem,
    # phase 1: the ring + staged + current k/v gathered into SDPA's
    # layout, the AliBi/validity bias as an additive float mask
    L, Dh, ph1 = T + S + 1, D // H, 1
    col = ph1 * 4 * D

    def heads(x):                                   # (B, 2, L, D) -> SDPA
        return x.reshape(B, 2, L, H, Dh).permute(0, 1, 3, 2, 4).reshape(
            2 * B, H, L, Dh).contiguous()

    # phase plane columns: [set][k|v][D]
    kv = torch.cat([cache[:, ph1].reshape(B, T, 2, 2, D),
                    stage[:, :, col:col + 4 * D].reshape(S, B, 2, 2, D)
                    .transpose(0, 1)], 1).transpose(1, 2)  # (B, 2, L-1, 2, D)
    k_all = heads(torch.cat([kv[:, :, :, 0], kc2[:, :, None]], 2))
    v_all = heads(torch.cat([kv[:, :, :, 1], vc2[:, :, None]], 2))
    del kv
    slopes = torch.tensor(inc.alibi_slopes(H), device="cuda")
    ages = torch.cat([age, sage.T, torch.zeros(B, 1, device="cuda")], 1)
    bias = torch.where(ages[:, None, :] < 1e8, -ages[:, None, :]
                       * slopes[None, :, None], float("-inf"))  # (B, H, L)
    mask = bias[:, None].expand(B, 2, H, L).reshape(2 * B, H, 1, L).to(dt)
    q_s = q2.reshape(2 * B, H, 1, Dh).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fn = lambda: sdpa(q_s, k_all, v_all, attn_mask=mask,
                          scale=D ** -0.5)
    library_ms = cuda_ms(lib_fn, reps=20, warm=3)
    d_lib = (lib_fn().reshape(B, 2, D).float() - attend_pair(
        cache, q2, kc2, vc2, age, stage, sage, pair_base=2 * ph1,
        num_heads=H).float()).abs().max().item()
    print(f"[d] library yardstick scaled_dot_product_attention bf16 "
          f"(2B, H, 1, {L}) + float mask: {library_ms:.4f} ms/call "
          f"(max |sdpa - kernel| {d_lib:.3e}) | {gpu}", flush=True)
    del cache, stage, k_all, v_all, mask
    torch.cuda.empty_cache()

    # the fast staged step at serving size (kernel attend)
    st = inc.init_fast_state(cfg, B, dt, staged=True, device="cuda")
    steps = 24
    for f in range(steps + 4):
        if f == 4:
            torch.cuda.synchronize()
            t0 = time.time()
        st, o = inc.fast_step(p_bf16, st, frames[f % frames.shape[0]], cfg,
                              slots="staged", attend_impl="kernel")
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3 / steps
    streams = B * (1e3 / cfg.frame_hz) / step_ms
    print(f"[d] fast staged step bf16, B={B}, kernel attend: "
          f"{step_ms:.3f} ms/step (host clock, {steps} steps incl. 3 "
          f"merges) -> {streams:.0f} realtime streams per card at "
          f"{cfg.frame_hz} Hz | {gpu}", flush=True)
    del st
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_c(cfg, params_np):
    """The native server on the card: 8 loopback connections."""
    from vap_realtime_tpu_torch.io import wire
    from vap_realtime_tpu_torch.ops.cuda.attend import attend_pair
    from vap_realtime_tpu_torch.runtime.arena import StreamArena
    from vap_realtime_tpu_torch.runtime.server_native import NativeVapServer
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_audio

    arena = StreamArena(cfg, params_np, capacity=SERVER_CAPACITY,
                        dtype=torch.bfloat16,
                        wire_dtype=np.int16, device="cuda")
    arena.warmup()
    srv = NativeVapServer(arena, port=0, wire_int16=True)
    n_conn, hops = 8, 100                            # 1 s of audio each
    audios = [synthetic_audio(16000, seed=7 + i) for i in range(n_conn)]
    results = [[] for _ in range(n_conn)]

    def client(i):
        pcm = np.clip(audios[i] * 32768, -32768, 32767).astype("<i2")
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=20) as s:
            s.settimeout(20)

            def reader():
                buf = b""
                while len(results[i]) < hops // 5:
                    try:
                        part = s.recv(65536)
                    except socket.timeout:
                        return
                    if not part:
                        return
                    buf += part
                    while len(buf) >= 4:
                        ln = int.from_bytes(buf[:4], "little")
                        if len(buf) < 4 + ln:
                            break
                        results[i].append(
                            wire.deserialize_result(buf[4:4 + ln], "vap"))
                        buf = buf[4 + ln:]

            rd = threading.Thread(target=reader)
            rd.start()
            for h in range(hops):                    # realtime pacing
                pair = np.empty((160, 2), "<i2")
                pair[:, 0] = pcm[0, h * 160:(h + 1) * 160]
                pair[:, 1] = pcm[1, h * 160:(h + 1) * 160]
                s.sendall(pair.tobytes())
                time.sleep(0.01)
            rd.join(timeout=30)

    attend_pair.launches = 0                         # main path: zero ...
    ticker = threading.Thread(target=srv.serve_forever)
    ticker.start()
    clients = [threading.Thread(target=client, args=(i,))
               for i in range(n_conn)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
    finally:
        srv.stop()
        ticker.join(timeout=10)
    launches = attend_pair.launches                  # ... and read
    check(not ticker.is_alive() and not any(c.is_alive() for c in clients),
          "server or client threads did not stop")
    ticks = srv.tick_stats["n"]
    check(launches == 7 * ticks and launches > 0,
          f"{launches} attend launches over {ticks} server ticks "
          f"(expected 7 per tick)")
    shift = cfg.frame_shift
    skipped = 0
    for i, res in enumerate(results):
        check(len(res) >= 15, f"connection {i}: {len(res)} results (< 15)")
        # each result echoes one of this connection's own frames, in
        # order (the ingest engine skips frames only when ticks fall
        # behind real time)
        frames_i = audios[i][0, :hops // 5 * shift].reshape(-1, shift)
        last = -1
        for j, r in enumerate(res):
            err = np.abs(frames_i - np.asarray(r["x1"])[None]).max(axis=1)
            f = int(err.argmin())
            check(err[f] <= 1.5 / 32768 and f > last,
                  f"connection {i} result {j}: echo matches frame {f} "
                  f"(|d| {err[f]:.2e}) after frame {last}")
            skipped += f - last - 1
            last = f
            pn = np.asarray(r["p_now"])
            check(pn.shape == (2,) and np.isfinite(pn).all()
                  and abs(pn.sum() - 1) < 2e-2,
                  f"connection {i} result {j}: p_now {pn}")
    print(f"[c] native server, capacity 64, bf16, int16 wire: "
          f"{[len(r) for r in results]} results on {n_conn} connections "
          f"({skipped} frames skipped), {ticks} ticks, {launches} attend "
          f"launches (7 per tick)",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vap_realtime_tpu_torch.config import VapConfig
    from vap_realtime_tpu_torch.profile_step import gpu_line
    from vap_realtime_tpu_torch.weights.synthetic import synthetic_params

    # float32 checks on the card need full float32 convs and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    print(f"[gpu] {gpu} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    build()
    max_err = phase_a()
    cfg = VapConfig(frame_hz=20, context_len_sec=2.5)
    params_np = synthetic_params(cfg.frame_hz)
    p_bf16, frames = phase_b(cfg, params_np)
    times = phase_d(cfg, p_bf16, frames, gpu)
    del p_bf16, frames
    launches = phase_c(cfg, params_np)

    print(gpu, flush=True)
    print(json.dumps({"kernels": [dict(
        name="attend_pair", route="cuda",
        source="vap_realtime_tpu_torch/csrc/attend_pair.cu",
        replaces="vap_realtime_tpu/ops/pallas/attend.py:454",
        launches=launches, max_abs_err=max_err, **times)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
