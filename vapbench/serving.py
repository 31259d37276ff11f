"""The serving cells' system under test and its check.

`Serving` builds what `NativeVapServer.tick` drives, minus the sockets:
a `StreamArena` of N streams with the configuration's serving options,
every stream active.  A tick is what that server does for each batch of
frames: the int16 frames from host memory, `step_device_batch(frames,
slots)`, and the copy of the mode's result fields to pinned host memory,
waited on with a CUDA event.  The frames come from the seeded audio pool
(`audio.StreamAudio`); a helper thread gathers tick k + 1's frames into
the other of two pinned buffers while tick k runs, as the server's
ingest threads fill its poll buffer while the device works (three
buffers, so a gather never waits on a tick still in flight).

The check: the served fields of a sample of streams drawn from the seed
(half from each half of the batch), captured every tick on the host,
against the float64 reference run over the same streams' whole audio
after the window, once the arena is freed.  Compared are the ticks after
the ring has wrapped (tick >= T), every field.  The number held to the
limit is the widest gap over them divided by the widest gap of the
reference computed in bf16 (operands and results of every product, and
the served fields, rounded to bf16) on the same streams: how far the
program strays, in units of the rounding a sound bf16 computation makes
on this seed's weights and audio (the absolute gap of both swings from
seed to seed with the weights' sensitivity).
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Dict, List, Optional

import numpy as np

from vapbench.audio import StreamAudio
from vapbench.common import sub_seed
from vapbench.reference.serving import FIELDS
from vapbench.weights import make_params


def vap_config(model: Dict):
    from vap_realtime_tpu_torch.config import VapConfig

    keys = ("mode", "frame_hz", "context_len_sec", "encoder_dim", "dim",
            "channel_layers", "cross_layers", "num_heads", "dff_k",
            "dropout")
    return VapConfig(**{k: model[k] for k in keys})


class Serving:
    def __init__(self, wl: Dict, cfg: Dict, seed: int, device: str,
                 streams: Optional[int] = None,
                 control: Optional[str] = None, fault=None):
        import torch

        from vap_realtime_tpu_torch.runtime.arena import StreamArena

        self.torch = torch
        self.wl, self.cfg, self.seed = wl, cfg, seed
        self.model = cfg["model"]
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        serve = cfg["serving"]
        self.vcfg = vap_config(self.model)
        self.N = int(streams or wl["streams"])
        self.T = self.vcfg.context_frames
        dtype = getattr(torch, serve["dtype"])
        t = time.perf_counter()
        self.params = make_params(self.model, seed, self.device, dtype)
        self.audio = StreamAudio(wl["audio"], self.N, self.vcfg.frame_shift,
                                 seed, self.device)
        self.marks = {"inputs_s": time.perf_counter() - t}
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # controls (the limits tool): "int8_cache", the port's own int8
        # path (the ring cache in int8 with frozen per-stream scales);
        # "fp8", the reference computed in float8 in the program's place
        self.control = control
        quant = ("global" if control == "int8_cache"
                 else serve.get("quant_cache", False))
        self.arena = StreamArena(
            self.vcfg, self.params, capacity=self.N, path=serve["path"],
            dtype=dtype, slots=serve["slots"],
            attend_impl=serve["attend_impl"], quant_cache=quant,
            wire_dtype=np.dtype(serve["wire_dtype"]).type,
            conv_impl=serve["conv_impl"],
            conv_chunks=serve.get("conv_chunks", 1), device=self.device)
        self.arena.warmup()
        self.marks["arena_s"] = time.perf_counter() - t - self.marks[
            "inputs_s"]
        self.fields = FIELDS[self.model["mode"]]
        self.slots = np.arange(self.N)
        pin = self.cuda
        self.frames = [torch.empty((self.N, 2, self.vcfg.frame_shift),
                                   dtype=torch.int16, pin_memory=pin)
                       for _ in range(3)]
        self.host = None
        rs = np.random.RandomState(sub_seed(seed, 4) % 2 ** 32)
        half = self.N // 2
        k = min(wl["check"]["sample_streams"] // 2, half)
        self.sample = np.sort(np.concatenate([
            rs.choice(half, k, replace=False),
            half + rs.choice(self.N - half, k, replace=False)]))
        self.captured: List[np.ndarray] = []
        self.failed = 0
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.pending = None
        if fault is not None:        # tests: break the timed path
            fault(self)

    # --- one tick -----------------------------------------------------------

    def prepare(self, tick: int) -> None:
        """Gather tick's frames in the helper thread (buffer tick % 3)."""
        self.pending = self.pool.submit(self.audio.fill, tick,
                                        self.frames[tick % 3])

    def frames_ready(self) -> None:
        with self.torch.profiler.record_function("vapbench.frames"):
            self.pending.result()

    def dispatch(self, tick: int, spans: Optional[Dict] = None):
        """Dispatch `tick` (its frames gathered) and start its readback.
        Returns (host tensors, CUDA event or None).  With `spans`, appends
        the host seconds inside `step_device_batch` to spans["arena"]."""
        torch = self.torch
        frames = self.frames[tick % 3].numpy()
        t = time.perf_counter()
        with torch.profiler.record_function("vapbench.arena"):
            out = self.arena.step_device_batch(frames, self.slots)
        if spans is not None:
            spans["arena"].append(time.perf_counter() - t)
        with torch.profiler.record_function("vapbench.readback"):
            return self.readback(out, tick % 2)

    def readback(self, out, which: int):
        torch = self.torch
        if self.host is None:
            self.host = [{k: torch.empty(tuple(out[k].shape),
                                         dtype=torch.float32,
                                         pin_memory=self.cuda)
                          for k in self.fields} for _ in range(2)]
        host = self.host[which]
        for k in self.fields:
            host[k].copy_(out[k].float(), non_blocking=True)
        if not self.cuda:
            return host, None
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def collect(self, host, ev) -> None:
        """Wait for a tick's results; capture the sample, count the
        streams whose fields are not all finite."""
        if ev is not None:
            with self.torch.profiler.record_function("vapbench.wait"):
                ev.synchronize()
        mats = [host[k].numpy().reshape(self.N, -1) for k in self.fields]
        m = np.concatenate(mats, axis=1)
        self.failed += int(self.N - np.isfinite(m).all(axis=1).sum())
        self.captured.append(m[self.sample].astype(np.float64))

    def frozen_ticks(self, n: int) -> None:
        """Ticks of the whole path with every stream frozen (state
        untouched): warms the upload, the readback and the host pool."""
        for _ in range(n):
            self.audio.fill(0, self.frames[0])
            out = self.arena.step_device_batch(self.frames[0].numpy(),
                                               self.slots[:0])
            host, ev = self.readback(out, 0)
            if ev is not None:
                ev.synchronize()

    # --- the check ---------------------------------------------------------

    def free(self) -> None:
        """Drop the arena and its state before the reference runs."""
        torch = self.torch
        self.pool.shutdown(wait=True)
        self.arena = None
        self.host = None
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, ticks: int) -> Dict:
        """The widest gap between the served fields of the sampled streams
        and the reference's, over the ticks after the ring wrapped."""
        from vapbench.reference.serving import stream_outputs

        torch = self.torch
        got = np.stack(self.captured[:ticks], axis=1)      # (S, K, n)
        audio = np.stack([self.audio.history(i, ticks) for i in self.sample])
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        t = time.perf_counter()
        ref = stream_outputs(self.params, self.model, audio, self.device)
        from vapbench.reference.ops import low_precision

        # the rounding a sound bf16 computation makes on these streams:
        # the reference with bf16 operands and results in every product
        # and bf16 served fields
        with low_precision(torch.bfloat16, outputs=True):
            emu = stream_outputs(self.params, self.model, audio, self.device)
        # the control: the same reference computed in the step below bf16
        if self.control == "fp8":
            with low_precision(torch.float8_e4m3fn, outputs=True):
                got = stream_outputs(self.params, self.model, audio,
                                     self.device)
        first = self.T if ticks > self.T else 0
        gap = np.abs(got[:, first:] - ref[:, first:])
        egap = np.abs(emu[:, first:] - ref[:, first:])
        worst = np.unravel_index(np.argmax(gap), gap.shape)
        rms = float(np.sqrt((gap ** 2).mean()))
        erms = float(np.sqrt((egap ** 2).mean()))
        return {"max_gap": float(gap.max()),
                "emu_max_gap": float(egap.max()),
                "max_gap_ratio": float(gap.max() / egap.max()),
                "rms_gap": rms, "emu_rms_gap": erms,
                "rms_gap_ratio": rms / erms,
                "field_max": [float(x) for x in gap.max(axis=(0, 1))],
                "emu_field_max": [float(x) for x in egap.max(axis=(0, 1))],
                "compared": int(gap.shape[0] * gap.shape[1]),
                "first_tick": first,
                "worst": {"stream": int(self.sample[worst[0]]),
                          "tick": int(first + worst[1]),
                          "field": int(worst[2])},
                "ref_s": time.perf_counter() - t}


def traced_ticks(ctx, sv: Serving, K: int):
    """(profiler or None, first traced tick, end): the stretch of
    `trace.ticks` ticks the workload file places from `trace.start` (or
    the window's middle, when that is earlier); (None, K, K) untraced."""
    if not ctx["trace"]:
        return None, K, K
    from vapbench.trace import Profile, layer_spans

    t = ctx["workload"]["trace"]
    n = min(t["ticks"], K)
    p0 = max(0, min(t["start"], K // 2 - n // 2))
    ctx["stack"].enter_context(layer_spans())
    prof = Profile()
    prof.warm()
    return prof, p0, p0 + n


def serving_result(ctx, sv: Serving, K: int, e2e: Dict, spans: Dict,
                   prof, n_traced: int, tick_names, info: Dict) -> Dict:
    """Read the device's peak, free the arena, run the check; the
    result's numbers and what the per-layer readers read."""
    torch = sv.torch
    mem = int(torch.cuda.max_memory_allocated()) if sv.cuda else 0
    summary = prof.summary() if prof is not None else None
    counters = prof.counters if prof is not None else {}
    sv.free()
    chk = sv.check(K)
    limits = ctx["workload"]["check"]["limits"]
    checks = {k: (chk[k], lim) for k, lim in limits.items()}
    ok = chk["compared"] > 0 and sv.failed == 0
    model = sv.model
    reader = {"model": model, "streams": sv.N, "T": sv.T,
              "frame_shift": sv.vcfg.frame_shift,
              "stage": sv.cfg["serving"]["stage_rows"],
              "host": spans, "summary": summary, "n_traced": n_traced,
              "tick_names": tick_names, "counters": counters}
    return {"e2e": e2e, "attempted": K * sv.N, "failed": sv.failed,
            "checks": checks, "sound": ok, "memory_peak_bytes": mem,
            "info": dict(info, streams=sv.N, setup=sv.marks, check=chk),
            "reader": reader}
