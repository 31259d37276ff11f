"""ctypes binding for the native stream-ingestion engine (native/ingest.cpp).

Usage:
    ing = NativeIngest(port=0, capacity=4096, frame_samples=1120)
    ...
    slots, frames = ing.poll()      # frames: (capacity, 2, S) float32 view
    ing.send(slot, payload_bytes)   # queue a result to that connection

The port's own copy of `vap_realtime_tpu/io/native_ingest.py`.  It builds
`native/ingest.cpp` with g++ (the flags of `tools/build_native.py`) into
its own `build/libvapingest.so`, written under a temporary name and
renamed, so concurrent builds and loads never see a partial file.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import List, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_native(source: str, output: str, flags: List[str]) -> str:
    """g++ native/<source> into build/<output> if that is missing or
    older than its source, written under a temporary name and renamed;
    returns the output's path."""
    src = os.path.join(REPO, "native", source)
    out = os.path.join(REPO, "build", output)
    if os.path.exists(out) and os.path.getmtime(out) > os.path.getmtime(src):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O2", "-std=c++17", *flags, "-pthread", src,
                    "-o", tmp], check=True)
    os.replace(tmp, out)
    return out


def build_lib() -> str:
    """Build the engine if the library is missing or older than its
    source; returns the library's path."""
    return build_native("ingest.cpp", "libvapingest.so", ["-shared", "-fPIC"])


@functools.lru_cache(maxsize=None)
def _load_lib():
    lib = ctypes.CDLL(build_lib())
    lib.vap_ingest_create.restype = ctypes.c_void_p
    lib.vap_ingest_create.argtypes = [ctypes.c_uint16, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.vap_ingest_port.restype = ctypes.c_uint16
    lib.vap_ingest_port.argtypes = [ctypes.c_void_p]
    lib.vap_ingest_active.restype = ctypes.c_int
    lib.vap_ingest_active.argtypes = [ctypes.c_void_p]
    lib.vap_ingest_poll.restype = ctypes.c_int
    lib.vap_ingest_poll.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.vap_ingest_poll_i16.restype = ctypes.c_int
    lib.vap_ingest_poll_i16.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.vap_ingest_send.restype = ctypes.c_int
    lib.vap_ingest_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.vap_ingest_send_batch.restype = ctypes.c_int
    lib.vap_ingest_send_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.vap_ingest_send_results.restype = ctypes.c_int
    lib.vap_ingest_send_results.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.vap_ingest_send_pending.restype = ctypes.c_int
    lib.vap_ingest_send_pending.argtypes = [ctypes.c_void_p]
    lib.vap_ingest_send_dropped.restype = ctypes.c_int
    lib.vap_ingest_send_dropped.argtypes = [ctypes.c_void_p]
    lib.vap_ingest_gen.restype = ctypes.c_uint32
    lib.vap_ingest_gen.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vap_ingest_gens.restype = None
    lib.vap_ingest_gens.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint32)]
    lib.vap_ingest_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeIngest:
    def __init__(self, port: int = 0, capacity: int = 1024,
                 frame_samples: int = 1120, wire_int16: bool = False,
                 overlap: int = -1, emit_i16: bool = False):
        """overlap: samples kept as each next frame's left context
        (-1 = the reference's 320-sample `frame_contxt_padding`; 0 for
        the fast path's disjoint fresh-sample chunks).

        emit_i16 (requires wire_int16): poll() returns RAW int16 frames
        — the consumer normalizes /32768 on the accelerator, quartering
        the host->device transfer (the serving bottleneck through slow
        host links; tools/serving_bench.py)."""
        if emit_i16 and not wire_int16:
            raise ValueError("emit_i16 requires wire_int16")
        self._lib = _load_lib()
        self._h = self._lib.vap_ingest_create(
            port, capacity, frame_samples,
            2 if emit_i16 else int(wire_int16), overlap)
        if not self._h:
            raise OSError(f"vap_ingest_create failed (port {port})")
        self.capacity = capacity
        self.frame_samples = frame_samples
        self.emit_i16 = emit_i16
        self.port = int(self._lib.vap_ingest_port(self._h))
        # poll() alternates TWO frame buffers: the pipelined serving
        # tick dispatches from buffer k while send_results() snapshots
        # the echo from buffer k-1 (and the async device transfer of
        # buffer k-1 has a full tick to complete before reuse)
        self._frames2 = [np.zeros((capacity, 2, frame_samples),
                                  np.int16 if emit_i16 else np.float32)
                         for _ in range(2)]
        self._fidx = 0
        self._slots = np.zeros((capacity,), np.int32)

    @property
    def n_active(self) -> int:
        if not self._h:
            return 0
        return int(self._lib.vap_ingest_active(self._h))

    def poll(self) -> Tuple[List[int], np.ndarray]:
        """Drain completed frames (at most one per slot per call).
        Returns (ready slot ids, the slot-major (capacity, 2,
        frame_samples) frame array — rows for slots NOT in the ready
        list are stale)."""
        if not self._h:
            return [], self._frames2[0]
        frames = self._frames2[self._fidx]
        self._fidx ^= 1
        if self.emit_i16:
            n = self._lib.vap_ingest_poll_i16(
                self._h,
                frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                self._slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                self.capacity)
        else:
            n = self._lib.vap_ingest_poll(
                self._h,
                frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                self.capacity)
        return self._slots[:n].tolist(), frames

    def send(self, slot: int, payload: bytes) -> int:
        if not self._h:
            return -1
        return self._lib.vap_ingest_send(self._h, slot, payload,
                                         len(payload))

    def generations(self) -> np.ndarray:
        """All slots' generation counters in ONE native call (the
        per-slot accessor costs a ctypes round trip each)."""
        out = np.zeros((self.capacity,), np.uint32)
        if self._h:
            self._lib.vap_ingest_gens(
                self._h,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out

    def send_batch(self, slots: np.ndarray, payloads: np.ndarray) -> int:
        """Queue one equal-length payload per slot in ONE native call.

        slots: (n,) int32 (negative = skip); payloads: (n, L) uint8
        C-contiguous — one framed result per row (see
        wire.serialize_results_batch(as_matrix=True))."""
        if not self._h or len(slots) == 0:
            return 0
        slots = np.ascontiguousarray(slots, np.int32)
        payloads = np.ascontiguousarray(payloads, np.uint8)
        return int(self._lib.vap_ingest_send_batch(
            self._h,
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(slots),
            payloads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            payloads.shape[1]))

    def send_results(self, slots: np.ndarray, gens: np.ndarray, t: float,
                     frames: np.ndarray, pad: int,
                     probs: np.ndarray, cols) -> int:
        """Snapshot + serialize + send one tick's results on the NATIVE
        sender thread, overlapped with the next tick.

        slots: (n,) int32 targets (negative = skip); gens: (n,) uint32
        dispatch-time generations (results are dropped if the slot was
        reused since — closes the dispatch->send race natively);
        frames: the FULL (capacity, 2, frame_samples) poll array this
        tick was dispatched from (f32, or raw int16 in emit_i16 mode —
        echo scaling 1/32768 happens natively); pad: left-context
        samples dropped from the echo; probs: (n, P) float32 result
        fields row-major; cols: per-field widths summing to P (field
        order after x1/x2 per the mode, runtime/server.RESULT_KEYS).

        Wire bytes are identical to serialize_results_batch +
        send_batch; the caller's arrays are free when the call
        returns."""
        if not self._h or len(slots) == 0:
            return 0
        slots = np.ascontiguousarray(slots, np.int32)
        gens = np.ascontiguousarray(gens, np.uint32)
        frames = np.ascontiguousarray(frames)
        probs = np.ascontiguousarray(probs, np.float32)
        cols = np.ascontiguousarray(cols, np.int32)
        i16 = frames.dtype == np.int16
        return int(self._lib.vap_ingest_send_results(
            self._h,
            slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            gens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(slots), float(t),
            frames.ctypes.data_as(ctypes.c_void_p), int(i16),
            frames.shape[-1], pad,
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            probs.shape[1] if probs.ndim == 2 else 0,
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(cols)))

    def send_pending(self) -> int:
        """Send-queue depth (snapshotted, not yet serialized)."""
        if not self._h:
            return 0
        return int(self._lib.vap_ingest_send_pending(self._h))

    def send_dropped(self) -> int:
        """Result ticks dropped whole by overload catch-up (sender
        more than 2 ticks behind)."""
        if not self._h:
            return 0
        return int(self._lib.vap_ingest_send_dropped(self._h))

    def generation(self, slot: int) -> int:
        """Per-slot allocation counter — compare across polls to detect
        a disconnected slot being reused by a NEW connection."""
        if not self._h:
            return 0
        return int(self._lib.vap_ingest_gen(self._h, slot))

    def close(self) -> None:
        if self._h:
            self._lib.vap_ingest_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
