"""Wire protocol — byte-compatible with the reference TCP contract.

Contract (reference: rvap/common/util.py, README.md:160-219):
- audio input packets: interleaved [ch1, ch2] float64 LE pairs
  (160-sample hops => 2560 bytes).
- result packets: float64 `t`, then uint32-LE length-prefixed float64
  arrays; key order per mode:
    vap: x1, x2, p_now[2], p_future[2], vad[2]
    bc:  x1, x2, p_bc_react, p_bc_emo
    nod: x1, x2, p_bc, p_nod_short, p_nod_long, p_nod_long_p
- framing on the result socket: 4-byte LE total-length prefix
  (vap_main.py:446-448).

The reference packs per-sample in Python loops; here numpy vectorizes —
output bytes are identical.  The reference function names are preserved
so existing client code ports by changing one import.

The port's own copy of `vap_realtime_tpu/io/wire.py`.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

BYTE_ORDER = "little"


# --- audio arrays ----------------------------------------------------------

def conv_2floatarray_2_bytearray(arr1, arr2) -> bytes:
    """Interleave two float arrays as [a1[0], a2[0], a1[1], ...] float64 LE."""
    a = np.empty((len(arr1), 2), dtype="<f8")
    a[:, 0] = np.asarray(arr1, dtype=np.float64)
    a[:, 1] = np.asarray(arr2, dtype=np.float64)
    return a.tobytes()


def conv_bytearray_2_2floatarray(barr: bytes) -> Tuple[np.ndarray, np.ndarray]:
    a = np.frombuffer(barr, dtype="<f8").reshape(-1, 2)
    return a[:, 0].copy(), a[:, 1].copy()


def conv_floatarray_2_byte(arr) -> bytes:
    return np.asarray(arr, dtype="<f8").tobytes()


def conv_bytearray_2_floatarray(barr: bytes) -> List[float]:
    return np.frombuffer(barr, dtype="<f8").tolist()


def _lp(arr) -> bytes:
    """uint32-LE length prefix + float64 payload."""
    a = np.atleast_1d(np.asarray(arr, dtype=np.float64))
    return len(a).to_bytes(4, BYTE_ORDER) + a.tobytes()


# --- result serialization --------------------------------------------------

_KEYS = {
    "vap": ("x1", "x2", "p_now", "p_future", "vad"),
    "bc": ("x1", "x2", "p_bc_react", "p_bc_emo"),
    "nod": ("x1", "x2", "p_bc", "p_nod_short", "p_nod_long", "p_nod_long_p"),
}


def serialize_result(result: Dict, mode: str = "vap") -> bytes:
    b = struct.pack("<d", float(result["t"]))
    for key in _KEYS[mode]:
        b += _lp(result[key])
    return b


def deserialize_result(barr: bytes, mode: str = "vap") -> Dict:
    out: Dict = {"t": struct.unpack("<d", barr[:8])[0]}
    idx = 8
    for key in _KEYS[mode]:
        n = struct.unpack("<I", barr[idx:idx + 4])[0]
        idx += 4
        out[key] = np.frombuffer(barr[idx:idx + 8 * n], dtype="<f8").tolist()
        idx += 8 * n
    return out


# reference-named aliases (rvap/common/util.py:122-322)
def conv_vapresult_2_bytearray(r):
    return serialize_result(r, "vap")


def conv_bytearray_2_vapresult(b):
    return deserialize_result(b, "vap")


def conv_vapresult_2_bytearray_bc(r):
    return serialize_result(r, "bc")


def conv_bytearray_2_vapresult_bc(b):
    return deserialize_result(b, "bc")


def conv_vapresult_2_bytearray_nod(r):
    return serialize_result(r, "nod")


def conv_bytearray_2_vapresult_nod(b):
    return deserialize_result(b, "nod")


def frame_result(payload: bytes) -> bytes:
    """Add the 4-byte LE total-length prefix used on the result socket."""
    return len(payload).to_bytes(4, BYTE_ORDER) + payload


def serialize_results_batch(t: float, fields: Dict[str, np.ndarray],
                            mode: str = "vap", as_matrix: bool = False):
    """Vectorized serialize_result + frame_result for a BATCH of
    results with identical field shapes.

    fields: {key: (n, k_key) array} for every key of `mode` (k_key may
    differ per key; x1/x2 are the audio echo).  Returns n framed byte
    strings, each byte-identical to
    ``frame_result(serialize_result(row, mode))``.

    The per-dict path costs ~30 us/result in float64 conversions and
    buffer concatenation — 125 ms/tick at 4096 streams, the serving
    tick's largest host-CPU item (tools/serving_bench.py r4).  Here
    every field converts in ONE vectorized op into a single (n, bytes)
    row matrix; the per-row cost is one memcpy.
    """
    keys = _KEYS[mode]
    cols = [np.asarray(fields[k], dtype="<f8") for k in keys]
    n = cols[0].shape[0]
    payload_len = 8 + sum(4 + 8 * c.shape[1] for c in cols)
    total = 4 + payload_len
    buf = np.empty((n, total), np.uint8)
    buf[:, 0:4] = np.frombuffer(
        payload_len.to_bytes(4, BYTE_ORDER), np.uint8)
    buf[:, 4:12] = np.frombuffer(struct.pack("<d", float(t)), np.uint8)
    off = 12
    for c in cols:
        k = c.shape[1]
        buf[:, off:off + 4] = np.frombuffer(
            k.to_bytes(4, BYTE_ORDER), np.uint8)
        off += 4
        buf[:, off:off + 8 * k] = c.view(np.uint8).reshape(n, 8 * k)
        off += 8 * k
    if as_matrix:
        return buf        # (n, total) uint8 — for NativeIngest.send_batch
    return [buf[i].tobytes() for i in range(n)]


def read_framed(sock) -> bytes:
    """Read one length-prefixed message from a blocking socket."""
    head = _read_exact(sock, 4)
    n = int.from_bytes(head, BYTE_ORDER)
    return _read_exact(sock, n)


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("socket closed")
        buf += part
    return buf
