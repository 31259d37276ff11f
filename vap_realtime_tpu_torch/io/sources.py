"""Audio sources — library input classes (reference: vap_realtime/input.py).

- `Base`: 160-sample (10 ms) 16 kHz chunk interface
- `Mic`: pyaudio microphone (gated import — optional dependency)
- `Wav`: WAV file replayed at realtime pacing
- `TCPReceiver`: accepts a remote audio producer (server socket -> queue)
- `TCPTransmitter`: pushes local mic/wav audio to a remote receiver
- `Zero`: silent channel (for mono setups, reference input/mic.py:56)

The port's own copy of `vap_realtime_tpu/io/sources.py` (numpy only).
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import List, Optional

import numpy as np

from vap_realtime_tpu_torch.io import wire
from vap_realtime_tpu_torch.io.audio import read_wav

FRAME_SIZE = 160  # 10 ms at 16 kHz (reference input.py:22-28)
SAMPLE_RATE = 16000


def available_mic_devices() -> List[dict]:
    """List input-capable audio devices (reference input.py:13-20)."""
    try:
        import pyaudio
    except ImportError:
        return []
    pa = pyaudio.PyAudio()
    out = []
    for i in range(pa.get_device_count()):
        info = pa.get_device_info_by_index(i)
        if info.get("maxInputChannels", 0) > 0:
            out.append({"index": i, "name": info["name"]})
    pa.terminate()
    return out


class Base:
    """One stream of 10 ms float chunks in [-1, 1]."""

    _stopped = False

    def start_process(self) -> None:  # pragma: no cover - interface
        pass

    def stop_process(self) -> None:
        """Unblock any pending get_audio_data and stop producing.  After
        stop, get_audio_data returns silence so consumer loops drain
        without blocking forever."""
        self._stopped = True

    def get_audio_data(self) -> np.ndarray:
        raise NotImplementedError

    def _drain_queue(self, q: "queue.Queue") -> np.ndarray:
        """Blocking queue pop that wakes up on stop (returns silence)."""
        while not self._stopped:
            try:
                return q.get(timeout=0.2)
            except queue.Empty:
                continue
        return np.zeros(FRAME_SIZE, np.float64)


class Zero(Base):
    """Silent channel, paced by wall clock."""

    def __init__(self):
        self._next = None

    def get_audio_data(self) -> np.ndarray:
        now = time.time()
        if self._next is None:
            self._next = now
        delay = self._next - now
        if delay > 0:
            time.sleep(delay)
        self._next += FRAME_SIZE / SAMPLE_RATE
        return np.zeros(FRAME_SIZE, np.float64)


class Mic(Base):
    """pyaudio microphone -> queue of 160-sample chunks
    (reference input.py:30-46)."""

    def __init__(self, device_index: Optional[int] = None, gain: float = 1.0):
        self.device_index = device_index
        self.gain = gain
        self.q: queue.Queue = queue.Queue()
        self._stream = None

    def start_process(self) -> None:
        import pyaudio  # optional dependency

        pa = pyaudio.PyAudio()

        def cb(in_data, frame_count, time_info, status):
            x = np.frombuffer(in_data, dtype=np.int16).astype(np.float64)
            self.q.put(x / 32768.0 * self.gain)
            return (None, pyaudio.paContinue)

        self._stream = pa.open(
            format=pyaudio.paInt16, channels=1, rate=SAMPLE_RATE,
            input=True, frames_per_buffer=FRAME_SIZE,
            input_device_index=self.device_index, stream_callback=cb)
        self._stream.start_stream()

    def stop_process(self) -> None:
        super().stop_process()
        if self._stream is not None:
            try:
                self._stream.stop_stream()
                self._stream.close()
            except OSError:
                pass
            self._stream = None

    def get_audio_data(self) -> np.ndarray:
        return self._drain_queue(self.q)


class Wav(Base):
    """WAV file source, emitting chunks at realtime pacing
    (reference input.py:48-86)."""

    def __init__(self, path: str, channel: int = 0, loop: bool = False,
                 realtime: bool = True):
        data, rate = read_wav(path)
        if rate != SAMPLE_RATE:
            raise ValueError(f"{path}: expected {SAMPLE_RATE} Hz, got {rate}")
        if data.ndim > 1:
            data = data[:, channel]
        self.data = data.astype(np.float64)
        self.loop = loop
        self.realtime = realtime
        self.pos = 0
        self._next: Optional[float] = None

    def start_process(self) -> None:
        self._next = None
        self.pos = 0

    def get_audio_data(self) -> np.ndarray:
        if self.realtime:
            now = time.time()
            if self._next is None:
                self._next = now
            delay = self._next - now
            if delay > 0:
                time.sleep(delay)
            self._next += FRAME_SIZE / SAMPLE_RATE
        chunk = self.data[self.pos:self.pos + FRAME_SIZE]
        self.pos += FRAME_SIZE
        if len(chunk) < FRAME_SIZE:
            if self.loop and len(self.data) >= FRAME_SIZE:
                self.pos = 0
                return self.get_audio_data()
            chunk = np.pad(chunk, (0, FRAME_SIZE - len(chunk)))
        return chunk

    @property
    def finished(self) -> bool:
        return self.pos >= len(self.data)


class TCPReceiver(Base):
    """Server socket accepting one float64-pair audio producer
    (reference input.py:88-127).  Yields the selected channel."""

    def __init__(self, ip: str = "127.0.0.1", port: int = 50007,
                 channel: int = 0):
        self.ip = ip
        self.port = port
        self.channel = channel
        self.q: queue.Queue = queue.Queue()
        self._started = False
        self._conn: socket.socket | None = None

    def start_process(self) -> None:
        if self._started:
            return
        self._started = True
        threading.Thread(target=self._serve, daemon=True).start()

    def stop_process(self) -> None:
        # closing the live connection unblocks the serve thread's
        # blocking _read_exact immediately (it otherwise waits for the
        # peer to send or disconnect)
        super().stop_process()
        conn = self._conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _serve(self) -> None:
        while not self._stopped:
            try:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind((self.ip, self.port))
                s.listen(1)
                s.settimeout(0.5)
                while not self._stopped:
                    try:
                        conn, _ = s.accept()
                    except socket.timeout:
                        continue
                    break
                else:
                    s.close()
                    return
                with conn:
                    self._conn = conn
                    while not self._stopped:
                        data = wire._read_exact(conn, 8 * 2 * FRAME_SIZE)
                        x1, x2 = wire.conv_bytearray_2_2floatarray(data)
                        self.q.put(x1 if self.channel == 0 else x2)
            except (ConnectionError, OSError):
                try:
                    s.close()
                except OSError:
                    pass
                time.sleep(0.1)
                continue
            finally:
                self._conn = None

    def get_audio_data(self) -> np.ndarray:
        return self._drain_queue(self.q)


class TCPTransmitter:
    """Forward a local source's chunks to a remote TCPReceiver
    (reference input.py:129-174).  Sends [x, 0] float64 pairs."""

    def __init__(self, source: Base, ip: str = "127.0.0.1",
                 port: int = 50007):
        self.source = source
        self.ip = ip
        self.port = port
        self._stopped = False
        self._sock: socket.socket | None = None

    def start_process(self) -> None:
        self.source.start_process()
        threading.Thread(target=self._run, daemon=True).start()

    def stop_process(self) -> None:
        self._stopped = True
        self.source.stop_process()
        # unblock a sendall stuck on a full peer buffer
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _run(self) -> None:
        sock = socket.create_connection((self.ip, self.port))
        self._sock = sock
        zeros = np.zeros(FRAME_SIZE)
        try:
            while not self._stopped:
                x = self.source.get_audio_data()
                sock.sendall(wire.conv_2floatarray_2_bytearray(x, zeros))
        except OSError:
            pass  # socket closed by stop_process
        finally:
            self._sock = None
            try:
                sock.close()
            except OSError:
                pass
