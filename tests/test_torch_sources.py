"""PyTorch port: the audio sources of `io/sources.py` against the JAX
package's on the same files and over the same loopback wire."""

import threading
import time

import numpy as np
import pytest

from vap_realtime_tpu.io import sources as jax_sources
from vap_realtime_tpu_torch.io import sources
from vap_realtime_tpu_torch.io.audio import write_wav
from vap_realtime_tpu_torch.runtime.server import _listener


def _free_port() -> int:
    with _listener("127.0.0.1", 0, 1) as s:
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    """0.5 s of 16 kHz noise plus a ragged 70-sample tail: 51 chunks,
    the last one zero-padded."""
    rs = np.random.RandomState(8)
    path = str(tmp_path_factory.mktemp("src") / "a.wav")
    write_wav(path, np.clip(0.2 * rs.randn(8070, 2), -1, 1))
    return path


def test_zero_matches_jax_and_is_paced():
    """Zero gives 160 float64 zeros a call, as the JAX source does, paced
    by the wall clock at 10 ms a chunk."""
    z, jz = sources.Zero(), jax_sources.Zero()
    t0 = time.perf_counter()
    chunks = [z.get_audio_data() for _ in range(4)]
    took = time.perf_counter() - t0
    for c in chunks:
        want = jz.get_audio_data()
        assert c.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(c, want)
    assert took >= 0.025


@pytest.mark.parametrize("channel,loop", [(0, False), (1, False), (0, True)])
def test_wav_matches_jax(wav_file, channel, loop):
    """Wav(realtime=False) gives the JAX source's chunks, bit for bit:
    the selected channel, the zero-padded last chunk, and with loop=True
    the wrap to the start; `finished` agrees."""
    w = sources.Wav(wav_file, channel=channel, loop=loop, realtime=False)
    jw = jax_sources.Wav(wav_file, channel=channel, loop=loop,
                         realtime=False)
    w.start_process()
    jw.start_process()
    for i in range(60):
        got, want = w.get_audio_data(), jw.get_audio_data()
        assert got.shape == (160,) and got.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=f"chunk {i}")
        assert w.finished == jw.finished


def test_wav_rejects_other_rates(tmp_path):
    path = str(tmp_path / "8k.wav")
    write_wav(path, np.zeros(800), rate=8000)
    with pytest.raises(ValueError, match="16000 Hz"):
        sources.Wav(path)


def _loopback(receiver_cls, transmitter_cls, wav_file, n=55):
    """A transmitter streaming Wav(realtime=False) chunks over loopback
    into a receiver; returns the first n chunks the receiver yields.  A
    watchdog stops the receiver after 20 s, so a lost connection fails
    the test instead of hanging it."""
    port = _free_port()
    rx = receiver_cls(port=port, channel=0)
    rx.start_process()
    time.sleep(0.3)                      # the receiver listens
    tx = transmitter_cls(sources.Wav(wav_file, realtime=False), port=port)
    watchdog = threading.Timer(20.0, rx.stop_process)
    watchdog.start()
    try:
        tx.start_process()
        return [rx.get_audio_data() for _ in range(n)]
    finally:
        watchdog.cancel()
        tx.stop_process()
        rx.stop_process()


@pytest.mark.parametrize("pair", ["port", "jax_to_port", "port_to_jax"])
def test_tcp_loopback_matches_wav(wav_file, pair):
    """TCPTransmitter -> TCPReceiver over loopback yields the WAV's own
    chunks (the JAX Wav's), then silence after the file ends; the port's
    classes also interoperate with the JAX package's in both
    directions."""
    rx, tx = {"port": (sources.TCPReceiver, sources.TCPTransmitter),
              "jax_to_port": (sources.TCPReceiver,
                              jax_sources.TCPTransmitter),
              "port_to_jax": (jax_sources.TCPReceiver,
                              sources.TCPTransmitter)}[pair]
    got = _loopback(rx, tx, wav_file)
    jw = jax_sources.Wav(wav_file, realtime=False)
    for i, chunk in enumerate(got):
        np.testing.assert_array_equal(chunk, jw.get_audio_data(),
                                      err_msg=f"chunk {i}")
    assert np.abs(got[10]).max() > 0 and not np.any(got[-1])


def test_available_mic_devices_without_pyaudio():
    """Without pyaudio there are no microphones to list (both packages
    import it lazily); with it, each entry has an index and a name."""
    devs = sources.available_mic_devices()
    assert devs == jax_sources.available_mic_devices() or all(
        set(d) == {"index", "name"} for d in devs)
