"""Vap — high-level library API (the pip-`maai` `Vap` class analogue).

Capability contract from the reference (vap_realtime/model.py:22-260):
mode-switched model ("vap" / "vap_MC" / "bc" / "nod"), two audio sources
pulled in a worker thread at 160-sample hops, results pushed into a queue
consumed via blocking `get_result()`; checkpoints fetched from the
HuggingFace Hub `maai-kyoto/*` repos (vap_realtime/util.py:4-76).  Port
of `vap_realtime_tpu/api.py` on the port's `VapEngine`, which runs on the
card unless `device="cpu"` is passed.

Usage:
    from vap_realtime_tpu_torch.api import Vap
    from vap_realtime_tpu_torch.io.sources import Wav

    vap = Vap(mode="vap", frame_rate=20, context_len_sec=2.5,
              mic1=Wav("a.wav"), mic2=Wav("b.wav"),
              checkpoint_npz="weights.npz")
    vap.start_process()
    while True:
        result = vap.get_result()   # {"t", "x1", "x2", "p_now", ...}
"""

from __future__ import annotations

import atexit
import os
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.io.sources import Base
from vap_realtime_tpu_torch.runtime.engine import VapEngine

HF_REPO_IDS = {
    "vap_jp": "maai-kyoto/vap_jp",
    "vap_en": "maai-kyoto/vap_en",
    "vap_tri": "maai-kyoto/vap_tri",
    "vap_MC": "maai-kyoto/vap_MC",
    "vap_bc_jp": "maai-kyoto/vap_bc_jp",
    "vap_nod_jp": "maai-kyoto/vap_nod_jp",
}


def hf_checkpoint_file(mode: str, frame_rate: int, context_len_sec: float,
                       language: str = "jp") -> tuple:
    """(repo_id, filename) for the published checkpoints
    (vap_realtime/util.py:16-60)."""
    ms = int(context_len_sec * 1000)
    lang_tag = {"jp": "jp", "en": "eng", "tri": "tri_ecj"}.get(language)
    if mode == "vap":
        return (HF_REPO_IDS[f"vap_{language}"],
                f"vap_state_dict_{lang_tag}_{frame_rate}hz_{ms}msec.pt")
    if mode == "vap_MC":
        tag = {"jp": "jp", "en": "en", "tri": "tri"}[language]
        return (HF_REPO_IDS["vap_MC"],
                f"vap_state_dict_{tag}_{frame_rate}hz_{ms}msec_MC.pt")
    if mode == "bc":
        return (HF_REPO_IDS["vap_bc_jp"],
                f"vap-bc_state_dict_erica_{frame_rate}hz_{ms}msec.pt")
    if mode == "nod":
        return (HF_REPO_IDS["vap_nod_jp"],
                f"vap-nod_state_dict_erica_{frame_rate}hz_{ms}msec.pt")
    raise ValueError(f"Invalid mode: {mode}")


def load_vap_model(mode: str, frame_rate: int, context_len_sec: float,
                   language: str = "jp", cache_dir: Optional[str] = None,
                   force_download: bool = False) -> str:
    """Download (or locate cached) reference checkpoint via the HF Hub
    (needs `huggingface_hub` and the network).  Returns the local .pt
    path."""
    from huggingface_hub import hf_hub_download

    repo_id, filename = hf_checkpoint_file(mode, frame_rate,
                                           context_len_sec, language)
    return hf_hub_download(repo_id=repo_id, filename=filename,
                           cache_dir=cache_dir,
                           force_download=force_download)


def get_available_models(mode: str = "vap", language: str = "jp") -> list:
    """List checkpoint files on the HF repo (vap_realtime/util.py:71-76;
    needs `huggingface_hub` and the network)."""
    from huggingface_hub import list_repo_files

    key = f"vap_{language}" if mode == "vap" else {
        "vap_MC": "vap_MC", "bc": "vap_bc_jp", "nod": "vap_nod_jp"}[mode]
    return list(list_repo_files(HF_REPO_IDS[key]))


class Vap:
    """Socket-free streaming wrapper around two audio sources."""

    def __init__(self, mode: str, frame_rate: int, context_len_sec: float,
                 language: str = "jp",
                 mic1: Optional[Base] = None, mic2: Optional[Base] = None,
                 cpc_model: str = os.path.expanduser(
                     "~/.cache/cpc/60k_epoch4-d0f474de.pt"),
                 checkpoint_npz: Optional[str] = None,
                 params: Optional[dict] = None,
                 engine_path: str = "kv",
                 cache_dir: Optional[str] = None,
                 force_download: bool = False,
                 **engine_kwargs):
        """Weights: `params` (a numpy pytree), `checkpoint_npz`, or else
        the published checkpoint of this mode from the HF Hub with
        `cpc_model`.  engine_kwargs pass through to VapEngine (device,
        dtype, attend_impl, slots, quant_cache, ...); the engine runs on
        the card unless device="cpu"."""
        head_mode = {"vap": "vap", "vap_MC": "vap", "bc": "bc",
                     "nod": "nod"}[mode]
        cfg = VapConfig(frame_hz=frame_rate,
                        context_len_sec=context_len_sec, mode=head_mode)
        vap_model = None
        if params is None and checkpoint_npz is None:
            vap_model = load_vap_model(mode, frame_rate, context_len_sec,
                                       language, cache_dir, force_download)
        self.engine = VapEngine(cfg, params=params,
                                vap_model=vap_model, cpc_model=cpc_model,
                                checkpoint_npz=checkpoint_npz,
                                path=engine_path, **engine_kwargs)
        self.mode = mode
        self.mic1 = mic1
        self.mic2 = mic2
        self.frame_rate = frame_rate
        # the engine's chunk: overlapped frames (frame_samples, 320 of
        # them re-read) on kv / full / hybrid, fresh samples on the fast
        # paths (the JAX class always cuts overlapped frames)
        self.audio_frame_size = self.engine.chunk_samples
        self.frame_contxt_padding = self.engine.frame_contxt_padding
        self.result_dict_queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._atexit = False

    # --- worker loop (reference model.py:96-119) ---------------------------

    def worker(self) -> None:
        """Pulls 160-sample hops from both sources into frames for
        `process_vap`: on the overlapped-frame paths the first frame
        starts after 320 zero samples and each next one re-reads the last
        320 samples; the fast paths take disjoint fresh chunks."""
        pad = self.frame_contxt_padding
        x1 = np.zeros(pad)
        x2 = np.zeros(pad)
        while not self._stop.is_set():
            x1 = np.concatenate([x1, self.mic1.get_audio_data()])
            x2 = np.concatenate([x2, self.mic2.get_audio_data()])
            if len(x1) < self.audio_frame_size:
                continue
            self.process_vap(x1[:self.audio_frame_size],
                             x2[:self.audio_frame_size])
            x1 = x1[self.audio_frame_size - pad:]
            x2 = x2[self.audio_frame_size - pad:]

    def start_process(self) -> None:
        if self.mic1 is None or self.mic2 is None:
            raise ValueError("provide mic1 and mic2 audio sources")
        self.engine.warmup()
        self.mic1.start_process()
        self.mic2.start_process()
        self._stop.clear()
        self._thread = threading.Thread(target=self.worker, daemon=True)
        self._thread.start()
        # a daemon thread killed inside a device call at interpreter
        # shutdown can abort the process: always join the worker first
        if not self._atexit:
            atexit.register(self.stop_process)
            self._atexit = True

    def stop_process(self, timeout: float = 5.0) -> None:
        """Stop the worker thread and the audio sources.  Idempotent;
        also registered atexit so scripts that never call it exit
        cleanly."""
        self._stop.set()
        for mic in (self.mic1, self.mic2):
            stop = getattr(mic, "stop_process", None)
            if stop is not None:
                stop()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None

    def process_vap(self, x1: np.ndarray, x2: np.ndarray) -> Dict:
        """One frame through the engine; the result also goes into the
        queue `get_result` reads."""
        outs = self.engine.process(x1, x2)
        pad = self.frame_contxt_padding
        result: Dict = {"t": time.time(), "x1": np.asarray(x1[pad:]),
                        "x2": np.asarray(x2[pad:])}
        if self.mode in ("vap", "vap_MC"):
            result["p_now"] = outs["p_now"].tolist()
            result["p_future"] = outs["p_future"].tolist()
            result["vad"] = outs["vad"].tolist()
        elif self.mode == "bc":
            result["p_bc_react"] = float(outs["p_bc_react"])
            result["p_bc_emo"] = float(outs["p_bc_emo"])
        elif self.mode == "nod":
            result["p_bc"] = float(outs["p_bc"])
            result["p_nod_short"] = float(outs["p_nod_short"])
            result["p_nod_long"] = float(outs["p_nod_long"])
            result["p_nod_long_p"] = float(outs["p_nod_long_p"])
        self.result_dict_queue.put(result)
        return result

    def get_result(self, timeout: Optional[float] = None) -> Dict:
        """Blocking pop of the next per-frame result (model.py:259-260);
        raises queue.Empty after `timeout` seconds (None: waits)."""
        return self.result_dict_queue.get(timeout=timeout)
