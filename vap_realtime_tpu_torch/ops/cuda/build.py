"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Every `*.cu` under `vap_realtime_tpu_torch/csrc/` is one kernel library
with a plain C interface, compiled for Hopper (`sm_90a`) into
`build/lib<name>.so` at the repository root on first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds.  `build_all`
starts one nvcc per source at once and waits for all of them.  A library
newer than its source is reused.  ptxas's register / spill report lands
in `build/lib<name>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import Dict, List, Optional

PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(os.path.dirname(PKG), "build")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(src))


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the named kernel sources (default: all) in parallel.

    Returns {name: ptxas report}; raises if any nvcc fails.  Each library
    is written to a temporary name and renamed, so a concurrent loader
    never sees a half-written file.
    """
    names = sources() if names is None else names
    todo = [n for n in names if _stale(n)]
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = lib_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        with open(lib_path(n)[:-3] + ".log", "w") as f:
            f.write(log)
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{log[-4000:]}")
            continue
        os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: report(n) for n in names}


def report(name: str) -> str:
    """The ptxas report of the last build of `name` ('' if reused)."""
    log = lib_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if missing or stale."""
    if _stale(name):
        build_all([name])
    return ctypes.CDLL(lib_path(name))
