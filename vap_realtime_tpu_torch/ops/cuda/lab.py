"""The cache-read floor: CUDA kernel wrapper + plain version.

`cache_read_all` replaces the TPU lab kernel `read_all`
(tools/component_bench.py:393, body `_sum_kernel`:383, K12), which the
component bench times to learn how fast the whole KV cache can be
streamed: the float32 sums over (B, P, T) of a (B, P, T, 4D) phase-major
cache, one (1, 4D) float32 row.  The kernel is in
`vap_realtime_tpu_torch/csrc/cache_read.cu` (16-byte vector loads, a
partial row per block, a second pass that adds them in block order: no
float atomics, so the card's result does not change from run to run); it
takes float32, bf16 and int8 caches (the lab's `q8_*` variants read an
int8 cache).

The TPU kernel is a closure inside the JAX tool's `main()`, so nothing
can import it: the tests hold `cache_read_all_plain` against the numpy
statement of `_sum_kernel` instead.

Bound on the H100: bytes, the cache read once (2.94 GB in bf16 at
B=4096, T=50: 0.877 ms at 3.35 TB/s).  On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs the plain
version.  `cache_read_all.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vap_realtime_tpu_torch.ops.cuda.build import load

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_THREADS = 256     # threads per block of the first pass (cache_read.cu)
_BLOCKS = 132 * 8  # first-pass blocks: eight per SM of the H100


def cache_read_all_plain(cache: Tensor) -> Tensor:
    """(B, P, T, X) cache -> (1, X) float32: the sum of float32(cache)
    over (B, P, T)."""
    return cache.float().sum((0, 1, 2))[None]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("cache_read")
    fn = lib.cache_read_launch
    fn.restype = ctypes.c_int
    P = ctypes.c_void_p
    # dtype, x, rows, cols16, partial, nblk, out, stream
    fn.argtypes = [ctypes.c_int, P, ctypes.c_longlong, ctypes.c_int, P,
                   ctypes.c_int, P, P]
    return lib


def cache_read_all(cache: Tensor) -> Tensor:
    """(B, P, T, X) float32 / bf16 / int8 cache -> (1, X) float32 column
    sums over (B, P, T) (see the module docstring)."""
    if cache.device.type == "cpu":
        return cache_read_all_plain(cache)

    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"cache_read_all: {msg}")

    check(cache.device.type == "cuda", f"unsupported device {cache.device}")
    check(cache.dtype in _DTYPES, f"cache dtype {cache.dtype} (float32, "
                                  f"bfloat16 or int8)")
    check(cache.dim() == 4 and cache.is_contiguous(),
          "cache must be a contiguous (B, P, T, X) tensor")
    X = cache.shape[-1]
    row_bytes = X * cache.element_size()
    cols16 = row_bytes // 16
    check(row_bytes % 16 == 0 and 0 < cols16 <= _THREADS
          and _THREADS % cols16 == 0,
          f"a row of {row_bytes} bytes must be a whole number of 16-byte "
          f"chunks that divides {_THREADS}")
    check(cache.data_ptr() % 16 == 0, "cache must be 16-byte aligned")
    rows = cache.numel() // X
    nblk = max(1, min(_BLOCKS, -(-rows // (_THREADS // cols16))))
    partial = torch.empty((nblk, X), dtype=torch.float32,
                          device=cache.device)
    out = torch.empty((1, X), dtype=torch.float32, device=cache.device)
    with torch.cuda.device(cache.device):
        rc = _lib().cache_read_launch(
            _DTYPES[cache.dtype], cache.data_ptr(), rows, cols16,
            partial.data_ptr(), nblk, out.data_ptr(),
            torch.cuda.current_stream(cache.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cache_read_all: kernel launch failed, "
                           f"cudaError {rc}")
    cache_read_all.launches += 1
    return out


cache_read_all.launches = 0
