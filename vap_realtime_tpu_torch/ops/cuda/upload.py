"""The host->device copy of a piece of a row-major host array.

`upload_rows` copies an (R, W) view of pinned host memory whose rows lie
a pitch apart (a column range of the arena's (capacity, 2, L) frame
array seen as 2 capacity rows of L) into an (R, W) view of a device
buffer, asynchronously on a given stream: one `cudaMemcpy2DAsync`
(`csrc/upload.cu`), bound through ctypes like the kernels.  PyTorch's own
copy of such a strided host view stages it through a contiguous pageable
temporary, and the transfer turns synchronous.
"""

from __future__ import annotations

import ctypes
import functools

import torch


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from vap_realtime_tpu_torch.ops.cuda.build import load

    lib = load("upload")
    fn = lib.upload_rows
    fn.restype = ctypes.c_int
    S = ctypes.c_size_t
    # dst, dpitch, src, spitch, width, height (bytes, rows), stream
    fn.argtypes = [ctypes.c_void_p, S, ctypes.c_void_p, S, S, S,
                   ctypes.c_void_p]
    return lib


def upload_rows(dst: torch.Tensor, src: torch.Tensor,
                stream: torch.cuda.Stream) -> None:
    """dst (R, W) on the card <- src (R, W) in pinned host memory, each
    with unit stride along W, queued on `stream`.  The caller keeps src
    unchanged until the copy has run."""
    es = src.element_size()
    if (src.dim() != 2 or src.shape != dst.shape or src.dtype != dst.dtype
            or src.stride(1) != 1 or dst.stride(1) != 1
            or dst.device.type != "cuda" or src.device.type != "cpu"):
        raise ValueError(f"upload_rows: a (R, W) host view into a device "
                         f"view of one shape and dtype, unit stride along "
                         f"W; got {tuple(src.shape)} {src.dtype} -> "
                         f"{tuple(dst.shape)} {dst.dtype} on {dst.device}")
    rc = _lib().upload_rows(dst.data_ptr(), dst.stride(0) * es,
                            src.data_ptr(), src.stride(0) * es,
                            src.shape[1] * es, src.shape[0],
                            stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upload_rows: cudaMemcpy2DAsync failed, "
                           f"cudaError {rc}")
