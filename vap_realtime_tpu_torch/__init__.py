"""vap_realtime_tpu_torch — Voice Activity Projection on PyTorch and CUDA.

The PyTorch port of `vap_realtime_tpu`, for one NVIDIA Hopper card: the
same inputs, outputs, per-stream state semantics and wire bytes, with a
hand-written CUDA kernel for each of the JAX package's Pallas kernels
(built with nvcc on first use; the CPU runs their plain PyTorch
versions).  Entry points run on the card unless the caller asks for the
CPU.  Importing the package touches no CUDA and builds no kernel.
"""

__version__ = "0.1.0"

from vap_realtime_tpu_torch.config import VapConfig  # noqa: F401


def __getattr__(name):
    # lazy top-level conveniences (the runtime pulls in the model core)
    if name == "Vap":
        from vap_realtime_tpu_torch.api import Vap
        return Vap
    if name == "VapEngine":
        from vap_realtime_tpu_torch.runtime.engine import VapEngine
        return VapEngine
    if name == "VapModel":
        from vap_realtime_tpu_torch.models.vap import VapModel
        return VapModel
    raise AttributeError(name)
