# one card per process: `local_slice` (a rank's share of a batch) stands
# where the JAX package exports `make_mesh`
from vap_realtime_tpu_torch.parallel.mesh import (  # noqa: F401
    local_slice,
    replicate,
    shard_batch,
)
