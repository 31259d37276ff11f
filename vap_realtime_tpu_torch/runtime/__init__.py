from vap_realtime_tpu_torch.runtime.streaming import (  # noqa: F401
    StreamState,
    init_stream_state,
    stream_step,
)
