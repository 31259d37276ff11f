from vap_realtime_tpu_torch.ops.basic import (  # noqa: F401
    channel_norm,
    conv1d,
    gelu,
    gru,
    gru_cell,
    layer_norm,
    linear,
    lstm,
    lstm_cell,
)
