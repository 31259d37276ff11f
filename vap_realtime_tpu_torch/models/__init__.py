from vap_realtime_tpu_torch.models.vap import (  # noqa: F401
    VapModel,
    init_vap_params,
)
