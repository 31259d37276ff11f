from vap_realtime_tpu_torch.weights.convert import (  # noqa: F401
    convert_state_dict,
    load_torch_checkpoint,
    load_pytree_npz,
    save_pytree_npz,
)
