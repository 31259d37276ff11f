"""Checkpoint import: PyTorch reference state_dicts -> params pytree.

Replicates the reference's loading contract (SURVEY.md §5-Checkpoint):

- VAP checkpoints are flat ``state_dict`` .pt files whose `encoder.*` keys
  cover ONLY the downsample conv/LN; the CPC conv stack + GRU come from the
  separate CPC checkpoint's ``checkpoint["weights"]``
  (reference: rvap/vap_main/vap_main.py:199-212,
  encoder_components.py:370-404).
- The downsample conv kernel size comes from the checkpoint tensor itself
  (= 100//frame_hz, train/encoder.py:33-34), not the constructed module —
  here the kernel is simply taken from the array shape.
- Both realtime channel encoders share the single `encoder.*` namespace;
  our pytree stores one copy used by both channels.

`convert_state_dict` works on {name: np.ndarray}; `load_torch_checkpoint`
reads the reference's .pt files into it; `params_to_torch` turns the
resulting numpy pytree into the port's nested dict of tensors.  The
port's own copy of `vap_realtime_tpu/weights/convert.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Params = Dict[str, Any]


def _t(arr) -> np.ndarray:
    return np.asarray(arr, dtype=np.float32)


def _attn(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {
        "q": _t(sd[f"{prefix}.query.weight"]),
        "k": _t(sd[f"{prefix}.key.weight"]),
        "v": _t(sd[f"{prefix}.value.weight"]),
        "proj": _t(sd[f"{prefix}.proj.weight"]),
    }


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    return {"w": _t(sd[f"{prefix}.weight"]), "b": _t(sd[f"{prefix}.bias"])}


def _layer(sd: Mapping[str, np.ndarray], prefix: str, cross: bool) -> Params:
    p: Params = {
        "ln_self": _ln(sd, f"{prefix}.ln_self_attn"),
        "ln_ffn": _ln(sd, f"{prefix}.ln_ffnetwork"),
        "attn": _attn(sd, f"{prefix}.mha"),
        "ffn": {"w1": _t(sd[f"{prefix}.ffnetwork.0.weight"]),
                "w2": _t(sd[f"{prefix}.ffnetwork.3.weight"])},
    }
    if cross:
        p["ln_src"] = _ln(sd, f"{prefix}.ln_src_attn")
        p["attn_cross"] = _attn(sd, f"{prefix}.mha_cross")
    return p


def convert_state_dict(vap_sd: Mapping[str, np.ndarray],
                       cpc_weights: Mapping[str, np.ndarray],
                       channel_layers: int = 1,
                       cross_layers: int = 3) -> Params:
    """Build the params pytree from reference-format arrays.

    vap_sd: the VAP checkpoint state_dict (flat name -> array).
    cpc_weights: the CPC checkpoint's "weights" dict (gEncoder.*/gAR.*).
    """
    enc: Params = {}
    for i in range(5):
        enc[f"conv{i}"] = {"w": _t(cpc_weights[f"gEncoder.conv{i}.weight"]),
                           "b": _t(cpc_weights[f"gEncoder.conv{i}.bias"])}
        # ChannelNorm affine params stored (1, C, 1) -> keep (C, 1)
        enc[f"norm{i}"] = {
            "w": _t(cpc_weights[f"gEncoder.batchNorm{i}.weight"])[0],
            "b": _t(cpc_weights[f"gEncoder.batchNorm{i}.bias"])[0]}
    # 1-layer LSTM context net (load_CPC default arMode="LSTM";
    # encoder_components.py:326-329) — gates ordered i,f,g,o (torch).
    enc["lstm"] = {
        "w_ih": _t(cpc_weights["gAR.baseNet.weight_ih_l0"]),
        "w_hh": _t(cpc_weights["gAR.baseNet.weight_hh_l0"]),
        "b_ih": _t(cpc_weights["gAR.baseNet.bias_ih_l0"]),
        "b_hh": _t(cpc_weights["gAR.baseNet.bias_hh_l0"]),
    }
    # Downsample from the VAP checkpoint (manual patch in the reference,
    # vap_main.py:203-212); kernel size is defined by the tensor shape.
    enc["down_conv"] = {"w": _t(vap_sd["encoder.downsample.1.weight"]),
                        "b": _t(vap_sd["encoder.downsample.1.bias"])}
    enc["down_ln"] = {"w": _t(vap_sd["encoder.downsample.2.ln.weight"]),
                      "b": _t(vap_sd["encoder.downsample.2.ln.bias"])}

    params: Params = {
        "encoder": enc,
        "ar_channel": {"layers": [
            _layer(vap_sd, f"ar_channel.layers.{i}", cross=False)
            for i in range(channel_layers)]},
        "ar": {
            "layers": [_layer(vap_sd, f"ar.layers.{i}", cross=True)
                       for i in range(cross_layers)],
            "combinator": {
                "h0_a": _t(vap_sd["ar.combinator.h0_a.weight"]),
                "h0_b": _t(vap_sd["ar.combinator.h0_b.weight"]),
                "ln": _ln(vap_sd, "ar.combinator.ln"),
            },
        },
        "vap_head": {"w": _t(vap_sd["vap_head.weight"]),
                     "b": _t(vap_sd["vap_head.bias"])},
        "va_classifier": {"w": _t(vap_sd["va_classifier.weight"]),
                          "b": _t(vap_sd["va_classifier.bias"])},
    }
    if "bc_head.weight" in vap_sd:
        params["bc_head"] = {"w": _t(vap_sd["bc_head.weight"]),
                             "b": _t(vap_sd["bc_head.bias"])}
    if "nod_head.weight" in vap_sd:
        params["nod_head"] = {"w": _t(vap_sd["nod_head.weight"]),
                              "b": _t(vap_sd["nod_head.bias"])}
    for lid_key in ("lid_classifier", "lid_classifier_middle"):
        if f"{lid_key}.weight" in vap_sd:
            params[lid_key] = {"w": _t(vap_sd[f"{lid_key}.weight"]),
                               "b": _t(vap_sd[f"{lid_key}.bias"])}
    return params


def load_torch_checkpoint(vap_path: str, cpc_path: str,
                          channel_layers: int = 1,
                          cross_layers: int = 3) -> Params:
    """Load the reference's published .pt checkpoints (the VAP state_dict
    and the CPC checkpoint, whose arrays sit under "weights") on the CPU
    and convert them: the same numpy pytree as `convert_state_dict`."""
    vap_sd = torch.load(vap_path, map_location="cpu", weights_only=True)
    cpc = torch.load(cpc_path, map_location="cpu", weights_only=True)
    cpc_w = cpc["weights"] if "weights" in cpc else cpc

    def to_np(d):
        return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in d.items()}

    return convert_state_dict(to_np(vap_sd), to_np(cpc_w), channel_layers,
                              cross_layers)


# ----------------------------------------------------------------------------
# npz (de)serialization of pytrees — framework-native checkpoint format
# ----------------------------------------------------------------------------

def tree_items(tree: Any, prefix: str = ""):
    """(name, leaf) for every leaf of a params tree, in order, named as in
    the npz checkpoints: dict keys joined by "/", list index i as "i#"
    ("ar/layers/0#/attn/q")."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}#/")
    else:
        yield prefix[:-1], tree


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in tree_items(tree, prefix)}


def _unflatten(flat: Mapping[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for name, arr in flat.items():
        parts = name.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.endswith("#") for k in node):
            return [fix(node[f"{i}#"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_pytree_npz(path: str, tree: Any) -> None:
    np.savez(path, **_flatten(tree))


def load_pytree_npz(path: str) -> Any:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def params_to_numpy(tree: Any) -> Any:
    """Params pytree of tensors (on any device, with or without grad) ->
    the same nesting with numpy copies on the host (never views of the
    tensors, which an optimiser goes on updating in place)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return np.array(tree.detach().cpu())
    return np.array(tree)


def params_to_torch(tree: Any, device=None, dtype=None) -> Any:
    """Params pytree of numpy (or array-like) leaves -> the same nesting
    of dicts and lists with torch tensors as leaves (same leaf paths).

    device: torch device for every leaf (None = CPU); dtype: cast every
    floating leaf to it (None = keep float32).  Weights are read-only in
    inference, so leaves never require grad.
    """
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_torch(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t
