"""Seeded weights for a configuration, made on the device in a few calls.

One `torch.randn` over every weight of the model at once, one
per-element scale and one offset (each expanded from a per-leaf value by
one `repeat_interleave`), rounded once to the dtype the weights are
served in, then copied to the host in one transfer.  The result is the
port's params tree (the layout of `weights/convert.py`) with float32
numpy leaves, which is what the port's entry points take; the reference
gets the very same arrays.

Scales follow a trained network's, not a near-uniform one's: every conv,
linear and LSTM matrix N(0, 1/fan_in), biases N(0, 0.05^2), norm gains
1 + N(0, 0.1^2) and norm shifts N(0, 0.1^2).  So the heads' outputs move
with the audio, and a precision fault moves them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (kernel, stride) of the 5 CPC convs (encoder_components.py:83-92)
CPC_CONVS = ((10, 5), (8, 4), (4, 2), (4, 2), (4, 2))


def spec(model: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(path, shape, kind, fan_in) of every leaf, in one fixed order.
    kind: "w" (N(0, 1/fan_in)), "b" (bias), "g" (norm gain), "s" (norm
    shift).  Paths use "/" between keys and "i#" for list items."""
    D = model["dim"]
    E = model["encoder_dim"]
    F = D * model["dff_k"]
    kd = 100 // model["frame_hz"]
    out = []
    cin = 1
    for i, (k, _s) in enumerate(CPC_CONVS):
        out += [(f"encoder/conv{i}/w", (E, cin, k), "w", cin * k),
                (f"encoder/conv{i}/b", (E,), "b", 0),
                (f"encoder/norm{i}/w", (E, 1), "g", 0),
                (f"encoder/norm{i}/b", (E, 1), "s", 0)]
        cin = E
    out += [("encoder/lstm/w_ih", (4 * E, E), "w", E),
            ("encoder/lstm/w_hh", (4 * E, E), "w", E),
            ("encoder/lstm/b_ih", (4 * E,), "b", 0),
            ("encoder/lstm/b_hh", (4 * E,), "b", 0),
            ("encoder/down_conv/w", (D, E, kd), "w", E * kd),
            ("encoder/down_conv/b", (D,), "b", 0),
            ("encoder/down_ln/w", (D,), "g", 0),
            ("encoder/down_ln/b", (D,), "s", 0)]

    def layer(prefix, cross):
        rows = [(f"{prefix}/ln_self/w", (D,), "g", 0),
                (f"{prefix}/ln_self/b", (D,), "s", 0),
                (f"{prefix}/ln_ffn/w", (D,), "g", 0),
                (f"{prefix}/ln_ffn/b", (D,), "s", 0)]
        rows += [(f"{prefix}/attn/{n}", (D, D), "w", D)
                 for n in ("q", "k", "v", "proj")]
        rows += [(f"{prefix}/ffn/w1", (F, D), "w", D),
                 (f"{prefix}/ffn/w2", (D, F), "w", F)]
        if cross:
            rows += [(f"{prefix}/ln_src/w", (D,), "g", 0),
                     (f"{prefix}/ln_src/b", (D,), "s", 0)]
            rows += [(f"{prefix}/attn_cross/{n}", (D, D), "w", D)
                     for n in ("q", "k", "v", "proj")]
        return rows

    for i in range(model["channel_layers"]):
        out += layer(f"ar_channel/layers/{i}#", False)
    for i in range(model["cross_layers"]):
        out += layer(f"ar/layers/{i}#", True)
    out += [("ar/combinator/h0_a", (D, D), "w", D),
            ("ar/combinator/h0_b", (D, D), "w", D),
            ("ar/combinator/ln/w", (D,), "g", 0),
            ("ar/combinator/ln/b", (D,), "s", 0)]

    def head(name, n):
        return [(f"{name}/w", (n, D), "w", D), (f"{name}/b", (n,), "b", 0)]

    out += head("vap_head", 2 ** (2 * len(model.get("bin_times",
                                                   (0.2, 0.4, 0.6, 0.8)))))
    out += head("va_classifier", 1)
    if model["mode"] == "bc":
        out += head("bc_head", 3)
    elif model["mode"] == "nod":
        out += head("nod_head", 4) + head("bc_head", 1)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """{"a/b/0#/c": leaf} -> nested dicts, "i#" levels as lists."""
    root: Dict = {}
    for name, leaf in flat.items():
        node = root
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.endswith("#") for k in node):
            return [fix(node[f"{i}#"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def make_params(model: Dict, seed: int, device, serve_dtype) -> Dict:
    """The params tree (float32 numpy leaves whose values are exact in
    `serve_dtype`) made from `seed` on `device`."""
    import torch

    from vapbench.common import sub_seed

    leaves = spec(model)
    sizes = [int(np.prod(s)) for _, s, _, _ in leaves]
    std = {"w": None, "b": 0.05, "g": 0.1, "s": 0.1}
    scale = torch.tensor([std[k] if k != "w" else fan ** -0.5
                          for _, _, k, fan in leaves], dtype=torch.float32,
                         device=device)
    offset = torch.tensor([1.0 if k == "g" else 0.0 for _, _, k, _ in leaves],
                          dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = (flat * scale.repeat_interleave(counts)
            + offset.repeat_interleave(counts))
    host = flat.to(serve_dtype).float().cpu().numpy()
    out, at = {}, 0
    for (name, shape, _, _), n in zip(leaves, sizes):
        out[name] = host[at:at + n].reshape(shape)
        at += n
    return unflatten(out)


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) of a params tree in its own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}{i}#/")
    else:
        yield prefix[:-1], tree
