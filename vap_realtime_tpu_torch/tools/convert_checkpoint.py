"""Convert the reference's PyTorch checkpoints to a params pytree npz.

Port of `tools/convert_checkpoint.py`.  Reads the VAP state_dict and the
CPC checkpoint (`weights/convert.py` `load_torch_checkpoint`) on the host
and writes the npz every entry point takes as `--checkpoint_npz`
(`save_pytree_npz`).  It touches no device, so it has no `--device`.

Run: python -m vap_realtime_tpu_torch.tools.convert_checkpoint \\
        --vap_model vap_state_dict_jp_20hz_2500msec.pt \\
        --cpc_model 60k_epoch4-d0f474de.pt --out vap_jp_20hz.npz
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from vap_realtime_tpu_torch.weights.convert import (
    load_torch_checkpoint, save_pytree_npz, tree_items,
)


def main(argv: Optional[list] = None) -> int:
    """Returns the number of parameters written."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vap_model", required=True)
    ap.add_argument("--cpc_model", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--channel_layers", type=int, default=1)
    ap.add_argument("--cross_layers", type=int, default=3)
    args = ap.parse_args(argv)

    params = load_torch_checkpoint(args.vap_model, args.cpc_model,
                                   args.channel_layers, args.cross_layers)
    save_pytree_npz(args.out, params)
    n = sum(np.asarray(x).size for _, x in tree_items(params))
    print(f"wrote {args.out} ({n/1e6:.2f} M params)")
    return n


if __name__ == "__main__":
    main()
