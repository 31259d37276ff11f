"""Command-line options the port's entry points share: where the weights
come from, and how the serving step runs.

Weights (`add_weight_args` / `load_weights`): `--synthetic_weights`,
`--checkpoint_npz` (a params pytree .npz) or `--vap_model` +
`--cpc_model` (the reference's .pt checkpoints), in that order of
precedence, as in the JAX package's entry points.  The step
(`add_step_args`): the engine path, slot policy, attend, int8 cache
(`add_quant_arg`, alone where an entry point declares the rest itself),
device and dtype, with the port's names (`kernel` / `kernel3` where the
JAX servers say `pallas` / `pallas3`; a bare `--quant_cache` means
"row").
"""

from __future__ import annotations

import argparse

from vap_realtime_tpu_torch.config import VapConfig
from vap_realtime_tpu_torch.runtime.arena import PATHS
from vap_realtime_tpu_torch.runtime.engine import Params, load_params
from vap_realtime_tpu_torch.runtime.incremental import SLOTS

WEIGHT_SOURCES = ("--checkpoint_npz, --vap_model with --cpc_model, or "
                  "--synthetic_weights")


def add_weight_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--vap_model", default=None,
                    help="the reference's VAP state_dict (.pt)")
    ap.add_argument("--cpc_model", default=None,
                    help="the reference's CPC checkpoint (.pt)")
    ap.add_argument("--checkpoint_npz", default=None,
                    help="params pytree .npz (weights/convert.py)")
    ap.add_argument("--synthetic_weights", action="store_true",
                    help="deterministic test weights (no checkpoint needed)")


def check_weight_args(ap: argparse.ArgumentParser,
                      args: argparse.Namespace) -> None:
    """Exits through `ap.error` when no source of weights was given."""
    if not (args.synthetic_weights or args.checkpoint_npz
            or (args.vap_model and args.cpc_model)):
        ap.error(f"give {WEIGHT_SOURCES}")


def load_weights(args: argparse.Namespace, cfg: VapConfig) -> Params:
    """The params pytree (numpy leaves) the weight options name."""
    if args.synthetic_weights:
        from vap_realtime_tpu_torch.weights.synthetic import synthetic_params
        return synthetic_params(cfg.frame_hz, mode=cfg.mode)
    return load_params(cfg, args.checkpoint_npz, args.vap_model,
                       args.cpc_model)


def add_step_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--engine_path", choices=list(PATHS), default="kv",
                    help="'kv' = chunked encoder + KV step; 'full' = "
                         "parity-exact full recompute (both take frames "
                         "with the 320-sample overlap); 'fast' = streaming "
                         "conv + KV step (fresh samples); 'hybrid' / "
                         "'fast_hybrid' = kv / fast with a full-trunk "
                         "resync every context_frames ticks")
    ap.add_argument("--slots", choices=list(SLOTS), default="staged",
                    help="KV write-slot policy: 'staged' (default) = exact "
                         "per-stream isolation with a merge every 8 ticks; "
                         "'stream' = per-frame row write (same contract); "
                         "'global' = one slot for streams that tick together")
    ap.add_argument("--attend_impl",
                    choices=["kernel", "kernel3", "grouped", "einsum"],
                    default="kernel",
                    help="'kernel' = the hand-written CUDA attend kernel; "
                         "'kernel3' = its compact-softmax body (needs "
                         "--slots stream or global); 'grouped' / 'einsum' "
                         "= plain PyTorch attention")
    add_quant_arg(ap)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights and state (default float32)")


def add_quant_arg(ap: argparse.ArgumentParser) -> None:
    """`--quant_cache`: the KV cache's format (`runtime/cache_format.py`),
    as every entry point with a KV step spells it."""
    ap.add_argument("--quant_cache", nargs="?", const="row", default=False,
                    choices=["row", "global"],
                    help="int8 KV cache (all but the full path): bare flag "
                         "or 'row' = per-row scales; 'global' = per-stream "
                         "frozen scales")
