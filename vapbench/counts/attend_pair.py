"""K2, `csrc/attend_pair.cu` `attend_pair_kernel` on the staged bf16 body:
one launch serves one layer phase's twin attentions for every stream.

Bytes, each input byte read once and each output byte written once: the
phase's ring plane (B, T, 4D), its stage plane (S, B, 4D), the ring and
stage ages (float32), q / k / v of the current frame (B, 2, D) each, and
the output (B, 2, D).  The bound is bytes over the HBM bandwidth."""


def launch_bytes(B: int, T: int, S: int, D: int = 256,
                 elt: int = 2) -> int:
    ring = B * T * 4 * D * elt
    stage = S * B * 4 * D * elt
    ages = (B * T + S * B) * 4
    qkv_out = 4 * B * 2 * D * elt
    return ring + stage + ages + qkv_out


def bound_s(B: int, T: int, S: int, peaks: dict, D: int = 256,
            elt: int = 2) -> float:
    return launch_bytes(B, T, S, D, elt) / peaks["hbm_bytes_per_s"]
