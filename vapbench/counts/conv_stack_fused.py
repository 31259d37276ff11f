"""K7, `csrc/conv_stack_fused.cu` (bf16: `conv0_kernel` then four
`conv_layer_kernel` launches): the streaming CPC conv stack over each
channel-stream's fresh samples.

Operations: 2 * out_frames * C_out * C_in * k for each conv (the
ChannelNorm and ReLU are not counted), with the strides (5, 4, 2, 2, 2)
and kernels (10, 8, 4, 4, 4) of the CPC stack.  The bound is operations
over the bf16 tensor peak."""

CONVS = ((10, 5), (8, 4), (4, 2), (4, 2), (4, 2))


def call_ops(channel_streams: int, samples: int, C: int = 256) -> int:
    n = samples
    cin = 1
    ops = 0
    for k, s in CONVS:
        n //= s
        ops += 2 * n * C * cin * k
        cin = C
    return channel_streams * ops


def bound_s(channel_streams: int, samples: int, peaks: dict,
            C: int = 256) -> float:
    return call_ops(channel_streams, samples, C) / peaks["bf16_flops"]
