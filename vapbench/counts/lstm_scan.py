"""K5, `csrc/lstm_scan.cu` (`lstm_seq_kernel`, the sequence body of the
training encoder; `lstm_scan_kernel`, the serving body): the LSTM's
recurrence h_{t-1} @ W_hh^T over B streams and T steps, in 3xTF32 (three
TF32 products per float32 product).

Operations: 3 * 2 * B * T * H * 4H TF32 operations, as PERF.md's kernel
table counts them; the input projection runs outside the kernel.  The
bound is operations over the TF32 tensor peak."""


def call_ops(B: int, T: int, H: int = 256) -> int:
    return 3 * 2 * B * T * H * 4 * H


def bound_s(B: int, T: int, peaks: dict, H: int = 256) -> float:
    return call_ops(B, T, H) / peaks["tf32_flops"]
