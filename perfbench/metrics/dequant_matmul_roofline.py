"""``csrc/dequant_matmul.cu``'s bf16 kernel against its roofline: six
launches an encoder layer (q, k, v, o, ffn1, ffn2) at M = bucket x text
length rows, each bounded by its bf16 operations or its bytes."""

from perfbench.counts import dequant_matmul_bound_ms
from perfbench.metrics._roofline import share


def read(ctx):
    enc = ctx["cfg"]["text_encoder"]
    s = ctx["cfg"]["ensemble"]["text_len"]

    def per_batch(rows):
        n = 6 * enc["num_layers"]
        return n, n * dequant_matmul_bound_ms(enc, rows * s) * 1e-3

    return share(ctx, "dequant_matmul_bf16_kernel", per_batch)
