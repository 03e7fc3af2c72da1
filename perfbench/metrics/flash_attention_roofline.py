"""``csrc/attention.cu``'s flash kernel against its roofline: one launch an
encoder layer over the bucket's rows, bounded by its operations at the
3xTF32 rate (f32-accurate products on the tensor cores) or its bytes."""

from perfbench.counts import attention_bound_ms
from perfbench.metrics._roofline import share


def read(ctx):
    enc = ctx["cfg"]["text_encoder"]
    s = ctx["cfg"]["ensemble"]["text_len"]

    def per_batch(rows):
        n = enc["num_layers"]
        return n, n * attention_bound_ms(enc, rows, s) * 1e-3

    return share(ctx, "flash_attention_kernel", per_batch)
