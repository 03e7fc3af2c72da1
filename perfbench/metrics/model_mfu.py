"""The whole step's share of the card's dense bf16 peak: the model
operations of every transaction decided in the window (the configuration's
shapes at the text length every row carries, ``perfbench/counts.py
model_flops_per_txn``) over the window's seconds times 989 TFLOP/s."""

from perfbench.counts import MFU_PEAK, model_flops_per_txn


def read(ctx):
    if not ctx["in_window"]:
        return None
    flops = ctx["in_window"] * model_flops_per_txn(ctx["cfg"])
    return 100.0 * flops / (ctx["seconds"] * MFU_PEAK)
