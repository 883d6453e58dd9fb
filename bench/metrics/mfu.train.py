"""Model FLOPs utilisation (%) of the window's train steps outside the
traced slice: the published model's FLOPs of a step (`bench.lib.counts.
train_flops`: 6 x the weights a token uses x tokens, plus attention's
forward and backward over the causal positions; recomputation not
counted) over their seconds x 989e12."""
from bench.lib.readers import mfu


def read(run):
    return mfu(run)
