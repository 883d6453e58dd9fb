"""Model FLOPs utilisation (%) of the window's steps outside the traced
slice: the published model's FLOPs of the tokens they served
(`bench.lib.counts.serve_flops_spans`: 2 x the weights a token uses, the
logits head included, plus attention over its attended positions) over
their seconds x 989e12."""
from bench.lib.readers import mfu


def read(run):
    return mfu(run)
