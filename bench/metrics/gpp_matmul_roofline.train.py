"""Roofline share (%) of ops.dense in the forward (csrc/gpp_matmul.cu) over the traced slice."""
from bench.lib.readers import roofline_share


def read(run):
    return roofline_share(run, "dense")
