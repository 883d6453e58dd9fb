"""Roofline share (%) of ops.dense (the tensor-core and FMA routes of csrc/gpp_matmul.cu) over the traced slice."""
from bench.lib.readers import roofline_share


def read(run):
    return roofline_share(run, "dense")
