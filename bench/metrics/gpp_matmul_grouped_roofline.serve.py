"""Roofline share (%) of ops.dense_grouped (csrc/gpp_matmul_grouped.cu) over the traced slice."""
from bench.lib.readers import roofline_share


def read(run):
    return roofline_share(run, "dense_grouped")
