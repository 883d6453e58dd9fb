"""Roofline share (%) of ops.paged_attn (csrc/paged_attention.cu with its merge) over the traced slice."""
from bench.lib.readers import roofline_share


def read(run):
    return roofline_share(run, "paged_attn")
