"""Device milliseconds of one prefill chunk: the kernels launched inside
the `bench.prefill_chunk` range around `transformer.prefill_chunk`, a
call, over the traced slice."""
from bench.lib.readers import device_ms


def read(run):
    return device_ms(run, "prefill_chunk")
