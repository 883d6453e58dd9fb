"""Device milliseconds of one batched decode step: the kernels launched
inside the `bench.decode_step` range around `transformer.decode_step_paged`,
a call, over the traced slice."""
from bench.lib.readers import device_ms


def read(run):
    return device_ms(run, "decode_step")
