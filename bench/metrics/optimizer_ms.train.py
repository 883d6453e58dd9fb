"""Device milliseconds of one AdamW update: the kernels launched inside
the `bench.adamw_update` range around `optim.adamw.adamw_update`, a step,
over the traced slice."""
from bench.lib.readers import device_ms


def read(run):
    return device_ms(run, "adamw_update")
