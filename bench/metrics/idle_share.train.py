"""Share (%) of the traced slice in which no operation ran on the device:
1 - (the union of the device's operation intervals / the slice's wall)."""
from bench.lib.readers import idle_share


def read(run):
    return idle_share(run)
