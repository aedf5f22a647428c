"""The share of the traced window in which no kernel ran on the device (%)."""
from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
