"""The model's FLOPs in the traced window over its length and the peak (%)."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
