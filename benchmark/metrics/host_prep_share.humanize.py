"""The host time in ``pair_input`` over the traced window (%)."""
from benchmark import readers


def read(ctx):
    return readers.span_share(ctx, 'pair_input')
