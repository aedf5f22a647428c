"""The ByteNet kernels' (K2, K4) bound time over their device time (%)."""
from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, 'bytenet')
