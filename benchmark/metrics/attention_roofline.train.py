"""The attention kernels' (K1, K3) bound time over their device time (%)."""
from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, 'attention')
