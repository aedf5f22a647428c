"""Host ms a request spends in ``nano_input`` and the validity filter."""
from benchmark import readers


def read(ctx):
    return readers.span_ms_per_unit(ctx, 'nano_input', 'filter')
