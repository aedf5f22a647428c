"""Sampler rounds a request: the program's counter ``rounds`` inside its
``humanize`` spans, per span; above 1 where the filter sent a round back."""
from benchmark import spans


def read(ctx):
    return spans.count_per_unit(spans.program_records(), 'rounds', 'humanize')
