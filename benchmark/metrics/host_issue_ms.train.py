"""The host's time a training step, to issue its work: the mean host
duration of the program's ``step`` spans (ms)."""
from benchmark import spans


def read(ctx):
    return spans.mean_host_ms(spans.program_records(), 'step')
