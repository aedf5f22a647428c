"""AbNatiV's share of the step's stream time: the CUDA-event time of the
program's ``scorer`` and ``scorer.backward`` spans over that of its ``step``
spans (%). An event interval is the stream's time from one event to the
next, idle stretches included, so on a host-bound step this share follows
the host's pace of issue through the scorers, not their device work."""
from benchmark import spans


def read(ctx):
    return spans.stream_share(spans.program_records(), ('scorer', 'scorer.backward'), 'step')
