"""Host ms a request in which the device had nothing queued: the self time
of the program's ``nano_input``, ``round.prep``, ``filter`` and ``gc`` spans
inside its ``humanize`` spans (one a request) that found the stream drained
at their entry, per ``humanize`` span."""
from benchmark import spans


def read(ctx):
    return spans.stall_ms_per_unit(spans.program_records(),
                                   ('nano_input', 'round.prep', 'filter', 'gc'), 'humanize')
