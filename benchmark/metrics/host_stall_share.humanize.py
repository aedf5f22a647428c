"""The host's own work while the device had nothing queued, over the
program's stretch of the traced window (first span's start to last span's
end; %): the self time of the program's ``pair_input``, ``round.prep``,
``result`` and ``gc`` spans that found the stream drained at their entry."""
from benchmark import spans


def read(ctx):
    return spans.stall_share(spans.program_records(), ('pair_input', 'round.prep', 'result', 'gc'))
