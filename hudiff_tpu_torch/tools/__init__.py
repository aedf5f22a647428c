"""Command-line probes of the port, counterparts of the repository's tools/."""


def dataset_csv(path, name: str) -> str:
    """A tool's dataset CSV constant ``name`` (``path``), which has no
    default: the upstream release's files are not in the repository, so the
    caller points the constant at one before running the tool."""
    if not path:
        raise SystemExit(f'{name} is unset: set the module constant {name} to the '
                         "upstream release's CSV before running the tool")
    return path


def added_ms(kernels) -> list:
    """The device ms each profiled kernel record adds to the time the device
    was busy, in the order given: from the later of its start and the end
    of every kernel that started before it, to its end (0 where earlier
    kernels cover it). A kernel launched to start under the previous one's
    tail (programmatic dependent launch) is charged from that kernel's end,
    not for the time it waited there; a kernel that overlaps none, its
    duration. The values sum to the time at least one kernel ran."""
    out, last = [0.0] * len(kernels), None
    for i in sorted(range(len(kernels)), key=lambda k: kernels[k].time_range.start):
        start, end = kernels[i].time_range.start, kernels[i].time_range.end
        out[i] = max(0.0, end - (start if last is None else max(start, last))) / 1e3
        last = end if last is None else max(last, end)
    return out
