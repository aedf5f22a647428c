"""Command-line probes of the port, counterparts of the repository's tools/."""


def dataset_csv(path, name: str) -> str:
    """A tool's dataset CSV constant ``name`` (``path``), which has no
    default: the upstream release's files are not in the repository, so the
    caller points the constant at one before running the tool."""
    if not path:
        raise SystemExit(f'{name} is unset: set the module constant {name} to the '
                         "upstream release's CSV before running the tool")
    return path
