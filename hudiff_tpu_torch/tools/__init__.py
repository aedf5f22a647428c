"""Command-line probes of the port, counterparts of the repository's tools/."""
