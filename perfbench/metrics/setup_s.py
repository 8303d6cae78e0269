"""Seconds from the process's start to the end of the warm-up: imports,
data made on the card, the ingest through the public API, the program's
lazy builds and the warm-up calls."""


def read(run):
    return run.setup_s
