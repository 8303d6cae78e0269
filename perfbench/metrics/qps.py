"""Queries answered in the window over the window's seconds (host clock;
one call of batch b answers b queries)."""


def read(run):
    return run.answered / run.window_s if run.window_s > 0 else None
