"""Mean time of the text branch alone (``text_search_batch`` at the cell's
batch, texts, fetch depth and filter), host clock over calls that each end
in a synchronise, read in the traced run (the operation's side call
``text``)."""

import numpy as np


def read(run):
    times = run.side_s.get("text")
    return float(np.mean(times)) * 1e3 if times else None
