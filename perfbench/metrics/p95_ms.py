"""95th percentile of the window's call latencies, every call counted (host
clock around each call; the call returns hydrated results, so the device
work is done)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.calls_s) * 1e3, 95)) if run.calls_s else None
