"""95th percentile of the window's call latencies, read in the traced run
(the calls are timed before the profiler starts)."""

import numpy as np


def read(run):
    if run.profile is None or not run.calls_s:
        return None
    return float(np.percentile(np.asarray(run.calls_s) * 1e3, 95))
