"""Host time a call: the unprofiled window's mean call time less the
device-busy time a call of the profiled calls after it."""

import numpy as np


def read(run):
    if run.profile is None or not run.calls_s or run.profile.calls == 0:
        return None
    busy = run.profile.busy_s / run.profile.calls
    return (float(np.mean(run.calls_s)) - busy) * 1e3
