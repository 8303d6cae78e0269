"""The least time of an exact search's work (:mod:`perfbench.roofline`:
operations at the int8 rate or bytes at the HBM rate, whichever is larger,
from the call's shapes and the rows its filter admits) over the device-busy
time a call, in percent. Read where the window's calls are plain vector
searches."""

from perfbench import roofline


def read(run):
    if run.profile is None or run.op != "search_batch" or run.profile.busy_s <= 0:
        return None
    least, _ = roofline.exact_search_least_s(run.batch, run.admitted_rows, run.dim, run.k,
                                             run.device_kind)
    return 100.0 * least / (run.profile.busy_s / run.profile.calls)
