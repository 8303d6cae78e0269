"""1 less the union of kernel, copy and set intervals on the card over the
profiled calls' wall time (``torch.profiler``), in percent."""


def read(run):
    if run.profile is None or run.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
