"""Share (%) of the traced run's window spent in the benchmark's span around
the batch's move to the device."""


def read(run):
    if "data" not in run.spans:
        return None
    return 100.0 * run.spans["data"] / run.window_s
