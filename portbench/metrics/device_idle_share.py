"""100 x (1 - (the union of kernel, memcpy and memset intervals) / host wall
time over the profiled steps)."""


def read(run):
    if run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["wall_s"])
