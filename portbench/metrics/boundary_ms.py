"""The benchmark's synchronised span from the last micro-batch's end to
the apply's end, per step of the traced window, in ms."""


def read(run):
    if "boundary" not in run.spans:
        return None
    return run.spans["boundary"] / run.span_counts["boundary"] * 1e3
