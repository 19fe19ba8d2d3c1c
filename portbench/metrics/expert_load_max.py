"""The hottest held expert's (token, expert) pairs over the held experts'
mean, over the window's steps: 1 when routing spreads the tokens evenly
over the experts this rank holds, more as it concentrates them. The
program counts the pairs of every held expert of every expert layer on
the device and hands them over after the window
(``kernel_shapes["expert_loads"]``, ``[L_moe, n]``)."""


def read(run):
    loads = (run.shapes or {}).get("expert_loads")
    cells = [x for row in loads or () for x in row]
    if not cells or not sum(cells):
        return None
    return max(cells) / (sum(cells) / len(cells))
