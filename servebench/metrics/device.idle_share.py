"""Share of the traced sub-window in which no operation ran on the card:
1 - (union of the device's operation intervals) / the sub-window."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 1.0 - p.busy_s / p.window_s
