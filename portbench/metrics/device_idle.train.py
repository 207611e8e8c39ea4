"""Share of the traced window in which no operation ran on the card, %:
1 - busy / window, busy the union of the device ops' intervals."""


def read(r):
    if r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
