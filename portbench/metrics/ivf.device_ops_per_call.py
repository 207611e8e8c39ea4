"""Device operations (kernels, copies, sets) a search call, from the
trace: the window's device ops over the calls it made."""


def read(r):
    calls = r.window.counts.get("calls", 0)
    if not calls or not r.trace.device:
        return None
    return len(r.trace.device) / calls
