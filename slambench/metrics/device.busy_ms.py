"""Device ms a call of the entry: the union of the device's activity in
the traced window over the calls traced."""


def read(trace):
    busy = trace.busy_s()
    return busy * 1e3 / trace.steps if trace.steps and busy > 0 else None
