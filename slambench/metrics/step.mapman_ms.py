"""Host ms a call of the step inside ``step.mapman``: counters, culls, the
conversion, and detection and addition of new features."""


def read(trace):
    s = trace.host_s(("step.mapman",))
    return s * 1e3 / trace.steps if trace.steps and s > 0 else None
