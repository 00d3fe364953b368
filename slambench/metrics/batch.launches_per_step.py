"""Device kernel launches a batched step: the kernels of the traced
window launched from a host op that began inside one of the step's
``step.*`` ranges (the harness's own work around the step is left out),
over the steps traced."""

from slambench.trace import PHASES


def read(trace):
    n = len(trace.launched_in(PHASES))
    return n / trace.steps if trace.steps and n else None
