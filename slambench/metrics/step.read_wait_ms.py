"""Host ms a call spent blocked on the device at the program's own reads:
inside its ``read.*`` spans (``read.add``, the step's add decision;
``read.summary``, the engine's packed summary), over the calls traced;
None where the program opens none."""


def read(trace):
    ns = sum(i.end - i.start for i in trace.host
             if i.name.startswith("read."))
    return ns / 1e6 / trace.steps if trace.steps and ns > 0 else None
