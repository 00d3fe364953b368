"""The share of the traced step calls, in %, that replayed the step's
captured prefix: the program's ``step.replay`` spans over the calls
traced; None where the program opens no ``step.replay``."""


def read(trace):
    n = sum(i.name == "step.replay" for i in trace.host)
    return 100.0 * n / trace.steps if trace.steps and n else None
