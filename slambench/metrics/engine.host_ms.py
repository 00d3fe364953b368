"""Host ms a call of the engine's own work: inside each ``engine.step``
span of the program and outside the seven ``step.<phase>`` ranges in it
(the upload, the packed summary's read, the record), over the calls
traced; None where the program opens no ``engine.step``."""

from slambench.trace import PHASES


def read(trace):
    outer = [i for i in trace.host if i.name == "engine.step"]
    if not trace.steps or not outer:
        return None
    inner = [i for i in trace.host if i.name in PHASES]
    ns = 0
    for o in outer:
        ns += o.end - o.start - sum(
            max(0, min(i.end, o.end) - max(i.start, o.start)) for i in inner)
    return ns / 1e6 / trace.steps
