"""Host ms of ``step.mapman`` on the calls that add features: the mean of
the ``step.mapman`` ranges that hold a ``mapman.add`` span; None where no
traced call added, or the program opens no ``mapman.add``."""


def read(trace):
    adds = [i for i in trace.host if i.name == "mapman.add"]
    held = [i for i in trace.host if i.name == "step.mapman"
            and any(i.start <= a.start and a.end <= i.end for a in adds)]
    if not held:
        return None
    return sum(i.end - i.start for i in held) / 1e6 / len(held)
