"""Host ms a call of the step inside its seven ``step.<phase>`` ranges
(engine/step.py, parallel/batch_runner.py)."""

from slambench.trace import PHASES


def read(trace):
    s = trace.host_s(PHASES)
    return s * 1e3 / trace.steps if trace.steps and s > 0 else None
