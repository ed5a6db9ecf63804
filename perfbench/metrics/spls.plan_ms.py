"""Host time of an SPLS chunk step in its planner: the mean, over the
window's chunk steps, of the program's ``spls.predict`` and ``spls.plan``
phase intervals of every layer (``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(rec):
    return program_trace.from_record(rec).get("plan_ms")
