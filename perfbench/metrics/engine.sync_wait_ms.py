"""Host time an engine iteration waits for the card: the mean, over the
window's ``engine.tick`` intervals, of the program's ``sync`` phases inside
them (``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(rec):
    return program_trace.from_record(rec).get("sync_wait_ms")
