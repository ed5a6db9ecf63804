"""Host time of an SPLS chunk step in its compute: the mean, over the
window's chunk steps, of the program's ``chunk.attend`` and ``chunk.ffn``
phase intervals of every layer (``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(rec):
    return program_trace.from_record(rec).get("compute_ms")
