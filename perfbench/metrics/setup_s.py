"""Seconds from the process's start to the first timed step: imports, the
card, kernel builds on a checkout's first run, weights, the engine or
model, and the warm-up of every shape the window uses."""


def read(rec):
    return rec["setup_s"]
