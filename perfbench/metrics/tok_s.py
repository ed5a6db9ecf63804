"""Tokens processed inside the measured window per second of it: prompt
tokens prefilled plus tokens generated (for an encoder, input tokens
encoded); a request still in flight counts what it got done."""

from perfbench.harness.stats import rate


def read(rec):
    return rate(rec["tokens"], rec["window_s"])
