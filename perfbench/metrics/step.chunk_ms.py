"""Mean duration of the engine's ``prefill_chunk`` span over the chunks of
the window, under the traced run's clock, which waits for the card before
it reads the time."""


def read(rec):
    s = rec.get("spans", {}).get("prefill_chunk")
    return sum(s) / len(s) * 1e3 if s else None
