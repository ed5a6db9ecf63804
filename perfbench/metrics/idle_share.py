"""Share of the traced window in which no operation ran on the card: 1 -
the union of the device's activity intervals over the window's length."""


def read(rec):
    t = rec.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / rec["window_s"])
