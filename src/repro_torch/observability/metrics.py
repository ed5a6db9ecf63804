"""Host-side metrics registry: counters, gauges, histograms.

Low-overhead by construction: every instrument is a plain Python object
mutated from host code *after* device readback -- nothing here is ever
traced, and timestamps come from an **injected monotonic clock**
(``Registry(clock=...)``), never ``time.time()`` inside jit.  The
serving engine records a handful of integer increments per tick, the
same cost as the ad-hoc ``stats`` dict this module replaces.

Naming convention is ``scope/name`` strings (``"pool/pages_in_use"``,
``"spls/kept_ratio"``); per-request data lives in
:class:`~repro_torch.observability.trace.TraceRecorder` spans and the request
records the report module aggregates, not in per-request instruments.

A disabled registry (``MetricsRegistry(enabled=False)``) hands out a
shared :class:`NullInstrument` that accepts every operation and records
nothing, so call sites never branch on the telemetry knob.
"""

from __future__ import annotations

import math
import time
from collections.abc import MutableMapping
from typing import Dict, List, Optional

__all__ = ["Counter", "CounterDictView", "Gauge", "Histogram",
           "MetricsRegistry", "NullInstrument", "percentile"]


def percentile(values: List[float], p: float) -> float:
    """Linear-interpolated percentile of ``values`` (``p`` in [0, 100]),
    matching ``numpy.percentile``'s default method.  NaN on empty."""
    if not values:
        return float("nan")
    xs = sorted(values)
    n = len(xs)
    if n == 1:
        return float(xs[0])
    rank = (p / 100.0) * (n - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return float(xs[lo] + (xs[hi] - xs[lo]) * frac)


class Counter:
    """Monotone event count.  ``set`` exists only for the back-compat
    ``stats`` dict view (legacy code assigns into it)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v: int) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Gauge:
    """Last-observed value with a high-watermark (and low-watermark)."""

    __slots__ = ("name", "value", "high", "low")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0
        self.high: float = float("-inf")
        self.low: float = float("inf")

    def set(self, v: float) -> None:
        self.value = v
        if v > self.high:
            self.high = v
        if v < self.low:
            self.low = v

    def snapshot(self):
        return {"value": self.value,
                "high": self.high if self.high != float("-inf") else None,
                "low": self.low if self.low != float("inf") else None}


class Histogram:
    """Raw-sample histogram with percentile summaries.

    Samples are kept verbatim up to ``max_samples`` (serving smoke scale
    is thousands of observations, not millions); beyond the cap new
    samples are dropped and counted in ``dropped`` so truncation is
    visible instead of silent.
    """

    __slots__ = ("name", "samples", "count", "total", "max_samples",
                 "dropped")

    def __init__(self, name: str, max_samples: int = 100_000):
        self.name = name
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.max_samples = max_samples
        self.dropped = 0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self.samples) < self.max_samples:
            self.samples.append(float(v))
        else:
            self.dropped += 1

    def percentile(self, p: float) -> float:
        return percentile(self.samples, p)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def summary(self) -> dict:
        return {"n": self.count, "mean": self.mean,
                "p50": self.percentile(50.0), "p99": self.percentile(99.0),
                "min": min(self.samples) if self.samples else float("nan"),
                "max": max(self.samples) if self.samples else float("nan")}

    def snapshot(self):
        return self.summary()


class NullInstrument:
    """Accepts every instrument operation and records nothing (the no-op
    sink a disabled registry hands out)."""

    name = "<null>"
    value = 0
    high = None
    low = None
    count = 0
    samples: List[float] = []
    mean = float("nan")

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, p: float) -> float:
        return float("nan")

    def summary(self) -> dict:
        return {}

    def snapshot(self):
        return None


_NULL = NullInstrument()


class MetricsRegistry:
    """Name-keyed instrument registry with injected clock.

    ``counter`` / ``gauge`` / ``histogram`` create-or-return by name (one
    instrument per name; asking for the same name with a different kind
    raises -- a name collision would silently split a metric).  ``now()``
    reads the injected monotonic clock; every timestamp the telemetry
    layer stores comes from here so tests can drive a fake clock.
    """

    def __init__(self, enabled: bool = True, clock=time.monotonic):
        self.enabled = enabled
        self.clock = clock
        self._instruments: Dict[str, object] = {}

    def now(self) -> float:
        return self.clock()

    # ------------------------------------------------------------------
    def _get(self, name: str, kind):
        if not self.enabled:
            return _NULL
        inst = self._instruments.get(name)
        if inst is None:
            inst = kind(name)
            self._instruments[name] = inst
        elif not isinstance(inst, kind):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {kind.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str) -> Optional[object]:
        """Registered instrument by name, or None (never creates)."""
        return self._instruments.get(name)

    def snapshot(self) -> dict:
        """``{name: value-or-summary}`` for every registered instrument
        (empty when disabled: a disabled registry records nothing)."""
        return {name: inst.snapshot()
                for name, inst in sorted(self._instruments.items())}


class CounterDictView(MutableMapping):
    """Dict-shaped live view over a fixed set of registry counters.

    The back-compat shim for code that treated ``scheduler.stats`` /
    ``engine.stats`` as a plain dict: reads come straight from the typed
    :class:`Counter` instruments, writes (including ``view[k] += 1``,
    which is a read-then-write) land on them.  The key set is fixed at
    construction -- a typo'd key raises instead of silently creating a
    new stat.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str, keys):
        self._counters = {k: registry.counter(prefix + k) for k in keys}

    def __getitem__(self, k):
        return self._counters[k].value

    def __setitem__(self, k, v):
        self._counters[k].set(v)

    def __delitem__(self, k):
        raise TypeError("stats view has a fixed key set")

    def __iter__(self):
        return iter(self._counters)

    def __len__(self):
        return len(self._counters)

    def __repr__(self):
        return repr(dict(self))
