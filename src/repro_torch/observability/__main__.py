"""``python -m repro_torch.observability <BENCH_serving.json>
[--require-nonzero-flops]`` -- validate a serving report against the
current schema (delegates to :mod:`repro_torch.observability.report`)."""

import sys

from .report import main

if __name__ == "__main__":
    sys.exit(main())
