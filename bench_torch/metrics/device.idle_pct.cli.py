"""``device.idle_pct``, in the cells whose timing metrics are the CLI's own
(``solve_s.cli``, ``iter_ms.cli``)."""

from bench_torch import harness

read = harness.reader("device.idle_pct").read
