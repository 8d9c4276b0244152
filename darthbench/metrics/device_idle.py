"""device_idle.<kind> (%, device trace; layer: the device; moves qps or
latency_p95_ms): the share of the traced stretch in which no kernel, copy
or set ran on the card."""
from darthbench import readers


def read(run, name):
    if not readers.applies(run, name) or run.summary is None:
        return None
    s = run.summary
    if not s.window_s > 0:
        return None
    return 100.0 * (s.window_s - s.busy_s) / s.window_s
