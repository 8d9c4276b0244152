"""ndis_per_query.<kind> (dist/q, program counter; layer: DARTH search,
the probe or beam loop and the predictor's stop; moves qps or
latency_p95_ms): distance computations per completed query,
``sum(ndis_harvested) / sum(completed)`` over the window's calls."""
from darthbench import readers


def read(run, name):
    if not readers.applies(run, name):
        return None
    done = sum(c.stats.completed for c in run.calls)
    if not done:
        return None
    return sum(c.stats.ndis_harvested for c in run.calls) / done
