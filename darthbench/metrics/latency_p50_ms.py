"""latency_p50_ms.open (ms, host clock; layer: the client front, the
harness's drain loop; moves latency_p95_ms): the median of the same
per-request samples as the p95."""
import numpy as np

from darthbench import readers, stats


def read(run, name):
    if not readers.applies(run, name) or run.latencies_ms is None:
        return None
    return stats.p50(run.latencies_ms[~np.isnan(run.latencies_ms)])
