"""latency_p95_ms (ms, host clock): open-loop cells. The 95th percentile
over every request of the window of the time from its due time to the
return of the serve call that answered it; a request that never came back
counts as infinitely late."""
import numpy as np

from darthbench import stats


def read(run, name):
    if run.kind != "open" or run.latencies_ms is None:
        return None
    lat = np.where(np.isnan(run.latencies_ms), np.inf, run.latencies_ms)
    if np.isinf(lat).mean() > 0.05:
        return None
    return stats.percentile(np.minimum(lat, np.finfo(np.float64).max), 95)
