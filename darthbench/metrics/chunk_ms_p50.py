"""chunk_ms_p50.<kind> (ms, program counter; layer: the server; moves qps
in backlog cells, latency_p95_ms in open ones): the median over the
window's serve calls of ``ServeStats.chunk_ms_p50``, the server's host
clock around a chunk's dispatch and its sync fetch."""
from darthbench import readers, stats


def read(run, name):
    if not readers.applies(run, name):
        return None
    return stats.p50([c.stats.chunk_ms_p50 for c in run.calls])
