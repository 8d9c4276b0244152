"""bucket_probe_roofline.<kind> (%, device trace; layer: the kernels,
``csrc/bucket_probe.cu``; moves qps or latency_p95_ms): the summed least
time of the ``bucket_probe_slots`` calls of the traced stretch
(``roofline.probe_counts``) over the profiler's device time of their
``probe_tile_kernel`` and ``probe_merge_kernel`` launches."""
from darthbench import readers


def read(run, name):
    if not readers.applies(run, name) or run.summary is None:
        return None
    least = run.least_s.get("bucket_probe")
    if least is None:
        return None
    return readers.share(least, run.summary.kernel_s["bucket_probe"])
