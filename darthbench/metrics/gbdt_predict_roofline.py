"""gbdt_predict_roofline.<kind> (%, device trace; layer: the kernels,
``csrc/gbdt_predict.cu``; moves qps or latency_p95_ms): the summed least
time of the traced stretch's ``gbdt_predict`` calls
(``roofline.gbdt_counts``) over the profiler's device time of their
``gbdt_predict_kernel`` launches."""
from darthbench import readers


def read(run, name):
    if not readers.applies(run, name) or run.summary is None:
        return None
    least = run.least_s.get("gbdt_predict")
    if least is None:
        return None
    return readers.share(least, run.summary.kernel_s["gbdt_predict"])
