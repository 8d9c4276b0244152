"""setup_s (s, host clock; moves itself): process start to the first timed
query: making the data on the device, the index build, the DARTH fit, the
kernels' build or load, and the warm-up serve call."""


def read(run, name):
    return run.setup_s
