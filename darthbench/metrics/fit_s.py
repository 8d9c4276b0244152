"""fit_s (s, host clock; layer: the DARTH fit; moves setup_s): the host
clock around ``Darth.fit`` (ground truth, step log, GBDT), ending in a
device sync. Its split goes on the earlier lines."""


def read(run, name):
    return run.fit_s
