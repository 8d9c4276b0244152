"""build_s (s, host clock; layer: the index build; moves setup_s): the
host clock around the index kind's build, ending in a device sync."""


def read(run, name):
    return run.build_s
