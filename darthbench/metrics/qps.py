"""qps (queries/s, host clock): backlog cells. Every query completed in
the window over the wall time from the first serve call's start to the
last call's end (a whole number of calls, the last run to its end)."""


def read(run, name):
    if run.kind != "backlog" or not run.window_s > 0:
        return None
    return run.completed / run.window_s
