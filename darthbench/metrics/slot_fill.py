"""slot_fill.backlog (%, program counter; layer: the server; moves qps):
occupied slot-steps over all slot-steps the pool stepped,
``sum(slot_steps) / (sum(engine_steps) * num_slots)`` over the window's
calls."""
from darthbench import readers


def read(run, name):
    if not readers.applies(run, name):
        return None
    steps = sum(c.stats.engine_steps for c in run.calls)
    return readers.share(sum(c.stats.slot_steps for c in run.calls),
                         steps * run.num_slots)
