"""full_scan_share.<kind> (%, program counter; layer: DARTH search; moves
qps): the share of the window's harvested queries whose distance count at
harvest (the engine's ``ndis``, kept per query by ``harvest.Tally``)
equals the collection's rows: queries that searched every bucket because
the predictor never said stop. Each holds its serve call open for all
``nprobe`` steps."""
import numpy as np

from darthbench import readers


def read(run, name):
    if not readers.applies(run, name) or not run.collection_rows:
        return None
    if not run.calls or any(c.ndis is None for c in run.calls):
        return None
    nd = np.concatenate([c.ndis for c in run.calls])
    nd = nd[nd >= 0]
    return readers.share(int((nd >= run.collection_rows).sum()), nd.size)
