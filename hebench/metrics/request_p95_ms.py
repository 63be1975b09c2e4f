"""The 95th percentile of every request's time in the window: host clock,
from handing over its inputs to its result on the host."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
