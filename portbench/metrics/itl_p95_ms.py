"""itl_p95_ms: the 95th percentile of all inter-token gaps of all
requests that end in the window (numpy's linear interpolation), in ms."""
import numpy as np


def read(run):
    return float(np.percentile(run.gaps_s, 95)) * 1e3 if run.gaps_s else None
