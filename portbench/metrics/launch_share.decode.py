"""launch_share.decode: host seconds in the engine's dispatches (issuing
each segment's, layer's and tail's kernels; `SlotPathStats.launch_s`), as
a share of the window. None where the program has no such counter."""
from pbcore.measure import share


def read(run):
    v = run.counters.get("launch_s")
    return None if v is None else share(v, run.seconds)
