"""copy_wait_share.decode: device seconds in which the compute stream
waited on expert copies in the window (`SlotPathStats.copy_wait_s`, timed
by CUDA events around the engine's stream waits), as a share of the
window. None where the program has no such counter."""
from pbcore.measure import share


def read(run):
    v = run.counters.get("copy_wait_s")
    return None if v is None else share(v, run.seconds)
