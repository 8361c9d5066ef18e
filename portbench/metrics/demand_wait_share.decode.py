"""demand_wait_share.decode: the part of the compute stream's wait on
expert copies whose newest awaited copy was a demand copy (a miss, or a
replay's demand), not a predicted one (`SlotPathStats.copy_wait_demand_s`),
as a share of the window. None where the program has no such counter."""
from pbcore.measure import share


def read(run):
    v = run.counters.get("copy_wait_demand_s")
    return None if v is None else share(v, run.seconds)
