"""residency_share.decode: host seconds in the engine's residency work
(cache bookkeeping, issuing the expert copies, the stream waits on them;
`SlotPathStats.residency_s`), as a share of the window. None where the
program has no such counter."""
from pbcore.measure import share


def read(run):
    v = run.counters.get("residency_s")
    return None if v is None else share(v, run.seconds)
