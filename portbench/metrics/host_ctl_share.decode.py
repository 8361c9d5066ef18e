"""host_ctl_share.decode: the engine's host self time in its steps (its
entries' time less pulls, dispatches and residency work: verification,
rollback, the link model's clock, ready snapshots, checkpoints;
`SlotPathStats.step_host_s - pull_s - launch_s - residency_s`), as a
share of the window. None where the program has no such counters."""
from pbcore.measure import share


def read(run):
    step, pull, launch, residency = (run.counters.get(k) for k in (
        "step_host_s", "pull_s", "launch_s", "residency_s"))
    if None in (step, pull, launch, residency):
        return None
    return share(step - pull - launch - residency, run.seconds)
