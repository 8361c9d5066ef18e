"""replays_per_step: speculative windows the engine rolled back in the
window (`SlotPathStats.replays`) over its decode steps."""
from pbcore.measure import per_decode_step


def read(run):
    return per_decode_step(run, "replays")
