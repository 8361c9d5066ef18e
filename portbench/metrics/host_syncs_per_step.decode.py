"""host_syncs_per_step.decode: the engine's blocking device-to-host
pulls in the window (`SlotPathStats.host_syncs`) over its decode steps."""
from pbcore.measure import per_decode_step


def read(run):
    return per_decode_step(run, "host_syncs")
