"""swap_gb_per_token.decode: expert bytes swapped in during the window
(`SlotPathStats.swap_bytes`, GB) over its output tokens."""
from pbcore.measure import swap_gb_per


def read(run):
    return swap_gb_per(run, run.output_tokens)
