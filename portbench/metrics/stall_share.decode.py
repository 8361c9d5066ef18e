"""stall_share.decode: the share of the traced window in which a host to
device copy ran and no kernel did (the profiler's device timeline)."""
from pbcore.measure import stall_share as read  # noqa: F401
