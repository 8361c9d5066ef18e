"""idle_share.decode: the share of the traced window in which no kernel
ran (the profiler's device timeline; copies may run)."""
from pbcore.measure import idle_share as read  # noqa: F401
