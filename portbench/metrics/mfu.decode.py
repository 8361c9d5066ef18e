"""mfu.decode: model FLOPs of every token the window computed (active
parameters, and attention at each token's real context) over the window
times the H100's bf16 peak."""
from pbcore.measure import mfu as read  # noqa: F401
