"""setup_s: seconds from the process's start to the window's opening
(loading, the kernels' build or load, the weights, the engine, the traffic,
and serving until the window opens), on the host's clock."""


def read(run):
    return run.setup_s
