"""occupancy.decode: mean rows a decode step of the window decodes."""


def read(run):
    if not run.decode:
        return None
    return sum(len(s.rows) for s in run.decode) / len(run.decode)
