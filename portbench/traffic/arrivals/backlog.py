"""Every request arrives at t = 0: an offline batch job, or a server that
has fallen behind."""
import numpy as np


def times(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return np.zeros(n)
