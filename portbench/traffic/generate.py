"""The one traffic generator: a mix file of parameters in, the requests of
one run out.

A mix (`traffic/<name>.json`) gives the request count, the arrival process
(`arrival.kind`, found by name: `traffic/arrivals/<kind>.py`, whose
`times(spec, n, rng)` gives the n arrival times), the prompt and output
lengths, each log-normal by median and sigma, clipped to [min, max], and
the published source of those lengths (`source`; what it leaves open,
`assumed`). Lengths are stratified: the n requests take the distribution's
quantiles at (i + 0.5) / n, in an order drawn once from the mix's own
`order_seed` (prompt and output lengths shuffled apart). So every run
serves the same sizes in the same order, whatever its seed: a window that
holds a few requests holds the same work in every run. The run's seed
draws the token ids (uniform over the vocabulary) and whatever the arrival
process draws. Every request is greedy.
"""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np

ARRIVALS = Path(__file__).resolve().parent / "arrivals"


@dataclass
class Spec:
    """One request of a run, before the program sees it."""
    request_id: int
    arrival_s: float
    prompt: np.ndarray          # (T,) int64 token ids
    max_new_tokens: int


def _quantile(dist: dict, u: float) -> float:
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return float(dist["median"]) * float(
        np.exp(float(dist["sigma"]) * NormalDist().inv_cdf(u)))


def lengths(dist: dict, n: int) -> np.ndarray:
    """The n stratified lengths of `dist`, clipped, in rising order."""
    u = (np.arange(n) + 0.5) / n
    raw = np.array([_quantile(dist, x) for x in u])
    return np.clip(np.rint(raw), dist["min"], dist["max"]).astype(np.int64)


def arrivals(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The n arrival times of the process `spec["kind"]`."""
    path = ARRIVALS / f"{spec['kind']}.py"
    if not path.exists():
        raise ValueError(f"unknown arrival process {spec['kind']!r}")
    load = importlib.util.spec_from_file_location(
        "pb_arrivals_" + spec["kind"], path)
    mod = importlib.util.module_from_spec(load)
    load.loader.exec_module(mod)
    return np.asarray(mod.times(spec, n, rng), dtype=np.float64)


def requests(mix: dict, seed: int, vocab: int) -> List[Spec]:
    """The requests of one run of `mix` at `seed`."""
    n = int(mix["requests"])
    order = np.random.default_rng(int(mix["order_seed"]))
    plen = order.permutation(lengths(mix["prompt_len"], n))
    olen = order.permutation(lengths(mix["output_len"], n))
    if int(plen.max() + olen.max()) - 1 > int(mix["max_seq"]):
        raise ValueError("a request would outgrow the mix's max_seq")
    rng = np.random.default_rng([int(seed), 0x7261])
    t = arrivals(mix["arrival"], n, rng)
    return [Spec(i, float(t[i]), rng.integers(0, vocab, int(plen[i]),
                                              dtype=np.int64), int(olen[i]))
            for i in range(n)]
