"""The traffic generator: the same for one seed, another for another seed,
the same set of sizes for every seed."""
import numpy as np
import pytest

import run
from traffic import generate

MIXES = ["backlog_decode", "backlog_longprompt"]


def mix(name):
    return run.load_json(run.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    a = generate.requests(mix(name), 2 ** 40 + 3, 50304)
    b = generate.requests(mix(name), 2 ** 40 + 3, 50304)
    assert len(a) == len(b) == mix(name)["requests"]
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.arrival_s) == (y.max_new_tokens,
                                                   y.arrival_s)


@pytest.mark.parametrize("name", MIXES)
def test_another_seed_other_traffic_same_sizes(name):
    """Another seed draws other token ids; the sizes, and their order,
    are the mix's own."""
    m = mix(name)
    a = generate.requests(m, 11, 50304)
    b = generate.requests(m, 2 ** 31 + 12, 50304)
    assert all(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens):
        assert list(map(key, a)) == list(map(key, b))
    assert len({len(x.prompt) for x in a}) > 8
    for r in a:
        assert m["prompt_len"]["min"] <= len(r.prompt) <= \
            m["prompt_len"]["max"]
        assert m["output_len"]["min"] <= r.max_new_tokens <= \
            m["output_len"]["max"]
        assert len(r.prompt) + r.max_new_tokens - 1 <= m["max_seq"]
        assert r.arrival_s == 0.0
        assert 0 <= r.prompt.min() and r.prompt.max() < 50304


def test_lengths_follow_the_distribution():
    lo = generate.lengths({"dist": "lognormal", "median": 128, "sigma": 0.5,
                           "min": 64, "max": 256}, 64)
    assert np.median(lo) == pytest.approx(128, abs=2)
    assert lo.min() >= 64 and lo.max() <= 256
    with pytest.raises(ValueError):
        generate.lengths({"dist": "uniform", "min": 1, "max": 2}, 4)


def test_an_arrival_process_is_found_by_name(tmp_path, monkeypatch):
    """A new process is a new file under traffic/arrivals/; an unknown
    one is refused."""
    (tmp_path / "every_second.py").write_text(
        "import numpy as np\n\n"
        "def times(spec, n, rng):\n"
        "    return np.arange(n) * float(spec['gap_s'])\n")
    monkeypatch.setattr(generate, "ARRIVALS", tmp_path)
    m = dict(mix("backlog_decode"),
             arrival={"kind": "every_second", "gap_s": 1.0})
    assert [r.arrival_s for r in generate.requests(m, 1, 50304)[:3]] == \
        [0.0, 1.0, 2.0]
    with pytest.raises(ValueError):
        generate.arrivals({"kind": "no_such_process"}, 3,
                          np.random.default_rng(0))


def test_every_mix_names_its_source():
    for name in MIXES:
        m = mix(name)
        assert "arXiv:" in m["source"] and m["assumed"]


def test_a_mix_too_long_for_its_cache_is_refused():
    m = dict(mix("backlog_decode"), max_seq=300)
    with pytest.raises(ValueError):
        generate.requests(m, 1, 50304)
