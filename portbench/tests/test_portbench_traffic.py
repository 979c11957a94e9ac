"""The seeded generator: one seed gives the same inputs; every seed the
same multiset of sizes and gaps; the stated distributions."""

import numpy as np

from portbench.tests import tiny  # noqa: F401  (puts the repo on the path)
from portbench.bench import traffic

MIX = {"mixture": [{"share": 0.9, "uniform": [16, 64]},
                   {"share": 0.1, "uniform": [512, 2048]}]}


def test_same_seed_same_requests():
    spec = {"input_length": {"uniform": [384, 512]}, "new_tokens": MIX,
            "rate_per_s": 50.0}
    a = traffic.requests(spec, 32128, 200, 2 ** 40 + 3)
    b = traffic.requests(spec, 32128, 200, 2 ** 40 + 3)
    for x, y in zip(a["input_ids"], b["input_ids"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["new_tokens"], b["new_tokens"])
    np.testing.assert_array_equal(a["arrival_s"], b["arrival_s"])


def test_seeds_share_the_work_in_another_order():
    a = traffic.stratified(MIX, 1000, np.random.default_rng(1))
    b = traffic.stratified(MIX, 1000, np.random.default_rng(2))
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_mixture_shares_and_ranges():
    v = traffic.stratified(MIX, 1000, np.random.default_rng(0))
    long = v >= 512
    assert long.sum() == 100
    assert v[~long].min() >= 16 and v[~long].max() <= 64
    assert v[long].min() >= 512 and v[long].max() <= 2048
    # uniform: every value of the short range about equally often
    counts = np.bincount(v[~long] - 16, minlength=49)
    assert counts.min() >= 17 and counts.max() <= 19


def test_lognormal_is_heavy_tailed_and_clipped():
    d = {"lognormal": {"median": 600, "sigma": 1.0}, "min": 64,
         "max": 16384}
    v = traffic.stratified(d, 8192, np.random.default_rng(0))
    assert abs(np.median(v) - 600) <= 2
    assert v.min() >= 64 and v.max() <= 16384
    assert np.mean(v) > 1.5 * np.median(v)


def test_poisson_arrivals():
    t = traffic.arrival_times(100.0, 2000, np.random.default_rng(3))
    assert np.all(np.diff(t) > 0)
    assert abs(t[-1] - 20.0) < 0.5            # n / rate, the same each seed
    gaps = np.diff(np.concatenate([[0.0], t]))
    assert abs(np.mean(gaps) - 0.01) < 5e-4
    assert abs(np.std(gaps) - 0.01) < 1e-3    # exponential: sd = mean


def test_documents_end_in_eos_and_avoid_special_ids():
    docs = traffic.documents({"count": 50, "length": {"uniform": [10, 20]}},
                             512, 9)
    for d in docs:
        ids = d["input_ids"]
        assert ids[-1] == 1 and 10 <= len(ids) <= 20
        assert ids[:-1].min() >= 5 and ids[:-1].max() < 512 - 100


def test_large_seeds():
    assert len(set(traffic.seeds(2 ** 31 + 12345, 3))) == 3
    assert traffic.seeds(7, 2) == traffic.seeds(7, 2)


def test_blocks_hold_the_mix_in_every_stretch():
    d = dict(MIX, block=10)
    v = traffic.stratified(d, 4096, np.random.default_rng(4))
    w = traffic.stratified(d, 4096, np.random.default_rng(5))
    np.testing.assert_array_equal(np.sort(v), np.sort(w))
    per_block = (v[:4090].reshape(-1, 10) >= 512).sum(axis=1)
    assert per_block.min() == per_block.max() == 1


def test_bursty_arrivals_keep_the_rate():
    rng = np.random.default_rng(6)
    t = traffic.arrival_times(100.0, 2000, rng, {"cv": 3.0})
    gaps = np.diff(np.concatenate([[0.0], t]))
    assert abs(t[-1] - 20.0) < 1e-9           # n / rate exactly
    assert 2.5 < np.std(gaps) / np.mean(gaps) < 3.5
    u = traffic.arrival_times(100.0, 2000, np.random.default_rng(7),
                              {"cv": 3.0})
    np.testing.assert_allclose(np.sort(np.diff(np.concatenate([[0.0], u]))),
                               np.sort(gaps), atol=1e-12)


def test_arrivals_from_a_gaps_file(tmp_path, monkeypatch):
    (tmp_path / "trace.csv").write_text("0.5\n0.1\n0.4\n")
    monkeypatch.setattr(traffic, "TRAFFIC_DIR", tmp_path)
    t = traffic.arrival_times(10.0, 6, np.random.default_rng(8),
                              {"gaps_file": "trace.csv"})
    gaps = np.diff(np.concatenate([[0.0], t]))
    # the file's gaps cycled to 6, scaled to the mean 1 / 10 s
    np.testing.assert_allclose(np.sort(gaps),
                               [0.03, 0.03, 0.12, 0.12, 0.15, 0.15])


def test_a_mix_may_name_its_own_generator(tmp_path, monkeypatch):
    (tmp_path / "fixed.py").write_text(
        "import numpy as np\n"
        "def requests(spec, vocab_size, n, seed):\n"
        "    return {'input_ids': [np.full(4, 7, np.int32)] * n,\n"
        "            'new_tokens': np.full(n, spec['k']),\n"
        "            'arrival_s': np.arange(n, dtype=float)}\n")
    monkeypatch.setattr(traffic, "TRAFFIC_DIR", tmp_path)
    r = traffic.requests({"generator": "fixed", "k": 3}, 512, 5, 1)
    assert list(r["new_tokens"]) == [3] * 5 and r["arrival_s"][-1] == 4.0
