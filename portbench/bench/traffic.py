"""The one generator of inputs: it reads a traffic file's parameters and
draws from the run's seed.

Sizes and arrival gaps are stratified: every seed gets the same multiset of
lengths and gaps (the distribution's quantiles at (i + 0.5) / n) in an order
drawn from the seed, and token ids drawn from the seed. So two seeds do the
same work in another order and on other tokens, and a change of seed does
not change how much work a run holds.

Distributions, as a traffic file writes them:
    {"uniform": [lo, hi]}                       integers lo..hi
    {"lognormal": {"median": m, "sigma": s}, "min": a, "max": b}
    {"mixture": [{"share": p, ...dist}, ...], "block": b}
        shares summing to 1; with `block`, every run of b consecutive
        draws holds each part's share of them exactly (share * b whole),
        so any stretch of requests a window takes has the mixture's mix

Arrivals, in a request spec: `rate_per_s` (absent: all due at 0) with,
optionally, `arrivals` giving the gaps' shape at that mean rate:
    (absent)                         exponential gaps: Poisson arrivals
    {"cv": c}                        Gamma gaps of coefficient of variation
                                     c (over 1: bursts, as BurstGPT fits)
    {"gaps_file": "<name>.csv"}      a recorded trace's gaps, one a line,
                                     from `traffic/`, cycled to n
A mix that no parameters here can say names `"generator": "<name>"`:
`traffic/<name>.py`, whose `requests(spec, vocab_size, n, seed)` returns
what `requests` below returns.
"""

from __future__ import annotations

import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


def seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds from the run's seed (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(x) >> 1 for x in ss.generate_state(n, np.uint64)]


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def stratified(dist: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n integer draws of `dist`, its quantile multiset in a seeded order."""
    if n <= 0:
        return np.zeros((0,), np.int64)
    if "mixture" in dist:
        parts = dist["mixture"]
        counts = [int(round(p["share"] * n)) for p in parts]
        counts[-1] = n - sum(counts[:-1])
        draws = [stratified(p, c, rng) for p, c in zip(parts, counts)]
        block = dist.get("block")
        if not block:
            vals = np.concatenate(draws)
            return vals[rng.permutation(n)]
        per = [int(round(p["share"] * block)) for p in parts]
        out, taken = [], [0] * len(parts)
        while len(out) < n:
            chunk = []
            for j, k in enumerate(per):
                chunk += list(draws[j][taken[j]:taken[j] + k])
                taken[j] += k
            if not chunk:
                break
            out += [chunk[i] for i in rng.permutation(len(chunk))]
        return np.asarray(out[:n], np.int64)
    u = _quantiles(n)
    if "uniform" in dist:
        lo, hi = dist["uniform"]
        vals = lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    elif "lognormal" in dist:
        ln = dist["lognormal"]
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        vals = np.exp(math.log(ln["median"]) + ln["sigma"] * z)
        vals = np.clip(np.round(vals), dist.get("min", 1),
                       dist.get("max", np.inf)).astype(np.int64)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return vals[rng.permutation(n)]


def arrival_times(rate_per_s: float, n: int, rng: np.random.Generator,
                  shape: Optional[Dict] = None) -> np.ndarray:
    """Arrivals at a mean of `rate_per_s`, the gaps shaped by `shape` (see
    the module's doc; default Poisson): n gaps (the same multiset for every
    seed, in a seeded order), summed; the first request is due at its gap.
    A shaped multiset is scaled to the mean 1 / rate_per_s exactly."""
    shape = shape or {}
    if "gaps_file" in shape:
        base = np.loadtxt(TRAFFIC_DIR / shape["gaps_file"], ndmin=1)
        gaps = np.resize(base.astype(np.float64), n)
    elif shape.get("cv", 1.0) != 1.0:
        k = float(shape["cv"]) ** -2
        gaps = np.random.default_rng(0).gamma(k, 1.0, n)
    else:
        return np.cumsum((-np.log1p(-_quantiles(n)) / rate_per_s)
                         [rng.permutation(n)])
    gaps = np.sort(gaps) * (n / rate_per_s) / gaps.sum()
    return np.cumsum(gaps[rng.permutation(n)])


def token_rows(lengths: np.ndarray, low: int, high: int,
               rng: np.random.Generator) -> List[np.ndarray]:
    """One int32 row of ids uniform in [low, high) per length."""
    flat = rng.integers(low, high, int(lengths.sum()), dtype=np.int32)
    return np.split(flat, np.cumsum(lengths)[:-1])


def documents(spec: Dict, vocab_size: int, seed: int) -> List[Dict]:
    """The pretraining corpus: `count` documents of heavy-tailed lengths,
    ids over the ordinary vocabulary (below the 100 sentinels, above the
    pad, eos and task prefixes 0-4), each ending in eos (1)."""
    rng = np.random.default_rng(seed)
    lengths = stratified(spec["length"], int(spec["count"]), rng)
    rows = token_rows(lengths, 5, vocab_size - 100, rng)
    for row in rows:
        row[-1] = 1
    return [{"input_ids": row} for row in rows]


def requests(spec: Dict, vocab_size: int, n: int, seed: int) -> Dict:
    """n requests: input ids, new-token budgets and, with a rate, arrival
    times (else all due at 0); or what the spec's `generator` makes."""
    if "generator" in spec:
        from portbench.bench.spec import load_module
        gen = load_module(TRAFFIC_DIR / f"{spec['generator']}.py")
        return gen.requests(spec, vocab_size, n, seed)
    rng = np.random.default_rng(seed)
    in_len = stratified(spec["input_length"], n, rng)
    new = stratified(spec["new_tokens"], n, rng)
    ids = token_rows(in_len, 5, vocab_size - 100, rng)
    rate = spec.get("rate_per_s")
    arrivals = (arrival_times(rate, n, rng, spec.get("arrivals")) if rate
                else np.zeros((n,), np.float64))
    return {"input_ids": ids, "new_tokens": new, "arrival_s": arrivals}
