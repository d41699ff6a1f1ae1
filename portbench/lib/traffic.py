"""The one traffic generator: host batches from a configuration, a mix's
parameters and a seed.

The configuration gives the id space (``features``: name -> cardinality, laid
out one after another from offset 0, as ``DataInfo.from_dims`` lays them
out), the behaviour series (``sequences``: series -> the feature whose ids
it holds), the features derived from another by a seeded map (``derived``:
DIN's category of a good), the click rate, and ``counts``: how often the ids
of each feature occur in the source's data (``occurrences``) and how often
its rarest id occurs there at least (``least``).

The mix gives the batch size, the pool of batches made in set-up and
cycled, the skew (``"skew": "counts"``: every drawn feature bounded Zipf
with the exponent that the configuration's counts give it; uniform
without the key), the histories, and whether labels are drawn. Histories
(``"history": "prefixes"``, the one kind) are the training samples that DIN
(Zhou et al., KDD 2018, Sec. 6.1) makes from a user's n behaviours: the
first k of them for k = 1 .. n - 2, each such (user, k) equally likely, so
a user is drawn in proportion to its n - 2 samples. A user's n is its count
under the user feature's fitted law. A history is cut to its last
``max_seq_length`` steps and padded at the end with ``padding_index``.

Skewed ids are bounded Zipf: a rank from the continuous inverse CDF of
``r^-s`` over [1, n + 1), floored, then mapped to an id by a seeded affine
permutation of [0, n). The exponent fitted to ``counts`` is the one at which
a bounded Zipf over the feature's n ids, spread over its ``occurrences``,
gives its rarest id ``least`` of them. The same seed gives the same batches.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

SEED_STREAMS = {"maps": 1, "pool": 2}


def generator(seed: int, stream: str) -> np.random.Generator:
    """The numpy generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([seed % 2**63, SEED_STREAMS[stream]])


def offsets(features: Dict[str, int]) -> Dict[str, int]:
    out, at = {}, 0
    for name, dim in features.items():
        out[name] = at
        at += dim
    return out


def harmonic(n: int, s: float, head: int = 4096) -> float:
    """sum_{r=1}^{n} r^-s: the first ``head`` terms summed, the rest by the
    integral of x^-s over [head + 1/2, n + 1/2]."""
    k = min(n, head)
    total = float(np.sum(np.arange(1, k + 1, dtype=np.float64) ** -s))
    if n > k:
        a, b = k + 0.5, n + 0.5
        total += math.log(b / a) if abs(s - 1.0) < 1e-12 else (b ** (1 - s) - a ** (1 - s)) / (1 - s)
    return total


def rarest_count(n: int, s: float, occurrences: float) -> float:
    """The occurrences of rank n under a bounded Zipf(s) over n ids."""
    return occurrences * n ** -s / harmonic(n, s)


def fitted_exponent(n: int, occurrences: float, least: float) -> float:
    """The exponent at which the rarest of n ids gets ``least`` of
    ``occurrences`` (0, uniform, where even that gives it more)."""
    if n * least > occurrences:
        raise ValueError(f"{n} ids cannot each occur {least} times in {occurrences}")
    lo, hi = 0.0, 64.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if rarest_count(n, mid, occurrences) > least:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def zipf_ranks(rng: np.random.Generator, n: int, s: float, size) -> np.ndarray:
    """0-based ranks in [0, n), P(rank r) ~ (r + 1)^-s (bounded Zipf)."""
    u = rng.random(size)
    if abs(s - 1.0) < 1e-9:
        r = np.exp(u * math.log(n + 1.0))
    else:
        a = 1.0 - s
        r = (1.0 + u * ((n + 1.0) ** a - 1.0)) ** (1.0 / a)
    return np.minimum(np.floor(r).astype(np.int64), n) - 1


def exponent(config, mix, name: str):
    """The Zipf exponent of feature ``name`` in ``mix``, or None (uniform)."""
    skew = mix.get("skew")
    if skew is None:
        return None
    if skew != "counts":
        raise ValueError(f"unknown skew {skew!r}")
    counts = config["counts"]
    return fitted_exponent(config["features"][name], counts["occurrences"], counts["least"])


def user_samples(config, mix) -> np.ndarray:
    """The training samples (n - 2) of each user rank under the prefix law."""
    user = config["user_features"][0]
    n, counts = config["features"][user], config["counts"]
    s = exponent(config, mix, user)
    if s is None or counts["least"] < 3:
        raise ValueError("prefix histories need the user's fitted counts, at least 3 a user")
    c = counts["occurrences"] * np.arange(1, n + 1, dtype=np.float64) ** -s / harmonic(n, s)
    return np.maximum(np.rint(c), counts["least"]) - 2


class IdMaps:
    """The seeded maps of one run: each feature's rank -> id permutation
    (an affine bijection of [0, n)), each derived feature's table, and the
    exponents and prefix weights, worked out once."""

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any], seed: int):
        rng = generator(seed, "maps")
        self.perm = {}
        for name, n in config["features"].items():
            mult = int(rng.integers(1, max(n, 2)))
            while math.gcd(mult, n) != 1:
                mult = int(rng.integers(1, max(n, 2)))
            self.perm[name] = (mult, int(rng.integers(0, n)))
        self.derived = {
            name: rng.integers(0, config["features"][name], size=config["features"][src])
            for name, src in config.get("derived", {}).items()
        }
        self.exponent = {name: exponent(config, mix, name) for name in config["features"]
                         if name not in self.derived}
        if config.get("sequences"):
            self.samples = user_samples(config, mix)
            self.samples_cdf = np.cumsum(self.samples)

    def ids(self, name: str, ranks: np.ndarray, n: int) -> np.ndarray:
        mult, add = self.perm[name]
        return (ranks * mult + add) % n


def _draw(config, maps: IdMaps, rng, name: str, size) -> np.ndarray:
    """Local (0-based) ids of feature ``name``."""
    n = config["features"][name]
    s = maps.exponent[name]
    if s is None:
        return rng.integers(0, n, size=size)
    return maps.ids(name, zipf_ranks(rng, n, s, size), n)


def _prefixes(config, maps: IdMaps, rng, b: int):
    """(user ranks, history lengths) of ``b`` training samples."""
    cdf = maps.samples_cdf
    ranks = np.minimum(np.searchsorted(cdf, rng.random(b) * cdf[-1], side="right"), len(cdf) - 1)
    k = 1 + np.floor(rng.random(b) * maps.samples[ranks]).astype(np.int64)
    return ranks, np.minimum(k, int(config["max_seq_length"]))


def make_batch(config, mix, maps: IdMaps, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One host batch: every id column offset-encoded (int64), the series
    (B, L) padded, and ``label`` (float32) when the mix draws labels."""
    b = int(mix["batch"])
    feats = config["features"]
    off = offsets(feats)
    derived = config.get("derived", {})
    seqs = config.get("sequences", {})
    local: Dict[str, np.ndarray] = {}
    if seqs:
        if mix.get("history") != "prefixes":
            raise ValueError(f"unknown history {mix.get('history')!r}")
        user = config["user_features"][0]
        ranks, lengths = _prefixes(config, maps, rng, b)
        local[user] = maps.ids(user, ranks, feats[user])
    for name in feats:
        if name not in derived and name not in local:
            local[name] = _draw(config, maps, rng, name, b)
    for name, src in derived.items():
        local[name] = maps.derived[name][local[src]]
    batch = {name: local[name] + off[name] for name in feats}
    if seqs:
        l_max = int(config["max_seq_length"])
        live = np.arange(l_max)[None, :] < lengths[:, None]
        series_local: Dict[str, np.ndarray] = {}
        for series, feat in seqs.items():
            if feat not in derived:
                series_local[series] = _draw(config, maps, rng, feat, (b, l_max))
        for series, feat in seqs.items():
            if feat in derived:
                src_series = next(s for s, f in seqs.items() if f == derived[feat])
                series_local[series] = maps.derived[feat][series_local[src_series]]
        pad = int(config["padding_index"])
        for series, feat in seqs.items():
            batch[series] = np.where(live, series_local[series] + off[feat], pad)
    if mix.get("labels", False):
        batch["label"] = (rng.random(b) < float(config["click_rate"])).astype(np.float32)
    return batch


def batch_stats(config, batch: Dict[str, np.ndarray]) -> Dict[str, int]:
    """What the work counts read from a batch: its rows, the live steps of
    its first series, and the ids a step looks up."""
    seqs = list(config.get("sequences", {}))
    rows = len(next(iter(batch.values())))
    live = int(np.count_nonzero(batch[seqs[0]] != config["padding_index"])) if seqs else 0
    ids = sum(int(batch[n].size) for n in list(config["features"]) + seqs)
    return {"rows": rows, "live": live, "ids": ids}


def make_pool(config, mix, seed: int) -> List[Dict[str, np.ndarray]]:
    """The run's pool of ``mix['pool']`` host batches, from ``seed``."""
    maps = IdMaps(config, mix, seed)
    rng = generator(seed, "pool")
    return [make_batch(config, mix, maps, rng) for _ in range(int(mix["pool"]))]
