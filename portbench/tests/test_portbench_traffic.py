"""The traffic generator: the same batches for the same seed, the declared
shapes, its Zipf law and the exponents fitted to the sources' counts, and
DIN's prefix histories."""

import numpy as np
import pytest

from portbench.lib import spec, traffic
from portbench.tests import tiny


def test_same_seed_same_batches_and_other_seed_others():
    c = tiny.cell("din_amazon.train")
    a = traffic.make_pool(c.config, c.traffic, 2**31 + 17)
    b = traffic.make_pool(c.config, c.traffic, 2**31 + 17)
    d = traffic.make_pool(c.config, c.traffic, 2**31 + 18)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["item_id"], d[0]["item_id"])


@pytest.mark.parametrize("workload", ["din_amazon.train", "deepfm_criteo.train_dense"])
def test_declared_shapes_and_id_ranges(workload):
    c = tiny.cell(workload)
    cfg, mix = c.config, c.traffic
    off = traffic.offsets(cfg["features"])
    b = int(mix["batch"])
    for batch in traffic.make_pool(cfg, mix, 5):
        for name, dim in cfg["features"].items():
            x = batch[name]
            assert x.shape == (b,) and x.dtype == np.int64
            assert x.min() >= off[name] and x.max() < off[name] + dim
        for series, feat in cfg.get("sequences", {}).items():
            x = batch[series]
            assert x.shape == (b, cfg["max_seq_length"])
            live = x != cfg["padding_index"]
            lengths = live.sum(1)
            assert lengths.min() >= 1 and lengths.max() <= cfg["max_seq_length"]
            assert np.all(live[:, :-1] >= live[:, 1:])  # padded at the end only
            assert np.all((x[live] >= off[feat]) & (x[live] < off[feat] + cfg["features"][feat]))
        assert ("label" in batch) == bool(mix.get("labels"))


def test_derived_category_is_one_map_over_candidates_and_histories():
    c = tiny.cell("din_amazon.train")
    cate_of = {}
    for batch in traffic.make_pool(c.config, c.traffic, 9):
        pairs = [(batch["item_id"], batch["item_cate"])]
        live = batch["hist_item"] != 0
        pairs.append((batch["hist_item"][live], batch["hist_cate"][live]))
        for items, cates in pairs:
            for i, k in zip(items.tolist(), cates.tolist()):
                assert cate_of.setdefault(i, k) == k


def test_zipf_ranks_follow_the_bounded_power_law():
    rng = np.random.default_rng(0)
    n, s = 63_001, 1.05
    r = traffic.zipf_ranks(rng, n, s, 2_000_000)
    assert r.min() >= 0 and r.max() < n
    # P(rank < k) of the continuous law over [1, n + 1)
    for k in (1, 10, 100, 1000, 10_000):
        a = 1 - s
        want = ((k + 1) ** a - 1) / ((n + 1) ** a - 1)
        assert abs(np.mean(r < k) - want) < 0.003


def test_permutation_spreads_the_hot_ranks_and_keeps_the_law():
    c = spec.load_cell("din_amazon.train")
    maps = traffic.IdMaps(c.config, c.traffic, 7)
    n = c.config["features"]["item_id"]
    ids = maps.ids("item_id", np.arange(n), n)
    assert np.array_equal(np.sort(ids), np.arange(n))  # a bijection
    batch = traffic.make_batch(c.config, dict(c.traffic, batch=8192), maps, np.random.default_rng(1))
    local = batch["hist_item"][batch["hist_item"] != 0] - traffic.offsets(c.config["features"])["item_id"]
    counts = np.bincount(local, minlength=n)
    top = np.argsort(-counts)[:3]
    assert set(top.tolist()) == set(ids[:3].tolist())  # the three hottest ranks are the hottest ids


def test_labels_are_bernoulli_at_the_click_rate():
    c = spec.load_cell("deepfm_criteo.train_dense")
    batch = traffic.make_batch(c.config, dict(c.traffic, batch=200_000),
                               traffic.IdMaps(c.config, c.traffic, 1), np.random.default_rng(2))
    assert abs(batch["label"].mean() - c.config["click_rate"]) < 0.005


@pytest.mark.parametrize("n,occurrences,least", [(63_001, 1_689_188, 5), (192_403, 1_689_188, 5),
                                                  (10_131_227, 45_840_617, 1), (3, 45_840_617, 1)])
def test_the_fitted_exponent_gives_the_rarest_id_its_least_count(n, occurrences, least):
    s = traffic.fitted_exponent(n, occurrences, least)
    r = np.arange(1, n + 1, dtype=np.float64)
    exact = occurrences * n ** -s / np.sum(r ** -s)
    assert exact == pytest.approx(least, rel=1e-6)
    with pytest.raises(ValueError):
        traffic.fitted_exponent(n, n * least - 1, least)


def test_the_fitted_laws_hold_the_sources_counts():
    din = spec.load_cell("din_amazon.train").config
    fm = spec.load_cell("deepfm_criteo.train_dense").config
    # DIN's Table 1: 1,689,188 reviews of 192,403 users, at least 5 each
    samples = traffic.user_samples(din, spec.load_cell("din_amazon.train").traffic)
    reviews = samples + 2
    assert reviews.min() == 5 and abs(reviews.sum() / 1_689_188 - 1) < 0.005
    assert abs(reviews.mean() - 1_689_188 / 192_403) < 0.05
    assert sum(fm["features"].values()) == 33_762_577 + 13 * 465 and len(fm["features"]) == 39


def test_prefix_histories_are_dins_training_samples():
    c = spec.load_cell("din_amazon.train")
    cfg, mix = c.config, c.traffic
    maps = traffic.IdMaps(cfg, mix, 1)
    b = traffic.make_batch(cfg, dict(mix, batch=200_000), maps, np.random.default_rng(3))
    lengths = (b["hist_item"] != 0).sum(1)
    # each (user, k), k = 1 .. n - 2, equally likely, cut at L = 64
    samples = maps.samples
    k = np.arange(1, int(samples.max()) + 1)
    p = np.array([(samples >= j).sum() for j in k], dtype=np.float64)
    p /= p.sum()
    want_mean = float(np.sum(np.minimum(k, 64) * p))
    assert abs(lengths.mean() - want_mean) < 0.05
    assert abs(np.mean(lengths == 64) - p[63:].sum()) < 0.002
    assert abs(np.mean(lengths == 1) - p[0]) < 0.003
    # a user's rows are as many as its samples: user ids follow the weights
    user = b["user_id"] - traffic.offsets(cfg["features"])["user_id"]
    top = maps.ids("user_id", np.arange(3), cfg["features"]["user_id"])
    share = np.mean(np.isin(user, top))
    assert abs(share - samples[:3].sum() / samples.sum()) < 0.002
    # a sample of user rank r has at most its n - 2 steps
    ranks = np.argsort(maps.ids("user_id", np.arange(len(samples)), len(samples)))
    assert np.all(lengths <= np.minimum(samples[ranks[user]], 64))
