"""Synthetic raw-data generators (counterpart of ``tpurec/data/synthetic.py``:
the same files from the same seed).

The reference repo ships no raw data (only trained artifacts); its three data
families are (SURVEY §2): the tabular e-commerce logs of ch.2, the JSON
impression logs of ch.4, and the behavior-sequence logs of ch.5. These
generators produce raw files with the same shapes and planted preference
structure (tag-affinity matrices + noise) so that models trained on them
reach reference-class AUC and every pipeline stage can run end-to-end.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def make_ecommerce_raw(
    output_dir: str,
    n_users: int = 2000,
    n_items: int = 1000,
    n_events: int = 100_000,
    n_user_tags: Tuple[int, int] = (20, 12),
    n_item_tags: Tuple[int, int, int] = (30, 15, 8),
    signal: float = 9.0,  # oracle AUC ≈ 0.94 (with the rank-4 affinities
    # below) — headroom above the reference's e-commerce eval AUC class
    # (BASELINE.md: DSSM 0.9225 / DeepFM 0.9244)
    seed: int = 0,
) -> Dict[str, str]:
    """Chapter-2-style raw files: user_feature.dat (user_id, user_tag1,
    user_tag2), item_feature.dat (item_id, item_tag1..3), shop.dat
    (timestamp, user_id, item_id, label) — the schema consumed by
    2.FM/DataGenerator.py:62-66.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    u1 = rng.integers(0, n_user_tags[0], n_users)
    u2 = rng.integers(0, n_user_tags[1], n_users)
    i1 = rng.integers(0, n_item_tags[0], n_items)
    i2 = rng.integers(0, n_item_tags[1], n_items)
    i3 = rng.integers(0, n_item_tags[2], n_items)
    # planted affinity structure between tag pairs. LOW-RANK (rank 2; total
    # intrinsic rank 6 across the three matrices): real preference matrices
    # are approximately low-rank, and the reference's two-tower DSSM reaches
    # 0.92-class AUC with dim-8 towers (BASELINE.md) — a full-rank random
    # Gaussian is unfactorizable at that dim (rank-8 of a random 20×30 keeps
    # ~55% energy) and even rank-4×3 = rank 12 exceeds dim-8 towers, i.e.
    # harder than the reference's data, not "same difficulty class".
    def lowrank(n, m, scale=1.0, rank=2):
        return scale * (rng.normal(0, 1, (n, rank)) @ rng.normal(0, 1, (rank, m))) / np.sqrt(rank)

    a11 = lowrank(n_user_tags[0], n_item_tags[0])
    a22 = lowrank(n_user_tags[1], n_item_tags[1])
    a13 = lowrank(n_user_tags[0], n_item_tags[2], scale=0.5)

    users = rng.integers(0, n_users, n_events)
    items = rng.integers(0, n_items, n_events)
    score = signal * (
        a11[u1[users], i1[items]] + a22[u2[users], i2[items]] + a13[u1[users], i3[items]]
    ) / 3.0
    base = -1.0  # negative-skewed CTR
    labels = (rng.random(n_events) < _sigmoid(base + score)).astype(np.int64)
    timestamps = np.sort(rng.integers(1_600_000_000, 1_700_000_000, n_events))

    user_path = os.path.join(output_dir, "user_feature.dat")
    item_path = os.path.join(output_dir, "item_feature.dat")
    main_path = os.path.join(output_dir, "shop.dat")
    # Planted-parameter dump so harnesses can compute the Bayes oracle
    # numerically (oracle AUC over the event log; oracle recall@k by scoring
    # every item for a user with the TRUE affinities) instead of quoting
    # prose estimates. Not consumed by any model.
    oracle_path = os.path.join(output_dir, "oracle.npz")
    np.savez(
        oracle_path,
        u1=u1, u2=u2, i1=i1, i2=i2, i3=i3,
        a11=a11, a22=a22, a13=a13,
        signal=signal, base=base,
        event_users=users, event_items=items, event_labels=labels,
        event_scores=score,
    )
    with open(user_path, "w") as f:
        for uid in range(n_users):
            f.write(f"u{uid},ut1_{u1[uid]},ut2_{u2[uid]}\n")
    with open(item_path, "w") as f:
        for iid in range(n_items):
            f.write(f"i{iid},it1_{i1[iid]},it2_{i2[iid]},it3_{i3[iid]}\n")
    with open(main_path, "w") as f:
        for k in range(n_events):
            f.write(f"{timestamps[k]},u{users[k]},i{items[k]},{labels[k]}\n")
    return {
        "user_path": user_path,
        "item_path": item_path,
        "main_path": main_path,
        "oracle_path": oracle_path,
    }


def _score_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Mann-Whitney AUC (scores here are continuous — ties negligible)."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def make_dcn_raw(
    output_dir: str,
    n_users: int = 30_000,
    n_items: int = 12_000,
    n_events: int = 600_000,
    utag_dims: Tuple[int, ...] = (25, 18, 12, 8),
    itag_dims: Tuple[int, ...] = (40, 25, 15, 10),
    target_oracle_auc: float = 0.615,
    continuous_share: float = 0.35,
    seed: int = 0,
) -> Dict[str, str]:
    """Weak-signal impression table — the 3.DCN data regime.

    The reference's chapter-3 models train on real production impressions
    with features uid/iid/utag1-4/itag1-4 + itag4_origin/square/cube
    (3.DCN/ModelManager.py:14-15) where the headline baselines are FM eval
    AUC 0.5879 and AutoInt 0.5972 (BASELINE.md) — i.e. the signal is close
    to noise. This generator plants the same regime synthetically:

    - per-user / per-item latent biases (learnable only partially at ~20
      events per user — the high-cardinality weak-data effect),
    - weak additive tag main effects + a low-rank utag1×itag1 affinity,
    - a cubic effect of the per-item continuous feature ``itag4_origin``
      — exactly a linear function of the derived origin/square/cube
      columns, so models that consume continuous inputs (AutoInt, DCN)
      can capture it while the categorical-only FM cannot: the planted
      source of the reference's FM < AutoInt ordering.

    The total score is auto-scaled so the Bayes-oracle AUC of the sampled
    labels hits ``target_oracle_auc`` (numeric calibration, not prose);
    planted parameters are dumped to oracle.npz.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    utags = [rng.integers(0, d, n_users) for d in utag_dims]
    itags = [rng.integers(0, d, n_items) for d in itag_dims]
    item_v = rng.random(n_items).astype(np.float32)  # itag4_origin source

    b_user = rng.normal(0, 1.0, n_users)
    b_item = rng.normal(0, 1.0, n_items)
    m_ut = [rng.normal(0, 1.0, d) for d in utag_dims]
    m_it = [rng.normal(0, 1.0, d) for d in itag_dims]
    cross = rng.normal(0, 1, (utag_dims[0], 2)) @ rng.normal(0, 1, (2, itag_dims[0]))
    cross /= np.sqrt(2)

    users = rng.integers(0, n_users, n_events)
    items = rng.integers(0, n_items, n_events)
    # categorical part: tag mains dominate (low-cardinality, learnable at
    # this data volume), per-id biases and the cross stay minor — with only
    # ~20 events per uid an id-heavy mix would put most of the oracle out of
    # ANY model's reach and parity against the reference numbers would be
    # unmeasurable
    s_cat = (
        0.24 * (b_user[users] + b_item[items])
        + 0.55 * sum(m[t[users]] for m, t in zip(m_ut, utags))
        / np.sqrt(len(utag_dims))
        + 0.55 * sum(m[t[items]] for m, t in zip(m_it, itags))
        / np.sqrt(len(itag_dims))
        + 0.4 * cross[utags[0][users], itags[0][items]]
    )
    # continuous part: cubic in itag4_origin (linear in origin/sq/cube)
    v = item_v[items]
    s_cont = v**3 - 0.7 * v
    s_cont = (s_cont - s_cont.mean()) / s_cont.std()
    s_cat = (s_cat - s_cat.mean()) / s_cat.std()
    score = np.sqrt(1 - continuous_share) * s_cat + np.sqrt(continuous_share) * s_cont

    # bisection on the global scale so oracle AUC == target (sampled labels)
    base = -1.2  # negative-skewed CTR like production logs
    lo, hi, scale = 0.0, 4.0, 1.0
    sub = slice(0, min(200_000, n_events))
    cal_rng = np.random.default_rng(seed + 1)
    cal_u = cal_rng.random(len(score[sub]))
    for _ in range(18):
        scale = 0.5 * (lo + hi)
        lab = (cal_u < _sigmoid(base + scale * score[sub])).astype(np.int64)
        auc = _score_auc(score[sub], lab)
        if auc < target_oracle_auc:
            lo = scale
        else:
            hi = scale
    labels = (rng.random(n_events) < _sigmoid(base + scale * score)).astype(np.int64)
    timestamps = np.sort(rng.integers(1_600_000_000, 1_700_000_000, n_events))

    main_path = os.path.join(output_dir, "impression.csv")
    cols = ["timestamp", "uid", "iid"]
    cols += [f"utag{j+1}" for j in range(len(utag_dims))]
    cols += [f"itag{j+1}" for j in range(len(itag_dims))]
    cols += ["itag4_origin", "ctr"]
    with open(main_path, "w") as f:
        f.write(",".join(cols) + "\n")
        for k in range(n_events):
            u, i = users[k], items[k]
            row = [str(timestamps[k]), f"u{u}", f"i{i}"]
            row += [f"ut{j+1}_{t[u]}" for j, t in enumerate(utags)]
            row += [f"it{j+1}_{t[i]}" for j, t in enumerate(itags)]
            row += [f"{item_v[i]:.6f}", str(labels[k])]
            f.write(",".join(row) + "\n")
    oracle_path = os.path.join(output_dir, "oracle.npz")
    # component ceilings (diagnostics for parity tuning): how much of the
    # cat-only oracle is carried by the low-cardinality tags+cross vs the
    # noisy per-id biases a model must estimate from ~20 events/id
    s_tags = (
        0.55 * sum(m[t[users]] for m, t in zip(m_ut, utags)) / np.sqrt(len(utag_dims))
        + 0.55 * sum(m[t[items]] for m, t in zip(m_it, itags)) / np.sqrt(len(itag_dims))
        + 0.4 * cross[utags[0][users], itags[0][items]]
    )
    np.savez(
        oracle_path,
        event_scores=score,
        event_labels=labels,
        scale=scale,
        base=base,
        oracle_auc=_score_auc(score, labels),
        cat_only_auc=_score_auc(s_cat, labels),
        tags_only_auc=_score_auc(s_tags, labels),
    )
    return {"main_path": main_path, "oracle_path": oracle_path}


def make_impression_log_raw(
    output_dir: str,
    n_events: int = 50_000,
    n_cat: int = 6,
    cat_cardinality: int = 25,
    n_continuous: int = 3,
    signal: float = 20.0,  # oracle CTR-AUC ≈ 0.986 (recorded numerically in
    # oracle.npz) — the reference 4.MMOE data's own class: its best-epoch
    # eval ctr AUC was 0.9844 (BASELINE.md), so its Bayes ceiling is ≥0.985;
    # the 0.9767 final-epoch target sits comfortably inside this class
    full_chain: bool = False,
    seed: int = 0,
) -> str:
    """Chapter-4-style JSON-lines impression log with nested feature records
    and a '0$#0'-format ctr/cvr label (4.MMOE/DataGenerator.py:22-116).
    CVR is only possible given CTR=1 (probability-chain structure).

    With ``full_chain=True`` the Label carries the 6-node conversion chain
    click$#cart$#collect$#none$#order$#pay: given a click, the user takes
    exactly one of {cart, collect, none} (cart-over-collect priority as in
    the reference graph, 9.ESCM2/CustomLayers.py:566-580); each branch
    converts to an order at its own planted rate, and orders pay at a planted
    rate — the data model the reference ESM2Layer's per-edge BCEs assume."""
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    cats = rng.integers(0, cat_cardinality, (n_events, n_cat))
    conts = rng.random((n_events, n_continuous))
    w_ctr = rng.normal(0, 1, (n_cat, cat_cardinality))
    w_cvr = rng.normal(0, 1, (n_cat, cat_cardinality))
    wc_ctr = rng.normal(0, 1, n_continuous)
    s_ctr = signal * np.mean(w_ctr[np.arange(n_cat)[None, :], cats], axis=1) + conts @ wc_ctr * 0.5
    s_cvr = signal * np.mean(w_cvr[np.arange(n_cat)[None, :], cats], axis=1)
    ctr = (rng.random(n_events) < _sigmoid(-1.0 + s_ctr)).astype(int)
    if full_chain:
        # branch choice (cart > collect > none), feature-dependent so every
        # edge is learnable
        w_br = rng.normal(0, 1, (n_cat, cat_cardinality))
        s_br = signal * 0.5 * np.mean(w_br[np.arange(n_cat)[None, :], cats], axis=1)
        cart = (ctr == 1) & (rng.random(n_events) < _sigmoid(-0.6 + s_br))
        collect = (ctr == 1) & ~cart & (rng.random(n_events) < _sigmoid(-0.2 + s_br))
        none = (ctr == 1) & ~cart & ~collect
        p_order = _sigmoid(-0.5 + s_cvr)
        order = (
            (cart & (rng.random(n_events) < p_order))
            | (collect & (rng.random(n_events) < 0.6 * p_order))
            | (none & (rng.random(n_events) < 0.15 * p_order))
        )
        pay = order & (rng.random(n_events) < _sigmoid(0.5 + 0.5 * s_cvr))
        chain = np.stack(
            [ctr, cart.astype(int), collect.astype(int), none.astype(int),
             order.astype(int), pay.astype(int)], axis=1,
        )
    else:
        cvr = ((rng.random(n_events) < _sigmoid(-0.5 + s_cvr)) & (ctr == 1)).astype(int)
    # numeric Bayes-oracle dump (VERDICT r1: oracle claims must be computed
    # in the harness, not asserted): ctr oracle scores with the true s_ctr;
    # the cvr label over ALL impressions is Bernoulli(p_click·p_conv) so its
    # oracle predictor is that product
    p_click = _sigmoid(-1.0 + s_ctr)
    p_conv = _sigmoid(-0.5 + s_cvr)
    if full_chain:
        np.savez(
            os.path.join(output_dir, "oracle.npz"),
            oracle_ctr_auc=_score_auc(s_ctr, ctr),
        )
    else:
        np.savez(
            os.path.join(output_dir, "oracle.npz"),
            oracle_ctr_auc=_score_auc(s_ctr, ctr),
            oracle_cvr_auc=_score_auc(p_click * p_conv, cvr.astype(np.int64)),
        )
    path = os.path.join(output_dir, "impression_log.jsonl")
    with open(path, "w") as f:
        for k in range(n_events):
            label = (
                "$#".join(str(int(v)) for v in chain[k])
                if full_chain
                else f"{ctr[k]}$#{cvr[k]}"
            )
            rec = {
                "Label": label,
                "features": {f"cat_{j}": f"v{cats[k, j]}" for j in range(n_cat)},
                "continuous": {
                    f"cont_{j}": float(conts[k, j]) for j in range(n_continuous)
                },
            }
            f.write(json.dumps(rec) + "\n")
    return path


def make_behavior_sequence_raw(
    output_dir: str,
    n_users: int = 1500,
    n_items: int = 800,
    n_events: int = 60_000,
    max_history: int = 30,
    n_user_tags: int = 15,
    n_item_tags: int = 20,
    signal: float = 2.5,
    n_positions: int = 0,
    n_pages: int = 0,
    position_bias: float = 0.35,
    seed: int = 0,
) -> Dict[str, str]:
    """Chapter-5-style sequence logs: each event has a candidate item, a
    clipped click-history sequence, user/item profile tags, and a label
    (schema of 5.DIN/DataGenerator.py). Users have latent interest clusters
    so history actually predicts the label (target-attention signal).

    Each event carries PARALLEL behavior series — the item-id history plus
    the aligned item-tag history (``history_tags``) — matching the
    reference's multi-series data model (visited_goods_ids /
    visited_shop_ids / visited_cate_ids, 5.DIN/ModelManager.py:13-20,
    6.MIND/CustomLayers.py:162-172).

    With ``n_positions > 0`` each event additionally carries display-context
    columns ``position`` (1-indexed slot) and ``page`` with a planted
    presentation bias — clicks decay with slot index — plus a chained
    ``conversion`` label that is NOT position-biased. This is the data model
    the reference's DMT position-bias towers assume (8.DMR/CustomLayers.py:
    570-574: bias logits are added to the task logits during training only).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    u_tag = rng.integers(0, n_user_tags, n_users)
    i_tag = rng.integers(0, n_item_tags, n_items)
    # latent interest vectors
    n_topics = 8
    user_topic = rng.dirichlet(np.ones(n_topics) * 0.3, n_users)
    item_topic = rng.integers(0, n_topics, n_items)
    affinity = rng.normal(0, 1, (n_user_tags, n_item_tags))

    # simulate per-user histories by sampling items ∝ user topic preference
    histories = []
    for u in range(n_users):
        p = user_topic[u][item_topic]
        p = p / p.sum()
        hist_len = rng.integers(3, max_history + 1)
        histories.append(rng.choice(n_items, size=hist_len, p=p))

    events_path = os.path.join(output_dir, "events.jsonl")
    with open(events_path, "w") as f:
        for _ in range(n_events):
            u = int(rng.integers(0, n_users))
            i = int(rng.integers(0, n_items))
            topical = user_topic[u][item_topic[i]] * n_topics  # ~1.0 mean
            s = signal * (0.7 * (topical - 1.0) + 0.3 * affinity[u_tag[u], i_tag[i]])
            rec = {
                "user_id": f"u{u}",
                "item_id": f"i{i}",
                "user_tag": f"ut{u_tag[u]}",
                "item_tag": f"it{i_tag[i]}",
                "history": [f"i{h}" for h in histories[u]],
                "history_tags": [f"it{i_tag[h]}" for h in histories[u]],
            }
            if n_positions > 0:
                pos = int(rng.integers(0, n_positions))
                page = int(rng.integers(0, max(1, n_pages)))
                # clicks decay with slot; conversions (given click) do not
                label = int(rng.random() < _sigmoid(-0.8 + s - position_bias * pos))
                conv = int(label and rng.random() < _sigmoid(-0.5 + s))
                rec["position"] = f"p{pos}"
                rec["page"] = f"pg{page}"
                rec["conversion"] = conv
            else:
                label = int(rng.random() < _sigmoid(-0.8 + s))
            rec["label"] = label
            f.write(json.dumps(rec) + "\n")
    profile_path = os.path.join(output_dir, "item_profiles.jsonl")
    with open(profile_path, "w") as f:
        for i in range(n_items):
            f.write(json.dumps({"item_id": f"i{i}", "item_tag": f"it{i_tag[i]}"}) + "\n")
    # planted-parameter dump: lets harnesses compute Bayes oracle AUC /
    # recall@k numerically (rank every item by the TRUE score for a user)
    oracle_path = os.path.join(output_dir, "oracle.npz")
    np.savez(
        oracle_path,
        user_topic=user_topic, item_topic=item_topic, affinity=affinity,
        u_tag=u_tag, i_tag=i_tag, signal=signal, n_topics=n_topics,
    )
    return {
        "events_path": events_path,
        "item_profile_path": profile_path,
        "oracle_path": oracle_path,
    }
