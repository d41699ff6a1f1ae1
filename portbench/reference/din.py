"""DIN in plain PyTorch (Zhou et al., KDD 2018, Fig. 2), with the semantics
of the framework's DIN: one shared table over the offset-encoded ids; the
profile, the candidate (its goods and category ids side by side) and the
behaviour series (the same two, one step each) looked up in it; the
activation unit MLP([q, q - k, k, q * k]) with one PReLU layer and a
linear score, zero at padded steps, and the sum of the keys weighted by
the scores (no softmax, as in the paper); then profile | candidate | pooled
through the MLP (relu after every layer) and a linear head.

``rnd`` is applied where the program computes in its compute type (the
lookups, the MLP's inputs, weights and outputs); the attention runs in fp32
on the rounded keys, as the program runs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Layout, dense, table_rows


def layout(cfg) -> Layout:
    d = cfg["embed_dim"]
    h = cfg["params"]["attention_hidden_dims"]
    if len(h) != 1:
        raise ValueError("the reference's activation unit has one hidden layer")
    key = len(cfg["sequences"]) * d
    n_profile = len(cfg["user_features"]) + len(cfg["item_features"])
    width = n_profile * d + 2 * key
    out: Layout = [
        ("emb.embedding", (table_rows(sum(cfg["features"].values())), d), "table"),
        ("att.w1", (4 * key, h[0]), "glorot"),
        ("att.b1", (h[0],), "zeros"),
        ("att.w2", (h[0], 1), "glorot"),
        ("att.alpha", (h[0],), 0.25),
    ]
    for i, wd in enumerate(cfg["params"]["hidden_dims"]):
        out += [(f"mlp.dense_{i}.weight", (wd, width), "glorot"), (f"mlp.dense_{i}.bias", (wd,), "zeros")]
        width = wd
    out += [("head.weight", (1, width), "glorot"), ("head.bias", (1,), "zeros")]
    return out


def forward(p, batch, cfg, rnd) -> torch.Tensor:
    """(B,) fp32 logits."""
    table = p["emb.embedding"]

    def look(ids):
        return rnd(F.embedding(ids, table))

    profile = [look(batch[n]) for n in cfg["user_features"] + cfg["item_features"]]
    query = torch.cat([look(batch[n]) for n in cfg["query_features"]], dim=-1)
    series = list(cfg["sequences"])
    keys = torch.cat([look(batch[s]) for s in series], dim=-1)
    mask = batch[series[0]] != cfg["padding_index"]
    q = query[:, None, :].expand_as(keys)
    lin = torch.cat([q, q - keys, keys, q * keys], dim=-1) @ p["att.w1"] + p["att.b1"]
    hidden = torch.where(lin > 0, lin, p["att.alpha"] * lin)
    scores = torch.where(mask, (hidden @ p["att.w2"])[..., 0], 0.0)
    pooled = torch.einsum("bl,bld->bd", scores, keys)
    x = torch.cat(profile + [query, rnd(pooled)], dim=-1)
    for i in range(len(cfg["params"]["hidden_dims"])):
        x = torch.relu(dense(x, p[f"mlp.dense_{i}.weight"], p[f"mlp.dense_{i}.bias"], rnd))
    return dense(x, p["head.weight"], p["head.bias"], rnd).reshape(-1).float()
