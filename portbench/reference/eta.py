"""ETA in plain PyTorch (Chen et al., arXiv:2108.04468, Sec. 3), with the
semantics of the framework's ETA: one shared table over the offset-encoded
ids; the profile, the candidate e_t (its goods and category ids side by
side) and the behaviours e_i (the same two, one step each) looked up in it;
SimHash codes sign(e · R) of the candidate and of every behaviour under the
fixed Gaussian projection R; the k live behaviours whose codes agree with
the candidate's in the most bits; multi-head target attention of e_t over
those k (the long-term interest) and over the most recent behaviours (the
short-term interest); profile | e_t | both interests through an MLP (relu
after every layer) to a two-class head.

Departures from the paper, each the framework's:
- an auxiliary two-class head on profile | e_t | the long-term interest,
  trained with the final head by ``loss`` (0.2 and 0.8 of the two cross
  entropies, the configuration's ``loss_weights``);
- the short-term attention runs over all L steps under a mask that keeps
  each row's last ``short_len`` live steps (the live steps a prefix), which
  gives what attending over those steps alone gives;
- the attention is the framework's ``MultiHeadAttention``: q, k and v
  projections without bias, softmax(q k^T / sqrt(head width)) v with -1e9
  on masked logits, an output projection with bias, the residual of the
  query, and a LayerNorm (epsilon 1e-6, its variance E[x^2] - E[x]^2
  clipped at 0);
- the picks: an invalid step scores -inf, ties break to the lower step
  (a stable sort), and a row with no live step picks its first k steps, all
  masked.

The search is discrete: it runs on the lookups rounded to the
configuration's compute type, as the program's search does, with the
SimHash product in fp32. ``rnd`` is applied where the program computes in
its compute type (the lookups, the attention's and the MLP's products,
their inputs, weights and outputs); everything after the pick is fp32
otherwise. The projection is a constant handed in beside the parameters.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import Layout, dense, plain_fp32, table_rows

LN_EPSILON = 1e-6
MASKED = -1e9


def layout(cfg) -> Layout:
    d = cfg["embed_dim"]
    p = cfg["params"]
    key = len(cfg["sequences"]) * d
    width = p["num_heads"] * max(1, key // p["num_heads"])
    profile = (len(cfg["user_features"]) + len(cfg["item_features"])) * d
    out: Layout = [("emb.embedding", (table_rows(sum(cfg["features"].values())), d), "table")]
    for mha in ("long_mha", "short_mha"):
        out += [(f"{mha}.{x}.weight", (width, key), "glorot") for x in "qkv"]
        out += [(f"{mha}.out.weight", (key, width), "glorot"), (f"{mha}.out.bias", (key,), "zeros"),
                (f"{mha}.ln.scale", (key,), 1.0), (f"{mha}.ln.bias", (key,), "zeros")]
    for head, n_in in (("gsu", profile + 2 * key), ("esu", profile + 3 * key)):
        for i, wd in enumerate(p["hidden_dims"]):
            out += [(f"{head}_mlp.dense_{i}.weight", (wd, n_in), "glorot"),
                    (f"{head}_mlp.dense_{i}.bias", (wd,), "zeros")]
            n_in = wd
        out += [(f"{head}_head.weight", (2, n_in), "glorot"), (f"{head}_head.bias", (2,), "zeros")]
    return out


def projection(cfg, seed: int, device) -> torch.Tensor:
    """The SimHash projection R (key width x ``n_hash_bits``), a standard
    Gaussian drawn from ``seed`` (a stream of its own)."""
    key = len(cfg["sequences"]) * cfg["embed_dim"]
    rng = np.random.default_rng([seed % 2**63, 3])
    r = rng.standard_normal((key, cfg["params"]["n_hash_bits"])).astype(np.float32)
    return torch.as_tensor(r, device=device)


def simhash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """The sign bits of x · R in fp32: 1 where the product is > 0."""
    return torch.einsum("...d,db->...b", x.float(), proj) > 0


def search(query: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor, proj: torch.Tensor, k: int):
    """(picked steps (B, k), their mask (B, k)): the live steps by the number
    of SimHash bits they share with the query, most first, the lower step
    first among equals, the invalid steps last."""
    sim = (simhash(query, proj)[:, None, :] == simhash(keys, proj)).sum(dim=-1).float()
    sim = torch.where(mask, sim, -torch.inf)
    order = torch.sort(sim, dim=-1, descending=True, stable=True).indices[:, :k]
    return order, torch.isfinite(sim.gather(1, order))


def recent(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` live steps of each row (its live steps a prefix)."""
    steps = torch.arange(mask.shape[1], device=mask.device)[None, :]
    return mask & (steps >= mask.sum(dim=-1, keepdim=True) - n)


def attention(p, name: str, heads: int, q_in, kv, mask, rnd) -> torch.Tensor:
    """The query (B, 1, D) over (B, Lk, D) under a (B, Lk) mask -> (B, D)."""
    b, lk, d = kv.shape
    hd = p[f"{name}.q.weight"].shape[0] // heads

    def split(x, w, length):
        return rnd(F.linear(rnd(x), rnd(w))).reshape(b, length, heads, hd).transpose(1, 2)

    q = split(q_in, p[f"{name}.q.weight"], 1)
    k = split(kv, p[f"{name}.k.weight"], lk)
    v = split(kv, p[f"{name}.v.weight"], lk)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    logits = rnd(torch.einsum("bhqd,bhkd->bhqk", q, k)) * scale
    weights = torch.softmax(torch.where(mask[:, None, None, :], logits, MASKED), dim=-1)
    out = rnd(torch.einsum("bhqk,bhkd->bhqd", rnd(weights), v))
    out = dense(out.transpose(1, 2).reshape(b, 1, heads * hd), p[f"{name}.out.weight"],
                p[f"{name}.out.bias"], rnd)
    x = rnd(out + q_in)
    mean = x.mean(dim=-1, keepdim=True)
    var = (torch.square(x).mean(dim=-1, keepdim=True) - torch.square(mean)).clamp_min(0.0)
    y = (x - mean) * (torch.rsqrt(var + LN_EPSILON) * p[f"{name}.ln.scale"]) + p[f"{name}.ln.bias"]
    return rnd(y)[:, 0]


def head(p, name: str, x, cfg, rnd) -> torch.Tensor:
    for i in range(len(cfg["params"]["hidden_dims"])):
        x = torch.relu(dense(x, p[f"{name}_mlp.dense_{i}.weight"], p[f"{name}_mlp.dense_{i}.bias"], rnd))
    return dense(x, p[f"{name}_head.weight"], p[f"{name}_head.bias"], rnd).float()


def forward(p, batch, cfg, rnd, proj):
    """(GSU logits, ESU logits), each (B, 2) fp32, and the picked steps; the
    products without TF32."""
    with plain_fp32():
        return _forward(p, batch, cfg, rnd, proj)


def _forward(p, batch, cfg, rnd, proj):
    table = p["emb.embedding"]
    compute = getattr(torch, cfg["compute_dtype"])
    prm = cfg["params"]

    def look(names):
        return torch.cat([F.embedding(batch[n], table) for n in names], dim=-1)

    profile = [rnd(F.embedding(batch[n], table)) for n in cfg["user_features"] + cfg["item_features"]]
    series = list(cfg["sequences"])
    query, keys = rnd(look(cfg["query_features"])), rnd(look(series))
    mask = batch[series[0]] != cfg["padding_index"]
    with torch.no_grad():
        picked, picked_mask = search(query.to(compute), keys.to(compute), mask, proj,
                                     min(prm["topk"], keys.shape[1]))
    sub = keys.gather(1, picked[..., None].expand(-1, -1, keys.shape[-1]))
    q_in = query[:, None, :]
    long_att = attention(p, "long_mha", prm["num_heads"], q_in, sub, picked_mask, rnd)
    short_att = attention(p, "short_mha", prm["num_heads"], q_in, keys, recent(mask, prm["short_len"]), rnd)
    gsu = head(p, "gsu", torch.cat(profile + [query, long_att], dim=-1), cfg, rnd)
    esu = head(p, "esu", torch.cat(profile + [query, long_att, short_att], dim=-1), cfg, rnd)
    return gsu, esu, picked


def loss(outputs, label: torch.Tensor, cfg) -> torch.Tensor:
    """The weighted sum of the two heads' cross entropies."""
    gsu, esu = outputs[0], outputs[1]
    y = label.reshape(-1).long()
    w = cfg["loss_weights"]
    return w["gsu"] * F.cross_entropy(gsu, y) + w["esu"] * F.cross_entropy(esu, y)
