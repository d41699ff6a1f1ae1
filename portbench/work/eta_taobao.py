"""The model FLOPs of an ETA training step on one batch, from the
configuration's shapes and the batch's rows and live steps; products only
(2 a multiply-add), nothing recomputed.

- The search, once (it has no backward): the SimHash product of each live
  step's key and of each row's candidate with the (K, n_bits) projection.
- Three times (the forward, and the backward's two products a product):
  each row's two attentions, the long-term one over its ``topk`` picks and
  the short-term one over ``short_len`` steps (the model's work; the
  program computes the short-term keys and values at all L steps under a
  mask): the query's, the keys' and the values' projections, the logits,
  the weighted sum and the output projection; and the two heads' MLPs.
Rows with fewer live steps than ``topk`` or ``short_len`` are counted at
``topk`` and ``short_len`` (the batch's statistics give no per-row
counts). K is the key width, W the heads' width."""


def flops(cfg, stats) -> float:
    d = cfg["embed_dim"]
    p = cfg["params"]
    key = len(cfg["sequences"]) * d
    width = p["num_heads"] * max(1, key // p["num_heads"])
    search = 2 * key * p["n_hash_bits"] * (stats["live"] + stats["rows"])

    def attention(steps):
        return 2 * key * width * (2 + 2 * steps) + 2 * 2 * steps * width

    profile = (len(cfg["user_features"]) + len(cfg["item_features"])) * d
    heads = 0
    for width_in in (profile + 2 * key, profile + 3 * key):
        for out in list(p["hidden_dims"]) + [2]:
            heads += 2 * width_in * out
            width_in = out
    per_row = attention(p["topk"]) + attention(p["short_len"]) + heads
    return search + 3.0 * stats["rows"] * per_row
