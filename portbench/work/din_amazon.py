"""The model FLOPs of a DIN training step on one batch, from the
configuration's shapes and the batch's live steps: the activation unit's
two products and the pooled sum at live steps, the MLP's and the head's
products at every row. A training step counts three times the forward (the
backward's two products a product); nothing recomputed is counted."""


def flops(cfg, stats) -> float:
    d = cfg["embed_dim"]
    key = len(cfg["sequences"]) * d
    h = cfg["params"]["attention_hidden_dims"][0]
    per_live = 2 * 4 * key * h + 2 * h + 2 * key
    width = (len(cfg["user_features"]) + len(cfg["item_features"])) * d + 2 * key
    per_row = 0
    for out in list(cfg["params"]["hidden_dims"]) + [1]:
        per_row += 2 * width * out
        width = out
    forward = stats["live"] * per_live + stats["rows"] * per_row
    return 3.0 * forward
