"""The model FLOPs of a DeepFM training step on one batch, from the
configuration's shapes: the deep part's and the head's products and the FM
cross term at every row. A training step counts three times the forward;
nothing recomputed is counted."""


def flops(cfg, stats) -> float:
    f, d = len(cfg["features"]), cfg["embed_dim"]
    width, per_row = f * d, 2 * f * d + 3 * d
    for out in list(cfg["params"]["hidden_dims"]) + [1]:
        per_row += 2 * width * out
        width = out
    forward = stats["rows"] * per_row
    return 3.0 * forward
