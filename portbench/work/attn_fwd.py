"""The work of DIN's attention forward on one batch (kernel #4's
operation): the keys read and scored at live steps only (a padded step's
score is 0 and adds nothing to the pooled sum); the query, the mask, the
weights read and the pooled rows and scores written once; per live step the
product of the keys with the row's folded weights (on the tensor cores in
3xTF32) and the activation, per row the fold. Frozen from the count the
kernel was designed against."""

from portbench.lib.peaks import least_seconds


def shapes(cfg, stats):
    d = len(cfg["sequences"]) * cfg["embed_dim"]
    return stats["rows"], int(cfg["max_seq_length"]), d, cfg["params"]["attention_hidden_dims"][0], stats["live"]


def least_s(cfg, stats) -> float:
    b, l, d, h, live = shapes(cfg, stats)
    nbytes = 4 * (b * d + live * d + b * l + 4 * d * h + 3 * h + b * d + b * l)
    mma = live * 2 * d * h
    fma = live * (6 * h + 1) + b * (6 * d * h + h) + 2 * live * d
    return least_seconds(nbytes, fma, mma)
