"""The work of DIN's attention backward on one batch (kernel #5's
operation): a padded step has score 0 and no gradient, so it adds nothing
to the sums. Bytes: the query, mask, weights and pooled cotangent read, the
keys and score cotangents read at live steps, dq, all of dkeys and the
weight gradients written. Operations: per live step the three products
with the row's folded weights (on the tensor cores in 3xTF32) and ~8 an
activation column, per row the fold and its cotangent. Frozen from the
count the kernel was designed against."""

from portbench.lib.peaks import least_seconds
from portbench.work.attn_fwd import shapes


def least_s(cfg, stats) -> float:
    b, l, d, h, live = shapes(cfg, stats)
    nbytes = 4 * (3 * b * d + live * d + b * l * d + b * l + live + 2 * (4 * d * h + 3 * h))
    mma = 2 * 3 * live * d * h
    fma = 2 * (6 * b * d * h + live * d) + 8 * live * h
    return least_seconds(nbytes, fma, mma)
