"""DeepFM in plain PyTorch (Guo et al., IJCAI 2017, Sec. 2), with the
semantics of the framework's DeepFM: one shared (V, D) table ``v`` and one
(V, 1) order-1 table ``w`` over the offset-encoded ids of every field; the
logit is bias + the fields' w + the FM cross term 0.5 * sum_d((sum_f v)^2 -
sum_f v^2) + the deep part (the fields' v flattened, the MLP with relu after
every layer, a linear head).

``rnd`` is applied where the program computes in its compute type (the v
lookup, the cross term, the MLP's inputs, weights and outputs); the
order-1 terms and the sum stay fp32, as in the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Layout, dense, table_rows


def layout(cfg) -> Layout:
    d = cfg["embed_dim"]
    rows = table_rows(sum(cfg["features"].values()))
    width = len(cfg["features"]) * d
    out: Layout = [
        ("bias", (), "zeros"),
        ("w.w.embedding", (rows, 1), "table"),
        ("v.embedding", (rows, d), "table"),
    ]
    for i, wd in enumerate(cfg["params"]["hidden_dims"]):
        out += [(f"deep.dense_{i}.weight", (wd, width), "glorot"), (f"deep.dense_{i}.bias", (wd,), "zeros")]
        width = wd
    out += [("deep_head.weight", (1, width), "glorot"), ("deep_head.bias", (1,), "zeros")]
    return out


def forward(p, batch, cfg, rnd) -> torch.Tensor:
    """(B,) fp32 logits."""
    ids = torch.stack([batch[n] for n in cfg["features"]], dim=1)
    emb = rnd(F.embedding(ids, p["v.embedding"]))
    order1 = F.embedding(ids, p["w.w.embedding"])[..., 0].sum(dim=1)
    cross = rnd(0.5 * (emb.sum(dim=1).square() - emb.square().sum(dim=1)).sum(dim=-1))
    x = emb.reshape(emb.shape[0], -1)
    for i in range(len(cfg["params"]["hidden_dims"])):
        x = torch.relu(dense(x, p[f"deep.dense_{i}.weight"], p[f"deep.dense_{i}.bias"], rnd))
    deep = dense(x, p["deep_head.weight"], p["deep_head.bias"], rnd).reshape(-1)
    return (p["bias"] + order1 + cross + deep).float()
