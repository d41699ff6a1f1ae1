"""Composable losses (counterpart of ``tpurec/train/losses.py``).

Each is a named function ``loss_fn(outputs, batch, mesh=None) -> (loss,
logs)`` selected by ``TrainConfig.loss``: plain BCE, the 0.5/0.5 CTR+CVR
BCE, in-batch sampled softmax, the 0.2·GSU + 0.8·ESU softmax CE, and a
model's own loss. Auxiliary losses a model returns are added by
``add_auxiliary``. Losses are computed in fp32.

``mesh`` is the mesh whose 'data' axis splits the batch's rows (None when
this rank holds the whole batch). Every loss is a mean of per-row terms
over this rank's rows, which the trainer's average over 'data' makes the
global batch's; only the in-batch softmax, whose rows meet every row of
the global batch, reads it.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from tpurec_torch.core.collectives import gather_batch, gather_rows

Tensor = torch.Tensor
LossFn = Callable[[Dict[str, Tensor], Dict[str, Tensor]], Tuple[Tensor, Dict[str, Tensor]]]

_EPS = 1e-7


def _bce_from_outputs(outputs: Dict[str, Tensor], labels: Tensor, key: str = "") -> Tensor:
    """BCE, preferring the raw logit when the model exposes one."""
    logit_key = f"{key}logit" if key else "logit"
    out_key = f"{key}output" if key else "output"
    if logit_key in outputs:
        return F.binary_cross_entropy_with_logits(
            outputs[logit_key].reshape(-1).to(torch.float32), labels
        )
    p = outputs[out_key].reshape(-1).to(torch.float32).clamp(_EPS, 1.0 - _EPS)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p)).mean()


def bce(outputs, batch, mesh=None):
    labels = batch["label"].reshape(-1).to(torch.float32)
    loss = _bce_from_outputs(outputs, labels)
    return loss, {"bce": loss}


def multi_task(outputs, batch, mesh=None, weights=(0.5, 0.5)):
    """CTR + CVR weighted BCE; for ESMM-style models the CVR label
    supervises the ctcvr output."""
    ctr_labels = batch["ctr"].reshape(-1).to(torch.float32)
    cvr_labels = batch["cvr"].reshape(-1).to(torch.float32)
    ctr_loss = _bce_from_outputs(outputs, ctr_labels, key="ctr_")
    cvr_key = "ctcvr_" if "ctcvr_output" in outputs else "cvr_"
    cvr_loss = _bce_from_outputs(outputs, cvr_labels, key=cvr_key)
    loss = weights[0] * ctr_loss + weights[1] * cvr_loss
    return loss, {"ctr_bce": ctr_loss, "cvr_bce": cvr_loss}


def tower_logits(outputs, mesh=None) -> Tuple[Tensor, Tensor]:
    """The in-batch softmax's (B, B_global) logits of this rank's users
    against the global batch's items, and each row's positive column
    (``data_index · B`` + its row): the item tower's embeddings are gathered
    over 'data' (``gather_batch``, whose backward returns every rank's
    cotangent to the row's owner). Unmasked; ``mesh`` None: (B, B)."""
    u = outputs["user_embedding"].to(torch.float32)
    v = gather_batch(outputs["item_embedding"].to(torch.float32), mesh)
    offset = mesh.data_index * u.shape[0] if mesh is not None else 0
    labels = torch.arange(offset, offset + u.shape[0], device=u.device)
    return u @ v.T, labels


def in_batch_softmax(outputs, batch, mesh=None):
    """Sampled softmax over [positive ∥ in-batch negatives].

    With model 'logits' (B, 1+N) the positive is column 0; otherwise logits
    are built from the tower embeddings with the global batch's items as
    negatives (``tower_logits``), and entries other than the row's positive
    whose 'item_id' equals it are masked out as accidental hits (the ids
    gathered over 'data' too: raw ids, or positions in the lazy-sparse
    engine's unique list, which is the global batch's)."""
    if "logits" in outputs:
        logits = outputs["logits"].to(torch.float32)
        labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    else:
        logits, labels = tower_logits(outputs, mesh)
        ids = batch.get("item_id")
        if ids is not None:
            ids = ids.reshape(-1)
            cols = ids if mesh is None else gather_rows(
                ids, mesh.data_group, mesh.data_index, mesh.n_data)
            own = torch.arange(cols.shape[0], device=logits.device)[None, :] == labels[:, None]
            dup = (ids[:, None] == cols[None, :]) & ~own
            logits = torch.where(dup, -1e9, logits)
    loss = F.cross_entropy(logits, labels)
    return loss, {"softmax_ce": loss}


def gsu_esu(outputs, batch, mesh=None, alpha=0.2, beta=0.8):
    """Two-stage long-sequence ranking loss: alpha·GSU + beta·ESU softmax CE
    over 2-class logits."""
    labels = batch["label"].reshape(-1).to(torch.long)
    gsu = F.cross_entropy(outputs["gsu_logits"].to(torch.float32), labels)
    esu = F.cross_entropy(outputs["esu_logits"].to(torch.float32), labels)
    loss = alpha * gsu + beta * esu
    return loss, {"gsu_ce": gsu, "esu_ce": esu}


def model_loss(outputs, batch, mesh=None):
    """The model computed its own total loss."""
    loss = torch.as_tensor(outputs["loss"]).to(torch.float32).reshape(())
    return loss, {"model_loss": loss}


LOSSES: Dict[str, LossFn] = {
    "bce": bce,
    "multi_task": multi_task,
    "in_batch_softmax": in_batch_softmax,
    "gsu_esu": gsu_esu,
    "model_loss": model_loss,
}


def get_loss(name: str) -> LossFn:
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(LOSSES)}")
    return LOSSES[name]


def add_auxiliary(loss: Tensor, outputs: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Fold model-side auxiliary losses ('auxiliary_loss', 'aux_loss',
    'orth_loss') into the total."""
    logs = {}
    for key in ("auxiliary_loss", "aux_loss", "orth_loss"):
        if key in outputs:
            aux = torch.as_tensor(outputs[key]).to(torch.float32).reshape(())
            loss = loss + aux
            logs[key] = aux
    return loss, logs
