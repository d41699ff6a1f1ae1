"""Composable losses (counterpart of ``tpurec/train/losses.py``).

Each is a named function ``loss_fn(outputs, batch) -> (loss, logs)``
selected by ``TrainConfig.loss``: plain BCE, the 0.5/0.5 CTR+CVR BCE,
in-batch sampled softmax, the 0.2·GSU + 0.8·ESU softmax CE, and a model's
own loss. Auxiliary losses a model returns are added by ``add_auxiliary``.
Losses are computed in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

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


def bce(outputs, batch):
    labels = batch["label"].reshape(-1).to(torch.float32)
    loss = _bce_from_outputs(outputs, labels)
    return loss, {"bce": loss}


def multi_task(outputs, batch, weights=(0.5, 0.5)):
    """CTR + CVR weighted BCE; for ESMM-style models the CVR label
    supervises the ctcvr output."""
    ctr_labels = batch["ctr"].reshape(-1).to(torch.float32)
    cvr_labels = batch["cvr"].reshape(-1).to(torch.float32)
    ctr_loss = _bce_from_outputs(outputs, ctr_labels, key="ctr_")
    cvr_key = "ctcvr_" if "ctcvr_output" in outputs else "cvr_"
    cvr_loss = _bce_from_outputs(outputs, cvr_labels, key=cvr_key)
    loss = weights[0] * ctr_loss + weights[1] * cvr_loss
    return loss, {"ctr_bce": ctr_loss, "cvr_bce": cvr_loss}


def in_batch_softmax(outputs, batch):
    """Sampled softmax over [positive ∥ in-batch negatives].

    With model 'logits' (B, 1+N) the positive is column 0; otherwise logits
    are built from the tower embeddings with in-batch negatives (diagonal
    positive), and off-diagonal entries whose 'item_id' equals row i's
    positive are masked out as accidental hits."""
    if "logits" in outputs:
        logits = outputs["logits"].to(torch.float32)
        labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    else:
        u = outputs["user_embedding"].to(torch.float32)
        v = outputs["item_embedding"].to(torch.float32)
        logits = u @ v.T
        b = logits.shape[0]
        labels = torch.arange(b, device=logits.device)
        ids = batch.get("item_id")
        if ids is not None:
            ids = ids.reshape(-1)
            eye = torch.eye(b, dtype=torch.bool, device=logits.device)
            dup = (ids[:, None] == ids[None, :]) & ~eye
            logits = torch.where(dup, -1e9, logits)
    loss = F.cross_entropy(logits, labels)
    return loss, {"softmax_ce": loss}


def gsu_esu(outputs, batch, alpha=0.2, beta=0.8):
    """Two-stage long-sequence ranking loss: alpha·GSU + beta·ESU softmax CE
    over 2-class logits."""
    labels = batch["label"].reshape(-1).to(torch.long)
    gsu = F.cross_entropy(outputs["gsu_logits"].to(torch.float32), labels)
    esu = F.cross_entropy(outputs["esu_logits"].to(torch.float32), labels)
    loss = alpha * gsu + beta * esu
    return loss, {"gsu_ce": gsu, "esu_ce": esu}


def model_loss(outputs, batch):
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
