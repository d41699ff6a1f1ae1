"""The system under test, built from a cell's files: the port's ``Trainer``
with its model and engine. The only module of the
harness that imports the port (``tpurec_torch``)."""

from __future__ import annotations

from typing import Any, Dict

ENGINES = {"auto": "auto", "dense": "adam"}


def data_info(cfg: Dict[str, Any]):
    from tpurec_torch.data.schema import DataInfo

    return DataInfo.from_dims(
        list(cfg["features"]),
        list(cfg["features"].values()),
        sequence_names=list(cfg.get("sequences", {})),
        sequence_query_features=list(cfg.get("query_features", [])),
        max_seq_length=int(cfg.get("max_seq_length", 0)),
        padding_index=int(cfg.get("padding_index", 0)),
        user_features=list(cfg.get("user_features", [])),
        item_features=list(cfg.get("item_features", [])),
    )


def model_config(cfg: Dict[str, Any]):
    from tpurec_torch.config import EmbeddingConfig, ModelConfig

    params = dict(cfg["params"], dtype=cfg["compute_dtype"])
    return ModelConfig(name=cfg["model"], params=params, embedding=EmbeddingConfig(dim=cfg["embed_dim"]))


def trainer(cfg: Dict[str, Any], mix: Dict[str, Any], device):
    """A ``Trainer`` of the configuration's model in the mix's engine."""
    from tpurec_torch.config import ExperimentConfig, OptimizerConfig, TrainConfig
    from tpurec_torch.train.trainer import Trainer

    opt = cfg["optimizer"]
    engine = mix["engine"]
    oc = OptimizerConfig(
        name=opt["name"], learning_rate=opt["learning_rate"], b1=opt["b1"], b2=opt["b2"],
        eps=opt["eps"], embedding_optimizer=ENGINES[engine],
    )
    tc = TrainConfig(
        batch_size=int(mix["batch"]), log_every_steps=0, compute_dtype=cfg["compute_dtype"],
        optimizer=oc,
    )
    return Trainer(ExperimentConfig(model=model_config(cfg), train=tc), data_info(cfg), device=device)

