"""Typed configuration (counterpart of ``tpurec/config.py``).

Every dataclass of the JAX module, with every field and default, so a JSON
config or an export meta written by either package loads here. Fields that
select what the port does not have (the TPU gather and sort strategies)
are carried and read as the port's one choice.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence

_NESTED: dict = {}


def _coerce(cls, value):
    """Recursively build a dataclass from a mapping (for JSON/dict configs)."""
    if value is None or not dataclasses.is_dataclass(cls):
        return value
    if isinstance(value, cls):
        return value
    if not isinstance(value, Mapping):
        raise TypeError(f"cannot build {cls.__name__} from {type(value).__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in value.items():
        if key not in fields:
            raise KeyError(f"unknown field {key!r} for {cls.__name__}")
        target = _NESTED.get((cls, key))
        if target is not None:
            val = _coerce(target, val)
        elif isinstance(val, list):
            val = tuple(val)  # JSON arrays ↔ tuple fields
        kwargs[key] = val
    return cls(**kwargs)


class _Base:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]):
        return _coerce(cls, data)

    @classmethod
    def from_json(cls, text: str):
        return cls.from_dict(json.loads(text))


@dataclass(frozen=True)
class MeshConfig(_Base):
    """Device-mesh layout: ('data', 'model') axes over the ranks of a
    ``torch.distributed`` world (``tpurec_torch.core.mesh.make_mesh``)."""

    data: int = -1  # -1: fill with remaining devices
    model: int = 1
    axis_data: str = "data"
    axis_model: str = "model"


@dataclass(frozen=True)
class EmbeddingConfig(_Base):
    """Shared offset-encoded embedding id-space. ``dim`` is injected into the
    model params as ``embed_dim``; ``used_id_l2`` is the coefficient of the
    used-id L2 term the trainer adds to the loss. The other fields are
    carried so that configs and export metas round-trip."""

    vocab_size: int = 0
    dim: int = 8
    sharding: str = "row"
    dtype: str = "float32"
    init_scale: float = 0.05
    used_id_l2: float = 0.0
    dense_packed_gather: Optional[bool] = None


@dataclass(frozen=True)
class OptimizerConfig(_Base):
    """The optimizer chain of ``Trainer._make_optimizer``: global-norm clip,
    coupled embedding L2, adam | adamw | sgd, an optional cosine schedule."""

    name: str = "adam"
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7  # keras Adam default epsilon (torch's default is 1e-8)
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0  # 0 = off
    # '' = constant; 'cosine' decays to learning_rate*schedule_alpha over
    # schedule_steps optimizer steps
    lr_schedule: str = ""
    schedule_steps: int = 0
    schedule_alpha: float = 0.0
    # coupled L2 on 'embedding*' tables: grad += embedding_l2 * w
    embedding_l2: float = 0.0
    # separate coupled L2 for order-1 ('w') tables; < 0 = use embedding_l2
    embedding_l2_order1: float = -1.0
    # per-feature coefficient on that feature's rows of second-order tables
    embedding_l2_overrides: Mapping[str, float] = field(default_factory=dict)
    # sparse-engine table optimizer: 'adam' | 'rowwise_adagrad' |
    # 'rowwise_adam' | 'fused_adam' | 'host_adam' | 'auto' ('auto' resolves
    # to the dense engine); read only when TrainConfig.sparse_embedding
    embedding_optimizer: str = "adam"
    # the fused engine's gradient build: 'permute' | 'sort_payload' |
    # 'xla_packed' (equal numbers; see Trainer._fused_step)
    fused_backward: str = "permute"
    # TPU gather and sort strategies of the fused engine, accepted for
    # configs of either package; the port has one of each
    fused_forward: str = "packed"
    fused_sort: str = "auto"


@dataclass(frozen=True)
class EarlyStopConfig(_Base):
    """EarlyStopper 'best'/'better' criteria."""

    num_trials: int = 3
    criterion: str = "best"  # 'best' | 'better'
    mode: str = "max"


@dataclass(frozen=True)
class TrainConfig(_Base):
    batch_size: int = 512
    epochs: int = 10
    eval_every_steps: int = 0  # 0 = eval at epoch end only
    log_every_steps: int = 100
    shuffle_buffer: int = 100_000
    seed: int = 0
    # 'bce' | 'multi_task' | 'in_batch_softmax' | 'gsu_esu' | 'model_loss'
    loss: str = "bce"
    loss_weights: Sequence[float] = (1.0,)
    # override the default metric set for the loss
    metrics: Sequence[str] = ()
    # dense compute dtype; parameters and optimizer state stay fp32
    compute_dtype: str = "bfloat16"
    # the sparse embedding engines (lazy-sparse, or fused with
    # embedding_optimizer='fused_adam'); False = dense whatever
    # embedding_optimizer says
    sparse_embedding: bool = False
    # slash-joined param-path prefixes that receive no update
    freeze_prefixes: Sequence[str] = ()
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    early_stop: EarlyStopConfig = field(default_factory=EarlyStopConfig)
    checkpoint_dir: str = ""
    max_to_keep: int = 3
    tensorboard_dir: str = ""
    # a torch.profiler trace of steps [profile_start_step,
    # profile_start_step + profile_num_steps) of the first epoch
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_num_steps: int = 5


@dataclass(frozen=True)
class DataConfig(_Base):
    path: str = ""
    train_pattern: str = "train_*.tfrecord"
    test_pattern: str = "test_*.tfrecord"
    meta_file: str = "data_info.json"
    max_seq_length: int = 0  # >0: padded behavior sequences
    padding_index: int = 0


@dataclass(frozen=True)
class ModelConfig(_Base):
    """One model instance = registry name + params dict + embedding config."""

    name: str = "fm"
    params: Mapping[str, Any] = field(default_factory=dict)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)


@dataclass(frozen=True)
class ExperimentConfig(_Base):
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


_NESTED[(TrainConfig, "optimizer")] = OptimizerConfig
_NESTED[(TrainConfig, "early_stop")] = EarlyStopConfig
_NESTED[(ModelConfig, "embedding")] = EmbeddingConfig
for _name, _cls in (("model", ModelConfig), ("train", TrainConfig), ("data", DataConfig),
                    ("mesh", MeshConfig)):
    _NESTED[(ExperimentConfig, _name)] = _cls
