"""Feature-space schema: the shared offset-encoded id space (counterpart of
``tpurec/data/schema.py``, same files and JSON layout).

- ``data_info.json``    = [feature_dims, feature_offsets, total_dims]
- ``schema.json``       = every ``DataInfo`` field
- ``feature_dict.json`` = {column: {raw_value: encoded_id}} (``FeatureEncoder``)
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class DataInfo:
    # categorical features in encoding order; dims[i] = cardinality of col i
    feature_names: List[str] = field(default_factory=list)
    feature_dims: List[int] = field(default_factory=list)
    feature_offsets: List[int] = field(default_factory=list)
    total_dims: int = 0
    continuous_names: List[str] = field(default_factory=list)
    sequence_names: List[str] = field(default_factory=list)  # (B, L) id features
    # candidate-side categorical feature aligned 1:1 with each sequence;
    # empty = ['item_id'] single series
    sequence_query_features: List[str] = field(default_factory=list)
    label_names: List[str] = field(default_factory=list)
    max_seq_length: int = 0
    padding_index: int = 0
    user_features: List[str] = field(default_factory=list)
    item_features: List[str] = field(default_factory=list)

    @staticmethod
    def from_dims(
        feature_names: Sequence[str], feature_dims: Sequence[int], **kw
    ) -> "DataInfo":
        dims = list(map(int, feature_dims))
        offsets = [0]
        for d in dims[:-1]:
            offsets.append(offsets[-1] + d)
        return DataInfo(
            feature_names=list(feature_names),
            feature_dims=dims,
            feature_offsets=offsets,
            total_dims=sum(dims),
            **kw,
        )

    def save(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "data_info.json"), "w") as f:
            json.dump([self.feature_dims, self.feature_offsets, self.total_dims], f)
        with open(os.path.join(output_dir, "schema.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @staticmethod
    def load(output_dir: str) -> "DataInfo":
        schema_path = os.path.join(output_dir, "schema.json")
        if os.path.exists(schema_path):
            with open(schema_path) as f:
                return DataInfo(**json.load(f))
        # the bare reference triple
        with open(os.path.join(output_dir, "data_info.json")) as f:
            dims, offsets, total = json.load(f)
        return DataInfo(
            feature_names=[f"f{i}" for i in range(len(dims))],
            feature_dims=list(dims),
            feature_offsets=list(offsets),
            total_dims=int(total),
        )

    def offset_of(self, name: str) -> int:
        return self.feature_offsets[self.feature_names.index(name)]

    def dim_of(self, name: str) -> int:
        return self.feature_dims[self.feature_names.index(name)]


class FeatureEncoder:
    """Label-encoder with the global offset scheme: ``fit`` gives each column
    ids in the sorted order of ``str(value)`` (so "10" sorts before "2"),
    then lays the columns out with cumulative offsets, which ``recorder``
    holds (the layout of ``feature_dict.json``)."""

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.recorder: Dict[str, Dict[str, int]] = {}
        self.info: Optional[DataInfo] = None

    def fit(self, values_per_column: Dict[str, Sequence]) -> DataInfo:
        dims = []
        self.recorder = {}
        for col in self.columns:
            uniques = sorted({str(v) for v in values_per_column[col]})
            dims.append(len(uniques))
            self.recorder[col] = {v: i for i, v in enumerate(uniques)}
        self.info = DataInfo.from_dims(self.columns, dims)
        # fold the offsets into the recorder (the global id space)
        for col, offset in zip(self.columns, self.info.feature_offsets):
            self.recorder[col] = {v: i + offset for v, i in self.recorder[col].items()}
        return self.info

    def encode(self, column: str, value) -> int:
        return self.recorder[column][str(value)]

    def save(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "feature_dict.json"), "w") as f:
            json.dump(self.recorder, f)

    @staticmethod
    def load(output_dir: str) -> "FeatureEncoder":
        with open(os.path.join(output_dir, "feature_dict.json")) as f:
            recorder = json.load(f)
        enc = FeatureEncoder(list(recorder))
        enc.recorder = recorder
        return enc
