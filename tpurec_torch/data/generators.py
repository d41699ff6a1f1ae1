"""Data generators: raw files → TFRecord shards + JSON metadata (counterpart
of ``tpurec/data/generators.py``: the same files, byte for byte, from the same
raw files).

Three families, mirroring the reference's pipelines (SURVEY §1-L1):

- ``TabularDataGenerator``   — ch.2 e-commerce logs (2.FM/DataGenerator.py):
  merge user/item/event tables, timestamp-percentile split, global
  offset label-encoding, profiles, TFRecords + feature_dict/data_info/
  user_profile/item_profile JSON.
- ``RankingTableGenerator``  — the ch.3 flat impression table (one headed CSV).
- ``ImpressionLogGenerator`` — ch.4 JSON impression logs with ctr/cvr labels
  ('0$#0' Label format, 4.MMOE/DataGenerator.py:22-116) and derived
  continuous features.
- ``SequenceDataGenerator``  — ch.5 behavior sequences written as
  fixed-length padded id lists (padded at write time so training batches
  have static shapes).

The JAX package reads the CSV tables with pandas; this module reads them with
``csv`` and numpy (the GPU machine has no pandas) and rebuilds what pandas
decides on the way to a string key (``_Table``): a column is int64 when every
present value is an integer, float64 when every one is a number (or an
integer column has a missing value), else strings; a left merge that leaves a
row unmatched makes the right table's int64 columns float64; ``str`` of an
int64 value is "3", of a float64 one "3.0" or "3.5".
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpurec_torch.data.recordio import write_columnar_shards
from tpurec_torch.data.schema import DataInfo, FeatureEncoder

# pandas.read_csv's default missing-value strings
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"\s*[+-]?\d+\s*\Z")


class _Column:
    """One typed column: ``kind`` 'int' (int64, never missing), 'float'
    (float64, NaN where missing) or 'str' (Python strings, None where
    missing); ``missing`` marks the missing rows."""

    def __init__(self, kind: str, values: np.ndarray, missing: np.ndarray):
        self.kind = kind
        self.values = values
        self.missing = missing

    @staticmethod
    def parse(tokens: Sequence[str]) -> "_Column":
        missing = np.fromiter((t in _NA_VALUES for t in tokens), bool, len(tokens))
        present = [t for t, m in zip(tokens, missing) if not m]
        if all(_INT.match(t) for t in present):
            ints = np.asarray([int(t) for t in present], np.int64)
            if not missing.any():
                return _Column("int", ints, missing)
            out = np.full(len(tokens), np.nan)
            out[~missing] = ints
            return _Column("float", out, missing)
        try:
            if any("_" in t for t in present):  # float() reads "1_0"; pandas does not
                raise ValueError
            floats = np.asarray([float(t) for t in present], np.float64)
        except ValueError:
            values = np.asarray([None if m else t for t, m in zip(tokens, missing)], object)
            return _Column("str", values, missing)
        out = np.full(len(tokens), np.nan)
        out[~missing] = floats
        return _Column("float", out, missing)

    def take(self, rows: np.ndarray) -> "_Column":
        """Rows ``rows`` of the column; -1 is a missing row (an int64 column
        then becomes float64, as pandas' left merge makes it)."""
        hole = rows < 0
        if not hole.any():
            return _Column(self.kind, self.values[rows], self.missing[rows])
        missing = self.missing[np.where(hole, 0, rows)] | hole
        if self.kind == "str":
            out = self.values[np.where(hole, 0, rows)].copy()
            out[hole] = None
            return _Column("str", out, missing)
        out = self.values[np.where(hole, 0, rows)].astype(np.float64)
        out[hole] = np.nan
        return _Column("float", out, missing)

    def strings(self) -> List[str]:
        """``str`` of each value, as ``Series.tolist()`` then ``str`` gives it;
        a missing value is "nan"."""
        if self.kind == "int":
            return self.values.astype(str).tolist()
        if self.kind == "float":
            return [str(v) for v in self.values.tolist()]
        return ["nan" if v is None else v for v in self.values.tolist()]

    def row_strings(self, table_kind: str) -> List[str]:
        """``str`` of each value as it comes out of ``DataFrame.values``: a
        table of numbers only and at least one float column gives floats."""
        if table_kind == "float" and self.kind == "int":
            return [str(float(v)) for v in self.values.tolist()]
        return self.strings()


class _Table:
    """A CSV table of typed columns in file order (what ``pd.read_csv`` reads
    for the generators below)."""

    def __init__(self, columns: Dict[str, _Column]):
        self.columns = columns

    @staticmethod
    def read(path: str, names: Optional[Sequence[str]] = None) -> "_Table":
        """Headerless with ``names``, else the first row names the columns.
        Blank lines are skipped and short rows padded with missing values."""
        with open(path, newline="") as f:
            rows = [r for r in csv.reader(f) if r]
        if names is None:
            names, rows = rows[0], rows[1:]
        width = len(names)
        for r in rows:
            if len(r) > width:
                raise ValueError(f"{path}: a row has {len(r)} fields, the table {width}")
        cols = [[r[j] if j < len(r) else "" for r in rows] for j in range(width)]
        return _Table({n: _Column.parse(c) for n, c in zip(names, cols)})

    def __getitem__(self, name: str) -> _Column:
        return self.columns[name]

    def take(self, rows: np.ndarray) -> "_Table":
        return _Table({n: c.take(rows) for n, c in self.columns.items()})

    def kind(self) -> str:
        """The dtype ``DataFrame.values`` gives the table: 'str' (object) if a
        column holds strings, else 'float' if one is float64, else 'int'."""
        kinds = {c.kind for c in self.columns.values()}
        return "str" if "str" in kinds else ("float" if "float" in kinds else "int")

    def left_merge(self, right: "_Table", on: str) -> "_Table":
        """``self.merge(right, on=on, how="left")``: the rows in this table's
        order, each repeated for every match in ``right`` (in its order), or
        kept once with missing values where there is none."""
        index: Dict[object, List[int]] = {}
        for j, key in enumerate(right[on].values.tolist()):
            index.setdefault(key, []).append(j)
        left_rows: List[int] = []
        right_rows: List[int] = []
        for i, key in enumerate(self[on].values.tolist()):
            matches = index.get(key, (-1,))
            left_rows += [i] * len(matches)
            right_rows += matches
        lr, rr = np.asarray(left_rows, np.int64), np.asarray(right_rows, np.int64)
        merged = dict(self.take(lr).columns)
        for n, c in right.columns.items():
            if n != on:
                merged[n] = c.take(rr)
        return _Table(merged)

    def dropna(self) -> "_Table":
        keep = ~np.any([c.missing for c in self.columns.values()], axis=0)
        return self.take(np.flatnonzero(keep))


def _clean_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)
    for f in os.listdir(path):
        fp = os.path.join(path, f)
        if os.path.isfile(fp):
            os.remove(fp)


def _encode(encoder: FeatureEncoder, column: str, strings: Sequence[str]) -> np.ndarray:
    recorder = encoder.recorder[column]
    return np.fromiter((recorder[s] for s in strings), np.int64, len(strings))


class TabularDataGenerator:
    """Reference 2.FM pipeline (2.FM/DataGenerator.py:33-149)."""

    def __init__(
        self,
        output_path: str,
        item_path: str,
        user_path: str,
        main_path: str,
        encode_columns: Sequence[str] = (
            "user_tag1",
            "user_tag2",
            "item_tag1",
            "item_tag2",
            "item_tag3",
        ),
        user_feature_num: int = 2,
        split_percentile: float = 80.0,
        records_per_file: int = 200_000,
    ):
        self.output_path = output_path
        self.item_path = item_path
        self.user_path = user_path
        self.main_path = main_path
        self.encode_columns = list(encode_columns)
        self.user_features = self.encode_columns[:user_feature_num]
        self.item_features = self.encode_columns[user_feature_num:]
        self.split_percentile = split_percentile
        self.records_per_file = records_per_file
        self.encoder = FeatureEncoder(self.encode_columns)
        self.info: Optional[DataInfo] = None

    def read_and_merge(self) -> Tuple[_Table, np.ndarray]:
        """The merged, complete events and each one's is-test flag."""
        df_item = _Table.read(self.item_path, ["item_id", "item_tag1", "item_tag2", "item_tag3"])
        df_user = _Table.read(self.user_path, ["user_id", "user_tag1", "user_tag2"])
        df_main = _Table.read(self.main_path, ["timestamp", "user_id", "item_id", "label"])
        df = df_main.left_merge(df_user, "user_id").left_merge(df_item, "item_id")
        df = df.dropna()  # reference keeps only complete records (:69)
        timestamps = df["timestamp"].values
        threshold = np.percentile(timestamps, self.split_percentile)
        self.df_user, self.df_item = df_user, df_item
        return df, timestamps >= threshold

    def run_all(self) -> DataInfo:
        _clean_dir(self.output_path)
        df, is_test = self.read_and_merge()
        strings = {c: df[c].strings() for c in self.encode_columns}
        self.info = self.encoder.fit(strings)
        self.info.label_names = ["label"]
        self.info.user_features = list(self.user_features)
        self.info.item_features = list(self.item_features)
        encoded = {c: _encode(self.encoder, c, strings[c]) for c in self.encode_columns}
        encoded["label"] = df["label"].values.astype(np.float32)
        for kind, sel in (("train", ~is_test), ("test", is_test)):
            write_columnar_shards(
                self.output_path,
                kind,
                {c: v[sel] for c, v in encoded.items()},
                self.records_per_file,
            )
        self._dump_profiles()
        self.info.save(self.output_path)
        self.encoder.save(self.output_path)
        return self.info

    def _profile(self, table: _Table, features: Sequence[str]) -> Dict[str, List[int]]:
        """{entity id: encoded feature ids} in file order, for the rows whose
        every feature value is in the encoder (a later row of the same id
        replaces an earlier one)."""
        kind = table.kind()
        names = list(table.columns)
        cols = [table[n].row_strings(kind) for n in names]
        feats = [cols[names.index(c)] for c in features]
        recs = [self.encoder.recorder[c] for c in features]
        profile = {}
        for row, key in enumerate(cols[0]):
            values = [f[row] for f in feats]
            if all(v in rec for v, rec in zip(values, recs)):
                profile[key] = [rec[v] for v, rec in zip(values, recs)]
        return profile

    def _dump_profiles(self) -> None:
        user_profile = self._profile(self.df_user, self.user_features)
        item_profile = self._profile(self.df_item, self.item_features)
        with open(os.path.join(self.output_path, "user_profile.json"), "w") as f:
            json.dump(user_profile, f)
        with open(os.path.join(self.output_path, "item_profile.json"), "w") as f:
            json.dump(item_profile, f)


class RankingTableGenerator:
    """Flat impression-table pipeline — the 3.DCN data family.

    One CSV with a header row: a timestamp column, any number of categorical
    columns (here uid/iid/utag1-4/itag1-4 — the reference's chapter-3 layout,
    3.DCN/ModelManager.py:14-15), any number of ``*_origin`` continuous
    columns (expanded to origin/square/cube triples exactly like the
    reference derives them, 4.MMOE/DataGenerator.py:114-116), and a binary
    label column. Categoricals are offset label-encoded into the shared id
    space (a missing value as "nan"); the timestamp percentile splits
    train/test like the ch.2 pipeline.

    ``cross_columns`` synthesizes explicit crossed categorical features
    (Wide&Deep-style crossed_column): for each (a, b) pair a new column
    ``a_x_b`` holds the joint value "va|vb", label-encoded into the shared id
    space like any other categorical.
    """

    def __init__(
        self,
        output_path: str,
        main_path: str,
        label_name: str = "ctr",
        timestamp_column: str = "timestamp",
        split_percentile: float = 80.0,
        records_per_file: int = 200_000,
        cross_columns: Sequence[Tuple[str, str]] = (),
    ):
        self.output_path = output_path
        self.main_path = main_path
        self.label_name = label_name
        self.timestamp_column = timestamp_column
        self.split_percentile = split_percentile
        self.records_per_file = records_per_file
        self.cross_columns = list(cross_columns)
        self.encoder: Optional[FeatureEncoder] = None
        self.info: Optional[DataInfo] = None

    def run_all(self) -> DataInfo:
        _clean_dir(self.output_path)
        df = _Table.read(self.main_path)
        strings = {c: df[c].strings() for c in df.columns}
        for a, b in self.cross_columns:
            name = f"{a}_x_{b}"
            strings[name] = [f"{x}|{y}" for x, y in zip(strings[a], strings[b])]
        special = {self.timestamp_column, self.label_name}
        origin_cols = [c for c in df.columns if c.endswith("_origin")]
        cat_cols = [c for c in strings if c not in special and c not in origin_cols]
        self.encoder = FeatureEncoder(cat_cols)
        self.info = self.encoder.fit({c: strings[c] for c in cat_cols})
        encoded = {c: _encode(self.encoder, c, strings[c]) for c in cat_cols}
        cont_names: List[str] = []
        for c in origin_cols:
            stem = c[: -len("_origin")]
            v = df[c].values.astype(np.float32)
            encoded[c] = v
            encoded[f"{stem}_square"] = v * v
            encoded[f"{stem}_cube"] = v * v * v
            cont_names += [c, f"{stem}_square", f"{stem}_cube"]
        self.info.continuous_names = cont_names
        self.info.label_names = ["label"]
        crossed = {f"{a}_x_{b}" for a, b in self.cross_columns}
        self.info.user_features = [
            c for c in cat_cols if c.startswith("u") and c not in crossed
        ]
        self.info.item_features = [
            c for c in cat_cols if c.startswith("i") and c not in crossed
        ]
        encoded["label"] = df[self.label_name].values.astype(np.float32)
        timestamps = df[self.timestamp_column].values
        threshold = np.percentile(timestamps, self.split_percentile)
        is_test = timestamps >= threshold
        for kind, sel in (("train", ~is_test), ("test", is_test)):
            write_columnar_shards(
                self.output_path, kind,
                {c: v[sel] for c, v in encoded.items()}, self.records_per_file,
            )
        self.info.save(self.output_path)
        self.encoder.save(self.output_path)
        return self.info


class ImpressionLogGenerator:
    """Reference 4.MMOE pipeline: JSON-lines with nested features and a
    '0$#0' ctr/cvr label; derived square/cube continuous features
    (4.MMOE/DataGenerator.py:22-116)."""

    def __init__(
        self,
        output_path: str,
        log_path: str,
        split_fraction: float = 0.8,
        records_per_file: int = 200_000,
        seed: int = 0,
    ):
        self.output_path = output_path
        self.log_path = log_path
        self.split_fraction = split_fraction
        self.records_per_file = records_per_file
        self.seed = seed
        self.info: Optional[DataInfo] = None

    def run_all(self) -> DataInfo:
        _clean_dir(self.output_path)
        records = [json.loads(line) for line in open(self.log_path)]
        cat_names = sorted(records[0]["features"])
        cont_names = sorted(records[0].get("continuous", {}))
        encoder = FeatureEncoder(cat_names)
        self.info = encoder.fit(
            {c: [r["features"][c] for r in records] for c in cat_names}
        )
        derived = []
        for c in cont_names:
            derived += [c, f"{c}_sq", f"{c}_cube"]  # reference :114-116
        self.info.continuous_names = derived
        self.info.label_names = ["ctr", "cvr"]
        rng = np.random.default_rng(self.seed)
        n = len(records)
        cols: Dict[str, np.ndarray] = {
            c: np.asarray(
                [encoder.encode(c, r["features"][c]) for r in records], np.int64
            )
            for c in cat_names
        }
        for c in cont_names:
            v = np.asarray([float(r["continuous"][c]) for r in records], np.float32)
            cols[c] = v
            cols[f"{c}_sq"] = v * v
            cols[f"{c}_cube"] = v * v * v
        labels = [r["Label"].split("$#") for r in records]
        if len(labels[0]) == 6:
            # full conversion chain click$#cart$#collect$#none$#order$#pay
            # (the graph ESM2 trains on, 9.ESCM2/CustomLayers.py:559-601);
            # ctr/cvr alias the endpoints for two-task trainers
            chain_names = ["click", "cart", "collect", "none", "order", "pay"]
            for j, nm in enumerate(chain_names):
                cols[nm] = np.asarray([float(p[j]) for p in labels], np.float32)
            cols["ctr"] = cols["click"]
            cols["cvr"] = cols["pay"]
            self.info.label_names = chain_names + ["ctr", "cvr"]
        else:
            cols["ctr"] = np.asarray([float(p[0]) for p in labels], np.float32)
            cols["cvr"] = np.asarray([float(p[1]) for p in labels], np.float32)
        is_train = rng.random(n) < self.split_fraction
        for kind, sel in (("train", is_train), ("test", ~is_train)):
            write_columnar_shards(
                self.output_path, kind,
                {c: v[sel] for c, v in cols.items()}, self.records_per_file,
            )
        self.info.save(self.output_path)
        encoder.save(self.output_path)
        return self.info


class SequenceDataGenerator:
    """Reference 5.DIN pipeline: events with candidate item + click history.

    Ids are offset-encoded into one id space (item ids, user tags, item tags
    as separate blocks); histories are padded to ``max_seq_length`` with
    padding id 0 — id 0 is reserved, so every real feature block starts at 1
    (the reference reserves a padding_index the same way,
    5.DIN/ModelManager.py:58-67).
    """

    #: default parallel-series layout: each series column encodes through the
    #: feature block of its aligned candidate feature (reference pairs
    #: behavior_series_features 1:1 with item_categorical_features,
    #: 6.MIND/CustomLayers.py:162-172)
    DEFAULT_SEQUENCE_SPECS = {"history": "item_id", "history_tags": "item_tag"}

    def __init__(
        self,
        output_path: str,
        events_path: str,
        max_seq_length: int = 30,
        split_fraction: float = 0.8,
        records_per_file: int = 200_000,
        context_features: Sequence[str] = (),
        sequence_specs: Optional[Dict[str, str]] = None,
        emit_negative_series: bool = True,
        seed: int = 0,
    ):
        self.output_path = output_path
        self.events_path = events_path
        self.max_seq_length = max_seq_length
        self.split_fraction = split_fraction
        self.records_per_file = records_per_file
        # extra per-event categorical context columns (e.g. display 'position'
        # / 'page' for the DMT de-biasing towers, 8.DMR/CustomLayers.py:570-574)
        # encoded as their own blocks of the shared id space
        self.context_features = list(context_features)
        # {series column: feature block} — series present in the log but not
        # named here are ignored; None = DEFAULT_SEQUENCE_SPECS filtered to
        # the columns actually present
        self.sequence_specs = sequence_specs
        self.seed = seed
        self.info: Optional[DataInfo] = None
        # emit a sampled ``neg_<series>`` column per behavior series for the
        # DIEN auxiliary loss (reference neg_hist_seq, 5.DIN/DataGenerator.py)
        self.emit_negative_series = emit_negative_series

    def run_all(self) -> DataInfo:
        _clean_dir(self.output_path)
        records = [json.loads(line) for line in open(self.events_path)]
        specs = self.sequence_specs
        if specs is None:
            specs = {
                s: f for s, f in self.DEFAULT_SEQUENCE_SPECS.items() if s in records[0]
            }
        # block layout: [pad=0 | item ids | user tags | item tags | context...]
        # each feature block's vocabulary covers both the candidate column and
        # every history series encoded through it
        def block_values(feature: str) -> set:
            vals = {r[feature] for r in records}
            for series, feat in specs.items():
                if feat == feature:
                    vals |= {h for r in records for h in r[series]}
            return vals

        items = sorted(block_values("item_id"))
        user_tags = sorted({r["user_tag"] for r in records})
        item_tags = sorted(block_values("item_tag"))
        item_map = {v: i + 1 for i, v in enumerate(items)}
        ut_off = 1 + len(items)
        ut_map = {v: i + ut_off for i, v in enumerate(user_tags)}
        it_off = ut_off + len(user_tags)
        it_map = {v: i + it_off for i, v in enumerate(item_tags)}
        total = it_off + len(item_tags)
        names = ["item_id", "user_tag", "item_tag"]
        dims = [len(items), len(user_tags), len(item_tags)]
        offsets = [1, ut_off, it_off]
        maps = {"item_id": item_map, "user_tag": ut_map, "item_tag": it_map}
        for c in self.context_features:
            vals = sorted({r[c] for r in records})
            maps[c] = {v: i + total for i, v in enumerate(vals)}
            names.append(c)
            dims.append(len(vals))
            offsets.append(total)
            total += len(vals)
        # chained second label (click → conversion) when present in the log
        has_conv = "conversion" in records[0]
        self.info = DataInfo(
            feature_names=names,
            feature_dims=dims,
            feature_offsets=offsets,
            total_dims=total,
            sequence_names=list(specs),
            sequence_query_features=[specs[s] for s in specs],
            label_names=["ctr", "cvr"] if has_conv else ["label"],
            max_seq_length=self.max_seq_length,
            padding_index=0,
            user_features=["user_tag"],
            item_features=["item_id", "item_tag"],
        )
        rng = np.random.default_rng(self.seed)
        L = self.max_seq_length
        n = len(records)
        cols = {
            name: np.asarray([maps[name][r[name]] for r in records], np.int64)
            for name in names
        }
        neg_rng = np.random.default_rng(self.seed + 1)
        for series, feat in specs.items():
            fmap = maps[feat]
            hist = np.zeros((n, L), np.int64)
            for i, r in enumerate(records):
                h = [fmap[x] for x in r[series][-L:]]
                hist[i, : len(h)] = h
            cols[series] = hist
            if self.emit_negative_series:
                # pipeline-sampled negative behaviors for the DIEN auxiliary
                # loss (the reference prepares neg_hist_seq data-side from a
                # negative-sample dict, 5.DIN/DataGenerator.py): uniform ids
                # from the same feature block, never equal to the positive,
                # zero at padding positions
                j = names.index(feat)
                off, dim = offsets[j], dims[j]
                neg = neg_rng.integers(off, off + dim, size=hist.shape)
                neg = np.where(neg == hist, off + (neg - off + 1) % dim, neg)
                cols[f"neg_{series}"] = np.where(hist != 0, neg, 0)
        cols["label"] = np.asarray([float(r["label"]) for r in records], np.float32)
        if has_conv:
            cols["ctr"] = cols["label"]
            cols["cvr"] = np.asarray(
                [float(r["conversion"]) for r in records], np.float32
            )
        is_train = rng.random(n) < self.split_fraction
        for kind, sel in (("train", is_train), ("test", ~is_train)):
            write_columnar_shards(
                self.output_path, kind,
                {c: v[sel] for c, v in cols.items()}, self.records_per_file,
            )
        self.info.save(self.output_path)
        with open(os.path.join(self.output_path, "feature_dict.json"), "w") as f:
            json.dump(maps, f)
        return self.info
