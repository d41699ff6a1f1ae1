"""Builder functions wiring registry names to model classes (counterpart of
``tpurec/models/builders.py``, same defaults). Common params are filled from
``DataInfo`` so a config only overrides what differs. ``dtype`` may be a
``torch.dtype`` or its name (``"bfloat16"``), so it survives a JSON export
meta."""

from __future__ import annotations

import torch

from tpurec_torch.data.schema import DataInfo
from tpurec_torch.models import dcn as dcn_models
from tpurec_torch.models import din as din_models
from tpurec_torch.models import fm as fm_models
from tpurec_torch.models.registry import register_model


def _with_dtype(params: dict) -> dict:
    out = dict(params)
    dtype = out.get("dtype")
    if isinstance(dtype, str):
        resolved = getattr(torch, dtype, None)
        if not isinstance(resolved, torch.dtype):
            raise ValueError(f"unknown dtype {dtype!r}")
        out["dtype"] = resolved
    return out


def _common(params: dict, info: DataInfo) -> dict:
    out = _with_dtype(params)
    out.setdefault("feature_names", list(info.feature_names))
    out.setdefault("vocab_size", info.total_dims)
    return out


def _with_continuous(params: dict, info: DataInfo) -> dict:
    out = _common(params, info)
    out.setdefault("continuous_names", list(info.continuous_names))
    return out


@register_model("fm")
def _fm(params: dict, info: DataInfo):
    return fm_models.FM(**_common(params, info))


@register_model("dssm_double")
def _dssm_double(params: dict, info: DataInfo):
    p = _with_dtype(params)
    p.setdefault("user_features", list(info.user_features or info.feature_names[:2]))
    p.setdefault("item_features", list(info.item_features or info.feature_names[2:]))
    p.setdefault("vocab_size", info.total_dims)
    return fm_models.DSSMTwoTowerRetrieval(**p)


@register_model("deepfm")
def _deepfm(params: dict, info: DataInfo):
    return fm_models.DeepFM(**_common(params, info))


@register_model("dcn")
def _dcn(params: dict, info: DataInfo):
    return dcn_models.DCN(**_with_continuous(params, info))


@register_model("xdeepfm")
def _xdeepfm(params: dict, info: DataInfo):
    return dcn_models.XDeepFM(**_with_continuous(params, info))


@register_model("fibinet")
def _fibinet(params: dict, info: DataInfo):
    return dcn_models.FiBiNet(**_with_continuous(params, info))


def _seq_params(params: dict, info: DataInfo) -> dict:
    out = _with_dtype(params)
    out.setdefault("user_features", list(info.user_features))
    out.setdefault("item_features", list(info.item_features))
    out.setdefault("sequence_features", list(info.sequence_names))
    if info.sequence_query_features:
        out.setdefault("query_features", list(info.sequence_query_features))
    out.setdefault("vocab_size", info.total_dims)
    out.setdefault("padding_index", info.padding_index)
    return out


@register_model("din")
def _din(params: dict, info: DataInfo):
    return din_models.DIN(**_seq_params(params, info))
