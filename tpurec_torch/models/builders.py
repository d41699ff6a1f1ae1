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
from tpurec_torch.models import dmr as dmr_models
from tpurec_torch.models import fibinetpp as fpp_models
from tpurec_torch.models import fm as fm_models
from tpurec_torch.models import matrixcf as cf_models
from tpurec_torch.models import mind as mind_models
from tpurec_torch.models import multitask as mt_models
from tpurec_torch.models import poso as poso_models
from tpurec_torch.models import sim as sim_models
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


@register_model("matrixcf")
def _matrixcf(params: dict, info: DataInfo):
    # keeps ``embed_dim`` (``build_model`` sets it from config.embedding.dim)
    p = _with_dtype(params)
    p.setdefault("vocab_size", info.total_dims)
    return cf_models.MatrixCF(**p)


@register_model("ncf")
def _ncf(params: dict, info: DataInfo):
    # its widths are ``mf_dim``/``mlp_dim``: ``embed_dim`` is always dropped
    p = _with_dtype(params)
    p.pop("embed_dim", None)
    p.setdefault("vocab_size", info.total_dims)
    return cf_models.NCF(**p)


@register_model("fm")
def _fm(params: dict, info: DataInfo):
    return fm_models.FM(**_common(params, info))


@register_model("dssm_single")
def _dssm_single(params: dict, info: DataInfo):
    return fm_models.DSSMSingleRanking(**_common(params, info))


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


@register_model("wide_and_deep")
def _wide_and_deep(params: dict, info: DataInfo):
    return fm_models.WideAndDeep(**_with_continuous(params, info))


@register_model("ffm")
def _ffm(params: dict, info: DataInfo):
    return fm_models.FFM(**_common(params, info))


@register_model("fwfm")
def _fwfm(params: dict, info: DataInfo):
    return fm_models.FwFM(**_common(params, info))


@register_model("pnn")
def _pnn(params: dict, info: DataInfo):
    return fm_models.PNN(**_common(params, info))


@register_model("onn")
def _onn(params: dict, info: DataInfo):
    return fm_models.ONN(**_common(params, info))


@register_model("dcn")
def _dcn(params: dict, info: DataInfo):
    return dcn_models.DCN(**_with_continuous(params, info))


@register_model("xdeepfm")
def _xdeepfm(params: dict, info: DataInfo):
    return dcn_models.XDeepFM(**_with_continuous(params, info))


@register_model("nfm")
def _nfm(params: dict, info: DataInfo):
    return dcn_models.NFM(**_with_continuous(params, info))


@register_model("deep_crossing")
def _deep_crossing(params: dict, info: DataInfo):
    return dcn_models.DeepCrossing(**_with_continuous(params, info))


@register_model("fnn")
def _fnn(params: dict, info: DataInfo):
    return dcn_models.FNN(**_with_continuous(params, info))


@register_model("ccpm")
def _ccpm(params: dict, info: DataInfo):
    return dcn_models.CCPMModel(**_with_continuous(params, info))


@register_model("fgcnn")
def _fgcnn(params: dict, info: DataInfo):
    return dcn_models.FGCNNModel(**_with_continuous(params, info))


@register_model("afm")
def _afm(params: dict, info: DataInfo):
    return dcn_models.AFM(**_with_continuous(params, info))


@register_model("fibinet")
def _fibinet(params: dict, info: DataInfo):
    return dcn_models.FiBiNet(**_with_continuous(params, info))


@register_model("autoint")
def _autoint(params: dict, info: DataInfo):
    return dcn_models.AutoInt(**_with_continuous(params, info))


@register_model("mmoe")
def _mmoe(params: dict, info: DataInfo):
    return mt_models.MMOE(**_with_continuous(params, info))


@register_model("esmm")
def _esmm(params: dict, info: DataInfo):
    return mt_models.ESMM(**_with_continuous(params, info))


@register_model("ple")
def _ple(params: dict, info: DataInfo):
    return mt_models.PLE(**_with_continuous(params, info))


@register_model("esm2")
def _esm2(params: dict, info: DataInfo):
    return mt_models.ESM2(**_with_continuous(params, info))


@register_model("escm2")
def _escm2(params: dict, info: DataInfo):
    return mt_models.ESCM2(**_with_continuous(params, info))


@register_model("fdn")
def _fdn(params: dict, info: DataInfo):
    return mt_models.FDN(**_with_continuous(params, info))


@register_model("poso_mlp")
def _poso_mlp(params: dict, info: DataInfo):
    return poso_models.PosoMLPModel(**_common(params, info))


@register_model("poso_mha")
def _poso_mha(params: dict, info: DataInfo):
    return poso_models.PosoMHAModel(**_common(params, info))


@register_model("poso_mmoe")
def _poso_mmoe(params: dict, info: DataInfo):
    return poso_models.PosoMMOEModel(**_common(params, info))


@register_model("pepnet")
def _pepnet(params: dict, info: DataInfo):
    return poso_models.PEPNet(**_common(params, info))


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


@register_model("dien")
def _dien(params: dict, info: DataInfo):
    return din_models.DIEN(**_seq_params(params, info))


@register_model("dsin")
def _dsin(params: dict, info: DataInfo):
    # its position bias is sized by L, which flax reads off the first batch
    p = _seq_params(params, info)
    p.setdefault("max_seq_length", info.max_seq_length)
    return din_models.DSIN(**p)


def _retrieval_params(params: dict, info: DataInfo) -> dict:
    """The multi-interest models' common params, and each query feature's
    [offset, offset + dim) range in the shared id space for the sampled
    negatives (``tpurec/models/builders.py:218-241``)."""
    out = _with_dtype(params)
    out.setdefault("user_features", list(info.user_features))
    out.setdefault("sequence_features", list(info.sequence_names))
    if info.sequence_query_features:
        out.setdefault("query_features", list(info.sequence_query_features))
    out.setdefault("vocab_size", info.total_dims)
    out.setdefault("padding_index", info.padding_index)
    if "query_feature_ranges" not in out:
        span = dict(zip(info.feature_names, zip(info.feature_offsets, info.feature_dims)))
        ranges = []
        for q in out.get("query_features", ("item_id",)):
            if q in span:
                off, dim = span[q]
                ranges.append((int(off), int(off) + int(dim)))
            else:
                ranges.append((1, info.total_dims))
        out["query_feature_ranges"] = tuple(ranges)
    return out


@register_model("mind")
def _mind(params: dict, info: DataInfo):
    return mind_models.MIND(**_retrieval_params(params, info))


@register_model("sdm")
def _sdm(params: dict, info: DataInfo):
    return mind_models.SDM(**_retrieval_params(params, info))


@register_model("comirec")
def _comirec(params: dict, info: DataInfo):
    p = _retrieval_params(params, info)
    p.setdefault("max_seq_length", info.max_seq_length)
    return mind_models.ComiRec(**p)


@register_model("sine")
def _sine(params: dict, info: DataInfo):
    return mind_models.SINE(**_retrieval_params(params, info))


@register_model("fibinet_pp")
def _fibinet_pp(params: dict, info: DataInfo):
    return fpp_models.FiBiNetPlusPlus(**_with_continuous(params, info))


@register_model("masknet")
def _masknet(params: dict, info: DataInfo):
    return fpp_models.MaskNet(**_with_continuous(params, info))


@register_model("contextnet")
def _contextnet(params: dict, info: DataInfo):
    return fpp_models.ContextNet(**_with_continuous(params, info))


# ------------------------------------------------------ long-sequence ranking
@register_model("sim")
def _sim(params: dict, info: DataInfo):
    return sim_models.SIM(**_seq_params(params, info))


@register_model("can")
def _can(params: dict, info: DataInfo):
    return sim_models.CAN(**_seq_params(params, info))


@register_model("eta")
def _eta(params: dict, info: DataInfo):
    return sim_models.ETA(**_seq_params(params, info))


# ----------------------------------------------------------------- DMR family
@register_model("dmr")
def _dmr(params: dict, info: DataInfo):
    # its position table is sized by L, which flax reads off the first batch
    p = _seq_params(params, info)
    p.setdefault("max_seq_length", info.max_seq_length)
    return dmr_models.DMR(**p)


@register_model("dmt")
def _dmt(params: dict, info: DataInfo):
    p = _seq_params(params, info)
    p.setdefault("max_seq_length", info.max_seq_length)
    return dmr_models.DMT(**p)


@register_model("finalmlp")
def _finalmlp(params: dict, info: DataInfo):
    return dmr_models.FinalMLP(**_common(params, info))


@register_model("sdim")
def _sdim(params: dict, info: DataInfo):
    return dmr_models.SDIM(**_seq_params(params, info))
