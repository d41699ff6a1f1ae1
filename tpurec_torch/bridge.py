"""Weights from the JAX package into the port.

``params_from_jax(module, variables)`` takes the JAX counterpart's variables
as a nested mapping of numpy arrays (``{'params': ..., 'batch_stats': ...}``,
boxes removed) and loads them in place into the port ``module`` (a registry
model, an MLP, an attention block). The port keeps flax's module names, so a
flax path maps to a torch key by joining with dots, with these renames:

- a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
  a ``kernel`` leaf is a Dense kernel when the port module at its path is
  not one that owns a raw ``kernel`` parameter (PNN's ``OuterProductTower``,
  whose (P, D, D), (P, D) or (P,) kernel keeps its name and shape; a
  (P, D) kernel with P == D would load transposed without an error if
  the shape decided; the ``Conv`` of CCPM and FGCNN, whose
  (width, 1, C_in, C_out) kernel keeps flax's layout);
- ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``;
- tables and the raw parameters keep their names and shapes: the DIN
  attention's ``w1``, ``b1``, ``w2``, ``alpha``; the DCN cross's ``w_{i}``
  (D, 1) and ``b_{i}``; CIN's ``compress_{i}``; the bilinear ``w``; and
  SENet-bilinear's ``squeeze_kernel``/``excite_kernel`` (used as
  ``z @ kernel``, so not transposed) and ``squeeze_bias``/``excite_bias``;
  the capsule routing's ``S`` (D, E) and ``W`` (K, L, D, E); SINE's
  ``interest_pool``; the retrieval models' ``logit_scale``; FwFM's
  ``pair_weight`` (P,); the ``(V, F, D)`` field-aware tables; the
  ``scale`` (and ``bias``) of the port's ``BatchNorm`` and ``LayerNorm``,
  which keep flax's names; AutoInt's ``cont_emb`` (C, D); the expert
  banks' ``w_{i}`` (E, in, out) and ``b_{i}``; DSIN's ``bias_sess``,
  ``bias_pos`` and ``bias_dim``; the learned position table's ``pos``;
  FiBiNET++'s ``bilinear_w`` (D, D), ContextNet's ``ctx_proj`` (F, A, D)
  and ``ffn_w_{i}`` (F, D, D), FinalMLP's bilinear ``w12`` (h, d1, d2)
  (all used as ``x @ w``, so not transposed);
  and FDN's auxiliary heads
  ``L{level}_{task}_aux_w`` (E, H) and ``_aux_b`` (E,), which keep their
  names only where the port module at their path owns a parameter so
  named (as a raw ``kernel``).
  Only a leaf named exactly ``kernel`` can be a Dense kernel.
- the recurrent cells' per-gate layers are Dense layers under the cell's
  path (``cell/ir``, ``layer_0/hf``...) and load by the Dense rule: flax's
  ``GRUCell`` has a bias on ``ir``, ``iz``, ``in`` and ``hn`` and none on
  ``hr`` and ``hz``; ``OptimizedLSTMCell`` has none on ``ii``…``io`` and
  one on ``hi``…``ho``.

- the ``constants`` collection (ETA's ``hash_proj`` and ``lsh_self_proj``,
  SDIM's ``hash_projections``: fixed random projections that flax keeps
  beside the params) loads into the port's persistent buffers of the same
  names, exactly.

A leaf is read as fp32 (exact for a bf16 one) and copied into the port's
parameter in that parameter's dtype, so a table held in bf16
(``param_dtype``) loads flax's bits and stays bf16.

It raises ``KeyError`` on a collection other than these or a leaf name it
does not know, and the strict ``load_state_dict`` raises
``RuntimeError`` on any key of either side left unmatched and on any shape
that differs.

Into a model placed on a mesh (``models.registry.place_on_mesh``) a table
loads this rank's rows of the JAX package's whole table
(``EmbeddingTable.fit``), and a tensor-parallel weight its share over
'model' of the whole weight (``models.registry.sharded_weights``).

``opt_state_from_jax(optimizer, module, opt_state)`` carries an optax Adam
state (the ``ScaleByAdamState`` found anywhere in the chain's state:
``count``, ``mu``, ``nu``) into the port's ``ChainOptimizer`` over the same
module, so a test can continue a JAX run step for step.

A JAX sparse-mode state keeps its tables in ``state.tables`` (outside the
params) and their optimizer state in ``state.table_opt``. ``params_from_jax``
takes the tables as a third collection, ``'tables'``, into the modules'
``embedding`` parameters; ``table_opt_from_jax(table_opt, jax_table_opt,
host_store, jax_host_store)`` copies ``SparseAdamState`` m/v,
``SparseRowAdamState`` (bf16 m, (V,) v), ``SparseAdagradState`` acc, or the
moments a JAX ``HostAdamStore`` holds for a ``HostAdamState`` slot, into the
port's ``TrainState.table_opt`` (and ``TrainState.host_store``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_KEEP = {
    "bias", "w1", "b1", "w2", "alpha", "logit_scale", "logit_bias", "w",
    "squeeze_kernel", "squeeze_bias", "excite_kernel", "excite_bias",
    "S", "W", "interest_pool", "pair_weight", "scale", "cont_emb",
    "bias_sess", "bias_pos", "bias_dim", "pos", "bilinear_w", "ctx_proj", "w12",
}
_INDEXED_KEEP = re.compile(r"(w|b|compress|ffn_w)_\d+")
# FDN's per-expert auxiliary heads, raw parameters at the model's root
_AUX_HEAD = re.compile(r"L\d+_.+_aux_[wb]")
_STAT_RENAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def _owns_raw(module: nn.Module, path: Tuple[str, ...]) -> bool:
    """Whether the port module at ``path[:-1]`` under ``module`` has a
    parameter named ``path[-1]`` itself (a Dense has ``weight``, not
    ``kernel``)."""
    try:
        owner = module.get_submodule(".".join(path[:-1]))
    except AttributeError:
        return False  # no such module: the strict load reports the key
    return path[-1] in dict(owner.named_parameters(recurse=False))


def _torch_leaf(collection: str, path: Tuple[str, ...], value,
                module: nn.Module) -> Tuple[str, np.ndarray]:
    """The port's name and array for the flax leaf at ``path`` of a tree
    over ``module`` (the port module the tree loads into), which tells a raw
    ``kernel`` from a Dense one."""
    leaf = path[-1]
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if collection == "batch_stats":
        if leaf not in _STAT_RENAMES:
            raise KeyError(f"unmatched batch_stats leaf {'/'.join(path)}")
        return _STAT_RENAMES[leaf], arr
    if (leaf == "kernel" or _AUX_HEAD.fullmatch(leaf)) and _owns_raw(module, path):
        return leaf, arr
    if leaf == "kernel":
        if arr.ndim != 2:
            raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense kernel, got {arr.shape}")
        return "weight", arr.T
    if leaf in _PARAM_KEEP or _INDEXED_KEEP.fullmatch(leaf) or leaf.startswith("embedding"):
        return leaf, arr
    raise KeyError(f"unmatched param leaf {'/'.join(path)}")


def params_from_jax(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load the flax ``variables`` into ``module`` (strict; copied to the
    module's device) and return it."""
    extra = set(variables) - {"params", "batch_stats", "tables", "constants"}
    if extra:
        raise KeyError(f"unmatched collections {sorted(extra)}")
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "tables", "batch_stats", "constants"):
        for path, value in _flatten(variables.get(collection) or {}):
            if collection == "constants":
                name, arr = path[-1], np.array(value, dtype=np.float32)
            else:
                name, arr = _torch_leaf("batch_stats" if collection == "batch_stats" else "params",
                                        path, value, module)
            state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    from tpurec_torch.core.collectives import local_share
    from tpurec_torch.embedding.modules import EmbeddingTable
    from tpurec_torch.models.registry import sharded_weights

    for name, m in module.named_modules():
        key = f"{name}.embedding" if name else "embedding"
        if isinstance(m, EmbeddingTable) and m.mesh is not None and key in state:
            state[key] = m.fit(m.embedding, state[key])  # this rank's rows
    for key, (dim, mesh) in sharded_weights(module).items():
        if key in state:
            state[key] = local_share(state[key], dim, mesh)
    module.load_state_dict(state)
    return module


def _find_adam_state(tree: Any) -> Optional[Any]:
    """The first node of an optax state with ``count``, ``mu`` and ``nu``."""
    if all(hasattr(tree, k) for k in ("count", "mu", "nu")):
        return tree
    if isinstance(tree, Mapping):
        children = tree.values()
    elif isinstance(tree, (tuple, list)):
        children = tree
    else:
        return None
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def _moments(tree: Mapping, module: nn.Module) -> Dict[str, np.ndarray]:
    """torch key → array for every array leaf of a params-shaped tree over
    ``module`` (the placeholders of masked-out leaves have no shape and are
    skipped)."""
    out = {}
    for path, value in _flatten(tree):
        if not hasattr(value, "shape"):
            continue
        name, arr = _torch_leaf("params", path, value, module)
        out[".".join(path[:-1] + (name,))] = arr
    return out


def opt_state_from_jax(optimizer, module: nn.Module, opt_state: Any):
    """Load optax's Adam ``count``, ``mu`` and ``nu`` into ``optimizer`` (a
    ``tpurec_torch.train.trainer.ChainOptimizer`` over ``module``'s
    parameters) and return it. Every parameter the optimizer holds must have
    both moments in ``opt_state``; ``KeyError`` otherwise."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in the optax state")
    mu, nu = _moments(adam.mu, module), _moments(adam.nu, module)
    count = int(np.asarray(adam.count))
    for group in optimizer.param_groups:
        name, (p,) = group["name"], group["params"]
        if name not in mu or name not in nu:
            raise KeyError(f"no Adam moments for {name}")
        optimizer.state[p]["mu"] = torch.from_numpy(np.ascontiguousarray(mu[name])).to(p.device)
        optimizer.state[p]["nu"] = torch.from_numpy(np.ascontiguousarray(nu[name])).to(p.device)
        group["count"] = count
    return optimizer


def table_opt_from_jax(table_opt: Dict[str, Any], jax_table_opt: Mapping,
                       host_store=None, jax_host_store=None) -> Dict[str, Any]:
    """Copy a JAX ``state.table_opt`` into the port's ``table_opt`` (keyed by
    table parameter name, the flax path joined with dots) in place, and
    return it. Each table's state must be of the same kind on both sides,
    and each array of the same shape ((V, D) or a field-aware (V, F, D)
    table's; ``ValueError`` otherwise); a ``HostAdamState`` takes the
    moments of its JAX slot from ``jax_host_store`` into its slot of
    ``host_store``."""

    def copy(name, dst, src):
        arr = np.array(src, dtype=np.float32)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape}, port shape {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr).to(dst.dtype))

    # each table's state is a NamedTuple, a leaf to ``_flatten``
    leaves = {".".join(path): value for path, value in _flatten(jax_table_opt)}
    if set(leaves) != set(table_opt):
        raise KeyError(f"JAX tables {sorted(leaves)} != port tables {sorted(table_opt)}")
    with torch.no_grad():
        for name, st in table_opt.items():
            src = leaves[name]
            if type(src).__name__ != type(st).__name__:
                raise TypeError(f"{name}: JAX {type(src).__name__}, port {type(st).__name__}")
            if type(st).__name__ == "HostAdamState":
                jslot = int(np.asarray(src.slot))
                copy(f"{name}.m", host_store._m[st.slot], jax_host_store._m[jslot])
                copy(f"{name}.v", host_store._v[st.slot], jax_host_store._v[jslot])
                continue
            for field, dst in st._asdict().items():
                copy(f"{name}.{field}", dst, getattr(src, field))
    return table_opt
