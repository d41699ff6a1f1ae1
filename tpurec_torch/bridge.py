"""Weights from the JAX package into the port.

``params_from_jax(module, variables)`` takes the JAX counterpart's variables
as a nested mapping of numpy arrays (``{'params': ..., 'batch_stats': ...}``,
boxes removed) and loads them in place into the port ``module`` (a registry
model, an MLP, an attention block). The port keeps flax's module names, so a
flax path maps to a torch key by joining with dots, with these renames:

- a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
- ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``;
- tables and the raw parameters keep their names and shapes: the DIN
  attention's ``w1``, ``b1``, ``w2``, ``alpha``; the DCN cross's ``w_{i}``
  (D, 1) and ``b_{i}``; CIN's ``compress_{i}``; the bilinear ``w``; and
  SENet-bilinear's ``squeeze_kernel``/``excite_kernel`` (used as
  ``z @ kernel``, so not transposed) and ``squeeze_bias``/``excite_bias``;
  the capsule routing's ``S`` (D, E) and ``W`` (K, L, D, E); SINE's
  ``interest_pool``; the retrieval models' ``logit_scale``.
  Only a leaf named exactly ``kernel`` is a Dense kernel.

It raises ``KeyError`` on a collection other than those two or a leaf name
it does not know, and the strict ``load_state_dict`` raises
``RuntimeError`` on any key of either side left unmatched and on any shape
that differs.

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
    "S", "W", "interest_pool",
}
_INDEXED_KEEP = re.compile(r"(w|b|compress)_\d+")
_STAT_RENAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def _torch_leaf(collection: str, path: Tuple[str, ...], value) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if collection == "batch_stats":
        if leaf not in _STAT_RENAMES:
            raise KeyError(f"unmatched batch_stats leaf {'/'.join(path)}")
        return _STAT_RENAMES[leaf], arr
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
    extra = set(variables) - {"params", "batch_stats", "tables"}
    if extra:
        raise KeyError(f"unmatched collections {sorted(extra)}")
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "tables", "batch_stats"):
        for path, value in _flatten(variables.get(collection) or {}):
            name, arr = _torch_leaf("batch_stats" if collection == "batch_stats" else "params",
                                    path, value)
            state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
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


def _moments(tree: Mapping) -> Dict[str, np.ndarray]:
    """torch key → array for every array leaf of a params-shaped tree (the
    placeholders of masked-out leaves have no shape and are skipped)."""
    out = {}
    for path, value in _flatten(tree):
        if not hasattr(value, "shape"):
            continue
        name, arr = _torch_leaf("params", path, value)
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
    mu, nu = _moments(adam.mu), _moments(adam.nu)
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
    return it. Each table's state must be of the same kind on both sides;
    a ``HostAdamState`` takes the moments of its JAX slot from
    ``jax_host_store`` into its slot of ``host_store``."""
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
                host_store._m[st.slot].copy_(torch.from_numpy(np.array(jax_host_store._m[jslot])))
                host_store._v[st.slot].copy_(torch.from_numpy(np.array(jax_host_store._v[jslot])))
                continue
            for field, dst in st._asdict().items():
                arr = np.array(getattr(src, field), dtype=np.float32)
                dst.copy_(torch.from_numpy(arr).to(dst.dtype))
    return table_opt
