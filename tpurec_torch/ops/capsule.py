"""Capsule dynamic routing for multi-interest extraction (counterpart of
``tpurec/ops/capsule.py``): ``squash``, ``valid_capsule_mask``,
``CapsuleRouting`` ('shared' for MIND, 'per_pos' for ComiRec-DR) and
``LabelAwareAttention``.

'shared' routing dispatches as the JAX module does (``fused_wins('capsule')``
with ``TRAIN_WINNERS`` empty, ``tpurec/ops/pallas/kernels.py:50-71``), on the
module's ``training`` mode in place of the JAX package's phase flag: outside
training it goes through ``kernels.CapsuleRouting`` in fp32 (kernel #7, and
#8 for a gradient, on the card; the plain versions on the CPU) and casts to
the behavior's dtype (``tpurec/ops/capsule.py:80-83``); in training it takes
the module's own math in the behavior's dtype (:86-114), differentiated by
autograd. 'per_pos' has no kernel: its math is the only route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tpurec_torch.initializers import glorot_uniform_, jax_normal
from tpurec_torch.ops import kernels

ROUTING_INIT_SEED = 7  # jax.random.key(7): the 'shared' routing-logit init


def squash(x: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """v = |x|²/(1+|x|²) · x/|x| (the capsule nonlinearity), eps inside the
    rsqrt."""
    sq = torch.square(x).sum(dim=dim, keepdim=True)
    return (sq / (1.0 + sq)) * x * torch.rsqrt(sq + eps)


def valid_capsule_mask(seq_len: torch.Tensor, max_capsules: int) -> torch.Tensor:
    """(B, K) fp32 mask with K_u = max(1, min(K, ceil(log2 len_u))) valid
    capsules (``tpurec/ops/capsule.py:29-35``)."""
    k_u = torch.ceil(torch.log2(seq_len.to(torch.float32).clamp_min(1.0)))
    k_u = k_u.clamp(1, max_capsules)
    idx = torch.arange(max_capsules, device=seq_len.device)[None, :]
    return (idx < k_u[:, None]).to(torch.float32)


class CapsuleRouting(nn.Module):
    """B-interest dynamic routing: behavior (B, L, D), mask (B, L) →
    capsules (B, K, E), capsule mask (B, K).

    ``mode='shared'``: one bilinear map ``S`` (D, E) and the fixed routing
    init ``normal(key(7), (1, K, L))`` (MIND). ``mode='per_pos'``: one map
    per capsule and position, ``W`` (K, max_length, D, E), and zero routing
    init (ComiRec-DR). Parameters are fp32; ``dtype`` is the compute dtype
    the model hands its behavior in."""

    def __init__(
        self,
        in_dim: int,
        num_capsules: int,
        dim: int,
        num_iterations: int = 3,
        mode: str = "shared",
        max_length: int = 0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_capsules = num_capsules
        self.num_iterations = num_iterations
        self.mode = mode
        self.dtype = dtype
        if mode == "shared":
            self.S = nn.Parameter(torch.empty(in_dim, dim))
        elif mode == "per_pos":
            if max_length < 1:
                raise ValueError("mode='per_pos' needs max_length")
            self.W = nn.Parameter(torch.empty(num_capsules, max_length, in_dim, dim))
        else:
            raise ValueError(f"unknown routing mode {mode!r}")
        # the flat stream of the 'shared' routing init: (1, K, L) takes its
        # first K·L values, so one buffer, grown on demand, serves every L.
        # Not a parameter, and not saved (the JAX module keeps no variable).
        self.register_buffer("init_stream", torch.empty(0), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.S if self.mode == "shared" else self.W, generator)

    def routing_init(self, length: int) -> torch.Tensor:
        """(1, K, length) fp32: ``jax.random.normal(jax.random.key(7), (1, K,
        length))``."""
        n = self.num_capsules * length
        if self.init_stream.numel() < n:
            with torch.inference_mode(False):  # usable by autograd later
                self.init_stream = torch.as_tensor(
                    jax_normal(ROUTING_INIT_SEED, n), device=self.init_stream.device
                )
        return self.init_stream[:n].view(1, self.num_capsules, length)

    def forward(
        self, behavior: torch.Tensor, mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, l, _ = behavior.shape
        k = self.num_capsules
        cap_mask = valid_capsule_mask(mask.sum(dim=-1), k)
        if self.mode == "shared":
            logits = self.routing_init(l).expand(b, k, l)
            if not self.training:
                capsules = kernels.CapsuleRouting.apply(
                    behavior.to(torch.float32), mask.to(torch.float32), self.S, logits,
                    self.num_iterations,
                )
                return capsules.to(behavior.dtype), cap_mask
            u_hat = torch.einsum("bld,de->ble", behavior, self.S.to(behavior.dtype))
            route = "bkl,ble->bke"
            agree = "bke,ble->bkl"
        else:
            u_hat = torch.einsum("bld,klde->bkle", behavior, self.W.to(behavior.dtype))
            logits = behavior.new_zeros((b, k, l), dtype=torch.float32)
            route = "bkl,bkle->bke"
            agree = "bke,bkle->bkl"
        live = mask.bool()[:, None, :]
        u_sg = u_hat.detach()
        capsules = None
        for it in range(self.num_iterations):
            w_route = torch.softmax(torch.where(live, logits, -1e9), dim=1) * mask[:, None, :]
            src = u_hat if it == self.num_iterations - 1 else u_sg
            z = torch.einsum(route, w_route.to(src.dtype), src)
            capsules = squash(z.to(torch.float32)).to(src.dtype)
            if it < self.num_iterations - 1:
                logits = logits + torch.einsum(
                    agree, capsules.to(torch.float32), u_sg.to(torch.float32)
                )
        return capsules, cap_mask


class LabelAwareAttention(nn.Module):
    """Blend capsules by their agreement with the target item: w =
    softmax over valid capsules of sign(c·t)·|c·t|^power; user vector Σ w·c
    (``tpurec/ops/capsule.py:117-135``)."""

    def __init__(self, power: float = 2.0):
        super().__init__()
        self.power = power

    def forward(
        self, capsules: torch.Tensor, capsule_mask: torch.Tensor, target: torch.Tensor
    ) -> torch.Tensor:
        scores = torch.einsum("bkd,bd->bk", capsules.to(torch.float32), target.to(torch.float32))
        scores = torch.sign(scores) * torch.pow(scores.abs(), self.power)
        scores = torch.where(capsule_mask.bool(), scores, -1e9)
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bk,bkd->bd", w.to(capsules.dtype), capsules)
