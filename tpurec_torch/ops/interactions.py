"""Feature-interaction ops (counterpart of ``tpurec/ops/interactions.py``).
This slice carries the FM cross term; the rest of the module's ops come with
the models that use them."""

from __future__ import annotations

import torch

from tpurec_torch.ops import kernels


def fm_second_order(emb: torch.Tensor, training: bool = False) -> torch.Tensor:
    """FM 2nd-order cross, (B, F, D) → (B,): 0.5·Σ_d[(Σ_f v_f)² − Σ_f v_f²].

    ``training`` is the calling module's ``training`` mode. The JAX package
    launches its kernel at inference only (``tpurec/ops/interactions.py:
    44-48``, ``TRAIN_WINNERS`` empty) and reads a process-wide phase flag that
    its trainer sets while it traces the train step, the one step that also
    applies the model with ``train=True``; eval and inference apply it with
    ``train=False`` outside the phase. So the module's mode splits the calls
    the same way, without the global. Training: the plain math in the
    embedding's dtype, differentiated by autograd. Otherwise
    ``kernels.fm_second_order_fused`` in fp32 (the Triton kernel for CUDA
    tensors, the plain version for CPU ones), cast back to the embedding
    dtype. (The JAX op's ``reduce_dim=False`` bi-interaction form comes with
    NFM.)"""
    if training:
        return kernels.fm_second_order_plain(emb)
    return kernels.fm_second_order_fused(emb.to(torch.float32)).to(emb.dtype)
