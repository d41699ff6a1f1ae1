"""What the plain references share: the parameter layout the benchmark
makes from a seed, the loss, optax's Adam, the rounding of the control, and
the readings of three training steps.

Plain PyTorch in fp32 (TF32 off, set by ``plain_fp32``); nothing here or in
the model files beside it imports the program under test, the JAX package
or JAX.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
# (name, shape, init): init is "table" (U(+-0.05)), "glorot" (U(+-sqrt(6 /
# (fan_in + fan_out))) over the last two axes), "zeros" or a float constant
Layout = List[Tuple[str, Tuple[int, ...], object]]

TABLE_SCALE = 0.05


def table_rows(vocab: int, lane: int = 128) -> int:
    """Rows of a table over ``vocab`` ids in the layout the benchmark loads:
    one spare row, rounded up to a multiple of 128."""
    return ((vocab + 1 + lane - 1) // lane) * lane


def make_weights(layout: Layout, seed: int, device) -> Params:
    """Every parameter of ``layout`` from ``seed``: one uniform draw on the
    device for all drawn parameters, sliced and scaled."""
    drawn = [(n, s, i) for n, s, i in layout if i in ("table", "glorot")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    buf = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out: Params = {}
    at = 0
    for name, shape, init in layout:
        if init in ("table", "glorot"):
            n = math.prod(shape)
            t = buf[at : at + n].view(shape)
            at += n
            if init == "table":
                t.mul_(TABLE_SCALE)
            else:
                t.mul_(math.sqrt(6.0 / (shape[-1] + shape[-2])))
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            t = torch.full(shape, float(init), device=device)
        out[name] = t
    return out


@contextlib.contextmanager
def plain_fp32():
    """fp32 products without TF32, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``x`` through one fp8 format with a per-tensor scale that maps its
    largest magnitude to the format's largest value."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(fmt).max, torch.ones_like(amax))
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Forward values in e4m3, gradients in e5m2 (fp8 training's usual
    pair), each scaled per tensor."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: where the program computes in bf16, the
    control computes in fp8."""
    return _Fp8.apply(x)


ROUNDINGS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {"fp32": exact, "fp8": fp8}


def dense(x, w, b, rnd) -> torch.Tensor:
    """``x @ w.T + b`` with inputs and output at the rounding ``rnd``."""
    return rnd(F.linear(rnd(x), rnd(w), rnd(b)))


def bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logit, label)


def device_batch(batch: Dict[str, np.ndarray], device, rows: slice = slice(None)):
    return {k: torch.as_tensor(v[rows], device=device) for k, v in batch.items()}


def adam_(params: Params, grads: Dict[str, torch.Tensor], mu, nu, step: int, opt) -> None:
    """optax's Adam, in place: mu_hat / (sqrt(nu_hat) + eps), eps_root 0, no
    clip, no decay."""
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["learning_rate"]
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (nu[k] / (1.0 - b2**step)).sqrt_().add_(eps)
            p.addcdiv_(mu[k], denom, value=-lr / (1.0 - b1**step))


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def train_readings(forward: Callable, cfg, weights: Params, batches: Sequence[Dict[str, np.ndarray]],
                   device, rnd=exact, rows: slice = slice(None)) -> Dict[str, object]:
    """Three (or ``len(batches)``) plain steps from ``weights``: each step's
    loss, every leaf's first gradient (``first_grads``) and its norm, and
    every leaf's change norm after the last step. ``rows`` keeps part of
    each batch (a fault's half)."""
    with plain_fp32():
        params = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        losses: List[float] = []
        grad_norms: Dict[str, float] = {}
        first: Dict[str, torch.Tensor] = {}
        for step, host in enumerate(batches, 1):
            batch = device_batch(host, device, rows)
            loss = bce(forward(params, batch, cfg, rnd), batch["label"])
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            if step == 1:
                grad_norms = {k: norm(g) for k, g in grads.items()}
                first = {k: g.detach() for k, g in grads.items()}
            adam_(params, grads, mu, nu, step, cfg["optimizer"])
            losses.append(float(loss.detach()))
            del grads, loss
        change = {k: norm(params[k].detach() - weights[k]) for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "first_grads": first}

