"""Dense tower building blocks: ``Dense``, ``MLP``, ``PReLU`` and ``Dice``
(counterpart of ``tpurec/ops/mlp.py``), and flax's ``BatchNorm``,
``LayerNorm`` and ``Dropout``.

Parameters are fp32; matmuls run in the module's compute ``dtype`` (bf16 in
production, as the JAX package's trainer sets it). Normalisation statistics
are computed in fp32. Child modules keep the flax names (``dense_0``,
``prelu_0``, ``dice_0/bn``...) so weights map across by path.

Tensor parallelism over the mesh's 'model' axis (``Dense.place``, called
through ``models.registry.place_on_mesh``) changes where weights live, not
what they compute: a ``'column'`` layer holds this rank's share of the
output columns (weight and bias) and reads its whole input, whose
backward sums over the axis (``replicated_input``, Megatron's *f*); a
``'row'`` layer holds its share of the input rows, takes this rank's
columns of its input, sums its partial products over the axis (``psum``,
Megatron's *g*) and adds its whole bias once, after the sum.
``tp_input`` lays an activation out for the next layer. Every rank draws
the whole weight and keeps its share (``initializers.draw_share_``).

Dropout in training mode draws its mask from the generator that
``dropout_generator(model, generator)`` hands it (the trainer hands over
``TrainState.generator``, where the JAX package uses its ``'dropout'``
rng); the draw (``Dropout.keep_mask``) is apart from the masking
(``apply_dropout_mask``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.core.collectives import all_gather, psum, replicated_input
from tpurec_torch.core.mesh import MODEL_AXIS
from tpurec_torch.initializers import draw_share_, glorot_uniform_, lecun_normal_, orthogonal_


def share(mesh, dim: int):
    """(dim, index, n): this rank's share over 'model' on ``dim``, the
    split ``initializers.draw_share_`` takes."""
    return dim, mesh.model_index, mesh.n_model


def split_over_model(size: int, mesh) -> bool:
    """Whether a dimension of ``size`` splits over ``mesh``'s 'model' axis;
    the JAX package's ``_place`` keeps a parameter whole where it does not
    (``tpurec/train/trainer.py:365-371``)."""
    return mesh.n_model > 1 and size % mesh.n_model == 0


def gather_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole last axis of an activation split over 'model', read alike
    by every rank."""
    return all_gather(x, mesh.model_group, mesh.model_index, mesh.n_model, -1)


def tp_input(x: torch.Tensor, split: Optional[str], sharded: bool, mesh) -> torch.Tensor:
    """``x`` (its last axis this rank's share over 'model' when ``sharded``)
    laid out for a layer split as ``split``: a ``'row'`` layer takes this
    rank's columns, any other layer the whole axis."""
    if split == "row":
        if sharded:
            return x
        k = x.shape[-1] // mesh.n_model
        return replicated_input(x, mesh.model_group).narrow(-1, mesh.model_index * k, k)
    return gather_columns(x, mesh) if sharded else x


def _compute_dtype(x: torch.Tensor, param: torch.Tensor, dtype: Optional[torch.dtype]):
    """flax ``promote_dtype``: the module dtype when set, else the promotion of
    the input's and the parameter's types."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is (out, in) like ``nn.Linear`` (the flax
    kernel transposed), bias zeros (none with ``use_bias=False``); inputs,
    weight and bias are cast to the compute dtype before the product.
    ``kernel_init`` is lecun normal (flax's default), glorot uniform, or
    orthogonal (the recurrent cells' hidden-state kernels)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        dtype: Optional[torch.dtype] = None,
        kernel_init: str = "lecun_normal",
        use_bias: bool = True,
    ):
        super().__init__()
        if kernel_init not in ("lecun_normal", "glorot_uniform", "orthogonal"):
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self.dtype = dtype
        self.kernel_init = kernel_init
        # tensor parallelism over 'model' (``place``): the split, the mesh,
        # and the dimension of each parameter held as this rank's share
        self.split: Optional[str] = None
        self.mesh = None
        self.shard_dims: Dict[str, int] = {}

    def place(self, mesh, split: str) -> bool:
        """Hold this rank's share over ``mesh``'s 'model' axis: ``'column'``
        splits the output (weight and bias), ``'row'`` the input (the bias
        stays whole). A width that does not divide stays whole. Call before
        ``init_weights``; returns whether the layer is split."""
        dim = {"column": 0, "row": 1}[split]
        if not split_over_model(self.weight.shape[dim], mesh):
            return False
        self.split, self.mesh = split, mesh
        self.shard_dims = {"weight": dim}
        shape = list(self.weight.shape)
        shape[dim] //= mesh.n_model
        self.weight = nn.Parameter(self.weight.new_empty(shape))
        if split == "column" and self.bias is not None:
            self.bias = nn.Parameter(self.bias.new_empty(shape[0]))
            self.shard_dims["bias"] = 0
        return True

    def init_weights(self, generator: torch.Generator) -> None:
        if self.kernel_init == "glorot_uniform":
            draw = lambda t: glorot_uniform_(t, generator)  # noqa: E731
        elif self.kernel_init == "orthogonal":
            draw = lambda t: orthogonal_(t, generator)  # noqa: E731
        else:
            draw = lambda t: lecun_normal_(t, generator)  # noqa: E731
        draw_share_(self.weight, draw, share(self.mesh, self.shard_dims["weight"])
                    if self.split else None)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: the whole input, or this rank's columns for a ``'row'``
        layer (``tp_input``); a ``'column'`` layer gives this rank's
        columns."""
        dt = _compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.split == "row":
            y = psum(F.linear(x.to(dt), self.weight.to(dt)), self.mesh.model_group)
            return y if bias is None else y + bias
        if self.split == "column":
            x = replicated_input(x, self.mesh.model_group)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99)`` over every axis but the last:
    ``scale`` (ones) and ``bias`` (zeros) when ``use_scale``/``use_bias``,
    ``epsilon`` 1e-5 by default (``Dice`` takes neither and 1e-9). Its
    ``running_mean``/``running_var`` are flax's ``batch_stats``
    ``mean``/``var``. Statistics and the normalisation are computed in fp32.

    In training mode it normalises with the batch's mean and its *biased*
    variance (flax's E[x²] − E[x]², clipped at 0) and updates the running
    statistics itself, ``r = 0.99·r + 0.01·batch``, with that same biased
    variance (``F.batch_norm`` would update ``running_var`` with the unbiased
    one). In eval mode it normalises with the running statistics.

    On a mesh (``data_group``, set by ``models.registry.place_on_mesh``) the
    batch moments are the global batch's, as GSPMD computes them for the
    JAX package: each rank's sums and row count are summed over 'data', and
    that sum's backward sums the ranks' cotangents, whose losses differ.

    The output dtype is flax's: ``dtype`` when it is set (FiBiNET++'s
    ``cat_bn``; the statistics and the normalisation stay fp32), else the
    promotion of the input's and the fp32 parameters' types (fp32 for a
    bf16 input; NFM's ``bn``), or the input's when there are no
    parameters."""

    momentum = 0.99  # flax convention: the weight of the running value

    def __init__(self, num_features: int, use_scale: bool = True, use_bias: bool = True,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.empty(num_features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.data_group = None  # the 'data' axis's group on a mesh

    def init_weights(self, generator: torch.Generator) -> None:
        if self.scale is not None:
            nn.init.ones_(self.scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1]).float()
        if self.training and self.data_group is not None:
            count = flat.new_full((1,), flat.shape[0])
            sums = torch.cat([flat.sum(dim=0), torch.square(flat).sum(dim=0), count])
            sums = psum(replicated_input(sums, self.data_group), self.data_group)
            c = flat.shape[1]
            mean = sums[:c] / sums[-1]
            var = (sums[c : 2 * c] / sums[-1] - torch.square(mean)).clamp_min(0.0)
        elif self.training:
            mean = flat.mean(dim=0)
            var = (torch.square(flat).mean(dim=0) - torch.square(mean)).clamp_min(0.0)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(
                    self.momentum * self.running_mean + (1.0 - self.momentum) * mean
                )
                self.running_var.copy_(
                    self.momentum * self.running_var + (1.0 - self.momentum) * var
                )
        else:
            mean, var = self.running_mean, self.running_var
        y = _normalize(flat, mean, var, self.epsilon, self.scale, self.bias)
        if self.dtype is not None:
            return y.reshape(x.shape).to(self.dtype)
        has_params = self.scale is not None or self.bias is not None
        return y.reshape(x.shape).to(torch.promote_types(x.dtype, torch.float32) if has_params else x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (not torch's
    1e-5), ``scale`` (ones) and ``bias`` (zeros); the mean and the variance
    (E[x²] − E[x]², clipped at 0) in fp32 whatever the input's dtype, the
    normalisation in fp32, the result in ``dtype`` (None: the promotion of
    the input's type and fp32)."""

    epsilon = 1e-6

    def __init__(self, num_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (torch.square(x32).mean(dim=-1, keepdim=True) - torch.square(mean)).clamp_min(0.0)
        y = _normalize(x32, mean, var, self.epsilon, self.scale, self.bias)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


def _normalize(x, mean, var, epsilon, scale, bias):
    """flax's ``_normalize`` in fp32: (x − mean)·(rsqrt(var + ε)·scale) + bias."""
    mul = torch.rsqrt(var + epsilon)
    if scale is not None:
        mul = mul * scale
    y = (x - mean) * mul
    return y if bias is None else y + bias


class PReLU(nn.Module):
    """Parametric ReLU with a learnable per-channel slope (init
    ``init_alpha``)."""

    def __init__(self, num_features: int, init_alpha: float = 0.25):
        super().__init__()
        self.init_alpha = init_alpha
        self.alpha = nn.Parameter(torch.empty(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.alpha, self.init_alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)
        return torch.where(x > 0, x, alpha * x)


class Dice(nn.Module):
    """Data-adaptive activation: p = sigmoid(BN(x)); out = p·x + (1−p)·α·x.
    The BatchNorm has no scale or bias, ``epsilon`` (1e-9) and flax momentum
    0.99."""

    def __init__(self, num_features: int, epsilon: float = 1e-9):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features))
        self.bn = BatchNorm(num_features, use_scale=False, use_bias=False, epsilon=epsilon)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)
        p = torch.sigmoid(self.bn(x))
        return p * x + (1.0 - p) * alpha * x


def apply_dropout_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``'s masking: ``x / (1 − rate)`` where ``keep`` and 0
    elsewhere, 0 everywhere at ``rate`` 1. The divisor is 1 − rate in
    ``x``'s dtype, as JAX divides by a Python scalar, and a tensor on
    ``x``'s device: CUDA multiplies by the reciprocal of a CPU scalar,
    one rounding off a division."""
    if rate == 1.0:
        keep = torch.zeros_like(keep)  # flax: zeros, and a zero gradient
    keep_prob = torch.full((), 1.0 - rate if rate < 1.0 else 1.0, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, x.new_zeros(()))


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: the identity outside training or at rate 0;
    in training each element is kept with probability 1 − ``rate``
    (``keep_mask``) and scaled by 1 / (1 − rate) (``apply_dropout_mask``).
    Training with a rate above 0 needs a generator (``dropout_generator``);
    it never falls back to torch's global one.

    On a mesh the mask is the one-device run's: every rank draws the
    global batch's mask (``batch_mesh``, set by
    ``models.registry.place_on_mesh`` on data > 1: n_data·B rows) at the
    whole width and keeps its block of rows over 'data' and, for an
    activation split over 'model', its columns."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1]")
        self.rate = rate
        self.generator: Optional[torch.Generator] = None  # set by dropout_generator
        self.batch_mesh = None

    def keep_mask(self, shape: Sequence[int], device,
                  columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """A bool mask of ``shape``, each element True with probability
        1 − rate (``uniform < 1 − rate``, as ``jax.random.bernoulli``); on a
        mesh this rank's block of the one-device mask, ``columns`` =
        (index, n) its share of the last axis over 'model'."""
        if self.generator is None:
            raise RuntimeError(
                "dropout in training needs a generator: run the model under "
                "dropout_generator(model, generator) (the Trainer does)"
            )
        mesh = self.batch_mesh
        n_data, data_index = (mesh.n_data, mesh.data_index) if mesh is not None else (1, 0)
        index, n = columns or (0, 1)
        rows, width = shape[0], shape[-1]
        whole = (n_data * rows, *shape[1:-1], n * width)
        keep = torch.rand(whole, device=device, generator=self.generator) < 1.0 - self.rate
        return keep.narrow(0, data_index * rows, rows).narrow(-1, index * width, width)

    def forward(self, x: torch.Tensor, columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:  # flax draws nothing
            keep = x.new_zeros(x.shape, dtype=torch.bool)
        else:
            keep = self.keep_mask(x.shape, x.device, columns)
        return apply_dropout_mask(x, keep, self.rate)


@contextlib.contextmanager
def dropout_generator(model: nn.Module, generator: Optional[torch.Generator]):
    """In the body, every ``Dropout`` under ``model`` draws its masks from
    ``generator``."""
    mods = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in mods:
        m.generator = generator
    try:
        yield
    finally:
        for m in mods:
            m.generator = None


_SIMPLE_ACTS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu: the tanh form
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "linear": lambda x: x,
    None: lambda x: x,
}
# activations that read the whole last axis (their parameters, or the
# softmax's sum, are whole): a column-split layer's share is gathered first
_WHOLE_WIDTH_ACTS = ("prelu", "dice", "softmax")


class MLP(nn.Module):
    """Multi-layer dense tower (``tpurec/ops/mlp.py:MLP``).

    ``activation`` applies after every layer; the last layer uses
    ``out_activation`` when it is set and ``activation`` otherwise (so DIN's
    ``MLP((200, 80))`` ends in relu). Activations: relu, sigmoid, tanh,
    gelu (flax's tanh form), softmax (over the last axis), linear (or
    None), prelu and dice. Each layer but the last is followed, in this
    order, by ``bn_{i}`` (``BatchNorm``, flax's defaults, in ``dtype``) when
    ``use_bn``, ``ln_{i}`` (``LayerNorm``) when ``use_ln``, the activation,
    and ``Dropout(dropout_rate)`` when the rate is above 0; the last layer
    by its activation only. ``kernel_init`` names a ``Dense`` initialiser.

    ``tp_axis='model'`` (DIN's, DIEN's and DSIN's ``mlp``) makes it tensor
    parallel on a mesh (``place``): even layers split their columns, odd
    layers their rows, as ``tpurec/ops/mlp.py:100-108`` partitions them, so
    a column layer's share of the activation feeds the next row layer
    without a gather. What reads the whole width (a norm, a prelu or dice
    activation, whose parameters are whole, a softmax, and the tower's
    output) gathers the columns first; dropout on a share masks it with its
    columns of the one-device mask (``Dropout``).
    """

    def __init__(
        self,
        in_features: int,
        hidden_dims: Sequence[int],
        activation: Optional[str] = "relu",
        out_activation: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        tp_axis: Optional[str] = None,
        use_bn: bool = False,
        use_ln: bool = False,
        dropout_rate: float = 0.0,
        kernel_init: str = "glorot_uniform",
    ):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.tp_axis = tp_axis
        self.use_bn, self.use_ln = use_bn, use_ln
        self.mesh = None
        self.acts = []
        n = len(self.hidden_dims)
        width_in = in_features
        for i, width in enumerate(self.hidden_dims):
            self.add_module(f"dense_{i}", Dense(width_in, width, dtype, kernel_init))
            if i < n - 1 and use_bn:
                self.add_module(f"bn_{i}", BatchNorm(width, dtype=dtype))
            if i < n - 1 and use_ln:
                self.add_module(f"ln_{i}", LayerNorm(width, dtype))
            act = activation
            if i == n - 1 and out_activation is not None:
                act = out_activation
            if act == "prelu":
                self.add_module(f"prelu_{i}", PReLU(width))
            elif act == "dice":
                self.add_module(f"dice_{i}", Dice(width))
            elif act not in _SIMPLE_ACTS:
                raise ValueError(f"unknown activation {act!r}")
            self.acts.append(act)
            width_in = width
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def place(self, mesh) -> None:
        """Split the layers over ``mesh``'s 'model' axis when ``tp_axis`` is
        'model': column, row, column... (each layer whole where its width
        does not divide)."""
        if self.tp_axis != MODEL_AXIS or mesh.n_model == 1:
            return
        self.mesh = mesh
        for i in range(len(self.acts)):
            getattr(self, f"dense_{i}").place(mesh, "column" if i % 2 == 0 else "row")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sharded = False  # x's last axis is this rank's share over 'model'
        last = len(self.acts) - 1
        for i, act in enumerate(self.acts):
            dense = getattr(self, f"dense_{i}")
            x = dense(tp_input(x, dense.split, sharded, self.mesh))
            sharded = dense.split == "column"
            norm = i < last and (self.use_bn or self.use_ln)
            if sharded and (norm or act in _WHOLE_WIDTH_ACTS):
                x, sharded = gather_columns(x, self.mesh), False
            if i < last and self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            if i < last and self.use_ln:
                x = getattr(self, f"ln_{i}")(x)
            if act in ("prelu", "dice"):
                x = getattr(self, f"{act}_{i}")(x)
            else:
                x = _SIMPLE_ACTS[act](x)
            if i < last and self.dropout is not None:
                m = self.mesh
                x = self.dropout(x, (m.model_index, m.n_model) if sharded else None)
        return gather_columns(x, self.mesh) if sharded else x
