"""Hand-written Hopper kernels, their plain PyTorch versions, and the build.

Each kernel has:

- a plain PyTorch version (``*_plain``) computing the same function the way
  the JAX package's ``*_reference`` does. The CPU tests run it; on the card
  it is the yardstick the kernel is checked against;
- a wrapper (``*_fused``) that takes the plain version ONLY for tensors on
  the CPU. For a CUDA tensor it launches the kernel or raises: there is no
  fallback;
- a launch count, ``<wrapper>.launches``, raised by one at each launch.

A wrapper records no backward. On CUDA tensors it raises when grad mode is
on and an input requires grad, so a gradient is never dropped silently:
training goes through an ``autograd.Function`` (``DinAttention``) or through
the plain math (the FM cross term of a module in training mode).

Kernels of this module:

- ``din_attention_fused``: CUDA C++ for ``sm_90a``
  (``tpurec_torch/csrc/din_attention.cu``), built with ``nvcc`` into a shared
  library with a C interface and loaded with ``ctypes``. Replaces
  ``tpurec/ops/pallas/kernels.py:din_attention_fused``.
- ``din_attention_bwd_fused``: CUDA C++ for ``sm_90a``
  (``tpurec_torch/csrc/din_attention_bwd.cu``), the same route. Replaces
  ``tpurec/ops/pallas/kernels.py:din_attention_bwd_fused``. ``DinAttention``
  pairs it with the forward.
- ``fm_second_order_fused``: Triton. Replaces
  ``tpurec/ops/pallas/kernels.py:fm_second_order_fused``.
- ``cross_network_fused``: Triton. Replaces
  ``tpurec/ops/pallas/kernels.py:cross_network_stack`` (every DCN vector
  cross layer in one pass).
- ``cin_fused``: CUDA C++ for ``sm_90a`` (``tpurec_torch/csrc/cin.cu``), the
  ``ctypes`` route. Replaces ``tpurec/ops/pallas/kernels.py:cin_fused``
  (every xDeepFM CIN level in one launch).
- ``senet_bilinear_fused``: CUDA C++ for ``sm_90a``
  (``tpurec_torch/csrc/senet_bilinear.cu``), the ``ctypes`` route. Replaces
  ``tpurec/ops/pallas/kernels.py:senet_bilinear_fused`` (FiBiNET's SENet
  and 'all'-mode bilinear pairs).

These three run at inference only, as in the JAX package: a module in
training mode takes the plain version (``tpurec_torch.ops.interactions``).

- ``capsule_routing_fused`` and ``capsule_routing_bwd_fused``: CUDA C++ for
  ``sm_90a`` (``tpurec_torch/csrc/capsule_routing.cu``), the ``ctypes``
  route. Replace ``tpurec/ops/pallas/kernels.py:capsule_routing_fused`` and
  ``capsule_routing_bwd_fused`` (MIND's dynamic routing, every iteration in
  one launch, and its backward); ``CapsuleRouting`` pairs them. MIND's
  routing module takes them outside training mode, its own math in
  training (``tpurec_torch.ops.capsule``), as the JAX package does.

The sorted-stream embedding kernels (``fused_scatter_add``,
``gather_rows_sorted``, CUDA C++ in ``tpurec_torch/csrc/embedding_update.cu``)
have their wrappers in ``tpurec_torch.ops.embedding_update`` and are built and
loaded here, the same route.

CUDA sources build on first use (or through ``build()``) into ``build/kernels``
at the repository root, named by a hash of the source, so a checkout builds
everything it runs from its own files. Triton compiles at first launch into
``build/triton`` (``TRITON_CACHE_DIR`` unless the caller set one).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
TRITON_CACHE_DIR = _PACKAGE.parent / "build" / "triton"
# one shared library per CUDA source
CUDA_SOURCES = {
    "din_attention": "din_attention.cu",
    "din_attention_bwd": "din_attention_bwd.cu",
    "embedding_update": "embedding_update.cu",
    "cin": "cin.cu",
    "senet_bilinear": "senet_bilinear.cu",
    "capsule_routing": "capsule_routing.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# largest dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448

_LOAD_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


# --------------------------------------------------------------------------
# build and load
def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the shared library of CUDA source ``name`` is built: the file
    name carries a hash of the source and the flags."""
    src = CSRC_DIR / CUDA_SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the CUDA sources that are not built yet, one ``nvcc`` each, all
    started together. Each library is written under a temporary name and
    renamed into place, and ``nvcc``'s report (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside it as ``<lib>.log``. Raises
    with the compiler's output when a build fails."""
    names = list(CUDA_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / CUDA_SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def _library(name: str) -> ctypes.CDLL:
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.tpurec_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpurec_cuda_error_string.restype = ctypes.c_char_p
            if name == "din_attention":
                lib.din_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
                lib.din_attention_smem_bytes.restype = ctypes.c_size_t
                lib.din_attention_route.argtypes = [ctypes.c_int] * 2
                lib.din_attention_route.restype = ctypes.c_int
                lib.din_attention_warps.argtypes = [ctypes.c_int] * 2
                lib.din_attention_warps.restype = ctypes.c_int
                lib.din_attention_blocks.argtypes = [ctypes.c_int] * 3
                lib.din_attention_blocks.restype = ctypes.c_int
                lib.din_attention_forward.argtypes = (
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                )
                lib.din_attention_forward.restype = ctypes.c_int
            elif name == "din_attention_bwd":
                lib.din_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
                lib.din_attention_bwd_smem_bytes.restype = ctypes.c_size_t
                lib.din_attention_bwd_blocks.argtypes = [ctypes.c_int] * 4
                lib.din_attention_bwd_blocks.restype = ctypes.c_int
                lib.din_attention_backward.argtypes = (
                    [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                )
                lib.din_attention_backward.restype = ctypes.c_int
            elif name == "embedding_update":
                for fn in (lib.embedding_scatter_slice_rows, lib.embedding_scatter_tile_rows):
                    fn.argtypes = [ctypes.c_int]
                    fn.restype = ctypes.c_int
                lib.embedding_scatter_scratch_floats.argtypes = [ctypes.c_int64, ctypes.c_int]
                lib.embedding_scatter_scratch_floats.restype = ctypes.c_int64
                lib.embedding_fused_scatter_add.argtypes = [ctypes.c_void_p] * 4 + [
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
                ]
                lib.embedding_fused_scatter_add.restype = ctypes.c_int
                lib.embedding_gather_rows.argtypes = [ctypes.c_void_p] * 3 + [
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
                ]
                lib.embedding_gather_rows.restype = ctypes.c_int
            elif name == "cin":
                lib.cin_smem_bytes.argtypes = [ctypes.c_int] * 3
                lib.cin_smem_bytes.restype = ctypes.c_size_t
                lib.cin_blocks_per_sm.argtypes = [ctypes.c_int] * 3
                lib.cin_blocks_per_sm.restype = ctypes.c_int
                lib.cin_forward.argtypes = [ctypes.c_void_p] * 3 + [
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p,
                ]
                lib.cin_forward.restype = ctypes.c_int
            elif name == "senet_bilinear":
                lib.senet_bilinear_smem_bytes.argtypes = [ctypes.c_int] * 3
                lib.senet_bilinear_smem_bytes.restype = ctypes.c_size_t
                lib.senet_bilinear_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                    ctypes.c_void_p
                ]
                lib.senet_bilinear_forward.restype = ctypes.c_int
            elif name == "capsule_routing":
                lib.capsule_routing_smem_bytes.argtypes = [ctypes.c_int] * 4
                lib.capsule_routing_smem_bytes.restype = ctypes.c_size_t
                lib.capsule_routing_bwd_smem_bytes.argtypes = [ctypes.c_int] * 5
                lib.capsule_routing_bwd_smem_bytes.restype = ctypes.c_size_t
                lib.capsule_routing_blocks.argtypes = [ctypes.c_int] * 4
                lib.capsule_routing_blocks.restype = ctypes.c_int
                lib.capsule_routing_bwd_blocks.argtypes = [ctypes.c_int] * 6
                lib.capsule_routing_bwd_blocks.restype = ctypes.c_int
                lib.capsule_routing_forward.argtypes = [ctypes.c_void_p] * 4 + [
                    ctypes.c_long, ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
                lib.capsule_routing_forward.restype = ctypes.c_int
                lib.capsule_routing_backward.argtypes = [ctypes.c_void_p] * 4 + [
                    ctypes.c_long] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
                lib.capsule_routing_backward.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def _check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tpurec_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


def _require_cuda(what: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: tensors on {t.device} are neither CPU nor CUDA")


def _require_cuda_f32(what: str, device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")


def _refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """A kernel records no backward: refuse inputs that want a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel records no backward and an input requires grad; "
            "train through the op's autograd path (DinAttention, or the plain math "
            "of a module in training mode), or call it under torch.no_grad()"
        )


# --------------------------------------------------------------------------
# DIN target attention
def din_attention_plain(
    query: torch.Tensor,  # (B, D)
    keys: torch.Tensor,  # (B, L, D)
    mask: torch.Tensor,  # (B, L), nonzero = real step
    w1: torch.Tensor,  # (4D, H)
    b1: torch.Tensor,  # (H,)
    w2: torch.Tensor,  # (H,)
    alpha: Optional[torch.Tensor] = None,  # (H,) PReLU slopes; None = relu
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DIN activation-unit scores and masked sum-pool, written as
    ``din_attention_reference`` is: the (B, L, 4D) features are built."""
    b, l, d = keys.shape
    q = query[:, None, :].expand(b, l, d)
    feats = torch.cat([q, q - keys, keys, q * keys], dim=-1)
    lin = feats @ w1 + b1
    hidden = lin.clamp_min(0.0)
    if alpha is not None:
        hidden = hidden + alpha * lin.clamp_max(0.0)
    scores = torch.where(mask != 0, hidden @ w2, 0.0)
    pooled = torch.einsum("bl,bld->bd", scores, keys)
    return pooled, scores


DIN_ATTENTION_DIMS = (8, 16, 32, 64)  # key widths the CUDA kernels are built for
# the forward's tensor-core kernel and the backward are built for H in
# 8-column tiles up to 16; the forward takes wider H on its fp32 kernel
DIN_TC_MAX_H = DIN_BWD_MAX_H = 128


def din_attention_fused(
    query: torch.Tensor,
    keys: torch.Tensor,
    mask: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DIN target attention: ``(pooled (B, D), scores (B, L))``, fp32.

    CPU tensors take ``din_attention_plain``. CUDA tensors launch a kernel of
    ``csrc/din_attention.cu``, which never materialises the (B, L, 4D)
    features: for H up to ``DIN_TC_MAX_H`` the tensor-core kernel (each
    row's live 16-step tiles, ``lin = K·W_eff`` in 3xTF32 ``mma.sync``, any
    L; ``din_attention_unfolded`` is its arithmetic on the CPU), for wider H
    the fp32 kernel, which holds a row's keys in shared memory. It takes fp32
    inputs on one device, D in ``DIN_ATTENTION_DIMS``, keys that start on a
    16-byte boundary and shapes whose shared memory fits one block, and
    raises on anything else. ``alpha=None`` means relu (zero slopes). It
    records no backward: on CUDA it raises under grad mode when an input
    requires grad (``DinAttention`` is the differentiable form)."""
    if keys.device.type == "cpu":
        return din_attention_plain(query, keys, mask, w1, b1, w2, alpha)
    _refuse_grad("din_attention", query, keys, w1, b1, w2, alpha)
    _require_cuda("din_attention", keys)
    b, l, d = keys.shape
    h = w1.shape[1]
    dev = keys.device
    if alpha is None:
        alpha = torch.zeros(h, device=dev, dtype=torch.float32)
    mask = mask.to(torch.float32)
    _require_cuda_f32(
        "din_attention", dev, query=query, keys=keys, mask=mask, w1=w1, b1=b1, w2=w2,
        alpha=alpha,
    )
    if (
        query.shape != (b, d) or mask.shape != (b, l) or w1.shape != (4 * d, h)
        or b1.shape != (h,) or w2.shape != (h,) or alpha.shape != (h,)
    ):
        raise ValueError(
            "din_attention: shapes do not agree: query "
            f"{tuple(query.shape)}, keys {tuple(keys.shape)}, mask {tuple(mask.shape)}, "
            f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"alpha {tuple(alpha.shape)}"
        )
    if d not in DIN_ATTENTION_DIMS:
        raise ValueError(f"din_attention: key width {d} not in {DIN_ATTENTION_DIMS}")
    lib = _library("din_attention")
    smem = lib.din_attention_smem_bytes(l, d, h)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"din_attention: L={l}, D={d}, H={h} needs {smem} bytes of shared "
            f"memory per block, more than {MAX_SMEM_BYTES}"
        )
    pooled = torch.empty(b, d, device=dev, dtype=torch.float32)
    scores = torch.empty(b, l, device=dev, dtype=torch.float32)
    if b == 0 or l == 0:
        return pooled.zero_(), scores
    args = [t.contiguous() for t in (query, keys, mask, w1, b1, w2, alpha)]
    if args[1].data_ptr() % 16:
        # the kernel reads keys as float4; a misaligned view would fault
        # asynchronously and poison the CUDA context
        raise ValueError(
            f"din_attention: keys must start on a 16-byte boundary (storage offset "
            f"{keys.storage_offset()} floats); pass keys.clone()"
        )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.din_attention_forward(
            *[t.data_ptr() for t in args], pooled.data_ptr(), scores.data_ptr(),
            b, l, d, h, stream,
        )
    _check_launch(lib, err, "din_attention")
    din_attention_fused.launches += 1
    return pooled, scores


din_attention_fused.launches = 0


def din_attention_bwd_plain(
    query: torch.Tensor,  # (B, D)
    keys: torch.Tensor,  # (B, L, D)
    mask: torch.Tensor,  # (B, L) float
    w1: torch.Tensor,  # (4D, H)
    b1: torch.Tensor,  # (H,)
    w2: torch.Tensor,  # (H,)
    alpha: torch.Tensor,  # (H,) PReLU slopes; zeros = relu
    gp: torch.Tensor,  # (B, D) cotangent of pooled
    gs: torch.Tensor,  # (B, L) cotangent of scores
) -> Tuple[torch.Tensor, ...]:
    """The DIN attention backward written out as ``_din_bwd_kernel``
    (``tpurec/ops/pallas/kernels.py:391-481``) computes it: recompute the
    activation unit, then ``(dq, dkeys, dw1, db1, dw2, dalpha)`` with the
    parameter gradients summed over the batch. The mask gets no gradient and
    scales the scores (``s·mask``), as in that kernel; for 0/1 masks this is
    the forward's ``where``."""
    b, l, d = keys.shape
    h = w1.shape[1]
    w_q = w1[0:d] + w1[d : 2 * d]
    w_k = w1[2 * d : 3 * d] - w1[d : 2 * d]
    w_p = w1[3 * d : 4 * d]
    qk = query[:, None, :] * keys  # (B, L, D)
    lin = keys @ w_k + qk @ w_p + (query @ w_q)[:, None, :] + b1  # (B, L, H)
    neg = lin.clamp_max(0.0)
    hval = lin.clamp_min(0.0) + alpha * neg
    s = (hval @ w2) * mask  # (B, L)
    gs_tot = (gs + (gp[:, None, :] * keys).sum(dim=-1)) * mask
    dh = gs_tot[:, :, None] * w2  # (B, L, H)
    dlin = dh * ((lin > 0).to(lin.dtype) + alpha * (lin < 0).to(lin.dtype))
    dw2 = (gs_tot[:, :, None] * hval).reshape(-1, h).sum(dim=0)
    dalpha = (dh * neg).reshape(-1, h).sum(dim=0)
    db1 = dlin.reshape(-1, h).sum(dim=0)
    dlin_b = dlin.sum(dim=1)  # (B, H)
    a_c = query.T @ dlin_b  # (D, H)
    k_c = keys.reshape(-1, d).T @ dlin.reshape(-1, h)
    p_c = qk.reshape(-1, d).T @ dlin.reshape(-1, h)
    dqp = dlin @ w_p.T  # (B, L, D)
    dq = dlin_b @ w_q.T + (dqp * keys).sum(dim=1)
    dk = dlin @ w_k.T + dqp * query[:, None, :] + s[:, :, None] * gp[:, None, :]
    dw1 = torch.cat([a_c, a_c - k_c, k_c, p_c], dim=0)
    return dq, dk, dw1, db1, dw2, dalpha


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _products(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """``a @ b`` taken as ``products`` says: ``"fp32"``, ``"3xtf32"`` (each
    operand split into TF32 hi and lo parts, ``hi·hi + hi·lo + lo·hi`` summed
    in fp32, as the CUDA kernels' tensor-core products) or ``"1xtf32"`` (one
    product of the TF32-rounded operands)."""
    if products == "fp32":
        return a @ b
    ah, bh = round_tf32(a), round_tf32(b)
    if products == "1xtf32":
        return ah @ bh
    if products == "3xtf32":
        return ah @ bh + (ah @ round_tf32(b - bh) + round_tf32(a - ah) @ bh)
    raise ValueError(f"products must be fp32, 3xtf32 or 1xtf32, not {products!r}")


def din_attention_unfolded(
    query, keys, mask, w1, b1, w2, alpha=None, products: str = "fp32"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``din_attention_plain``'s function with lin as one product over the
    shared weight ``W = [w_k; w_p]`` (2D, H), taken as ``products`` says
    (``_products``); the CUDA kernel takes it a row at a time through
    ``W_eff = w_k + diag(q) w_p`` (``X·W = K·W_eff``)::

        X_l = [k_l, q∘k_l],  lin = X·W + (q·w_q + b1)
        s = where(mask != 0, PReLU(lin)·w2, 0),  pooled = Σ_l s_l k_l (fp32)

    It is the kernel's arithmetic on the CPU, for the tests and for
    ``chip_smoke.py``'s broken single-TF32 version; no path runs it."""
    b, l, d = keys.shape
    h = w1.shape[1]
    w_q = w1[0:d] + w1[d : 2 * d]
    w = torch.cat([w1[2 * d : 3 * d] - w1[d : 2 * d], w1[3 * d : 4 * d]])  # (2D, H)
    x = torch.cat([keys, query[:, None, :] * keys], dim=-1).reshape(b * l, 2 * d)
    lin = _products(x, w, products).reshape(b, l, h) + (query @ w_q + b1)[:, None, :]
    hidden = lin.clamp_min(0.0)
    if alpha is not None:
        hidden = hidden + alpha * lin.clamp_max(0.0)
    scores = torch.where(mask != 0, hidden @ w2, 0.0)
    return torch.einsum("bl,bld->bd", scores, keys), scores


def din_attention_bwd_unfolded(
    query, keys, mask, w1, b1, w2, alpha, gp, gs, products: str = "fp32"
) -> Tuple[torch.Tensor, ...]:
    """``din_attention_bwd_plain``'s function unfolded so that its three
    products share one weight ``W = [w_k; w_p]`` (2D, H), the products taken
    as ``products`` says (``_products``: ``"fp32"``, ``"3xtf32"`` or
    ``"1xtf32"``). The kernel takes the same products a row at a time
    through ``W_eff = w_k + diag(q) w_p`` (``X·W = K·W_eff``)::

        X_l = [k_l, q∘k_l],  lin = X·W + (q·w_q + b1),  Y = dlin·Wᵀ
        dkeys = Y[:, :D] + Y[:, D:]∘q + s⊗gp,  dq = dlin_b·w_qᵀ + Σ_l Y[l, D:]∘k_l
        [k_c; p_c] = Σ Xᵀ·dlin,  a_c = Σ q ⊗ dlin_b

    It is the kernel's arithmetic on the CPU, for the tests and for
    ``chip_smoke.py``'s broken single-TF32 version; no path runs it."""
    b, l, d = keys.shape
    h = w1.shape[1]
    w_q = w1[0:d] + w1[d : 2 * d]
    w = torch.cat([w1[2 * d : 3 * d] - w1[d : 2 * d], w1[3 * d : 4 * d]])  # (2D, H)
    x = torch.cat([keys, query[:, None, :] * keys], dim=-1).reshape(b * l, 2 * d)
    lin = _products(x, w, products).reshape(b, l, h) + (query @ w_q + b1)[:, None, :]
    neg = lin.clamp_max(0.0)
    hval = lin.clamp_min(0.0) + alpha * neg
    s = (hval @ w2) * mask
    g = (gs + (gp[:, None, :] * keys).sum(dim=-1)) * mask
    dh = g[:, :, None] * w2
    dlin = dh * ((lin > 0).to(lin.dtype) + alpha * (lin < 0).to(lin.dtype))
    y = _products(dlin.reshape(b * l, h), w.T, products).reshape(b, l, 2 * d)
    dlin_b = dlin.sum(dim=1)
    dk = y[..., :d] + y[..., d:] * query[:, None, :] + s[:, :, None] * gp[:, None, :]
    dq = dlin_b @ w_q.T + (y[..., d:] * keys).sum(dim=1)
    kp = _products(x.T, dlin.reshape(b * l, h), products)  # (2D, H): [k_c; p_c]
    a_c = query.T @ dlin_b
    dw1 = torch.cat([a_c, a_c - kp[:d], kp[:d], kp[d:]], dim=0)
    return (
        dq, dk, dw1, dlin.reshape(-1, h).sum(dim=0), (g[:, :, None] * hval).reshape(-1, h).sum(dim=0),
        (dh * neg).reshape(-1, h).sum(dim=0),
    )


def din_attention_bwd_fused(
    query: torch.Tensor,
    keys: torch.Tensor,
    mask: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    alpha: torch.Tensor,
    gp: torch.Tensor,
    gs: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """DIN attention backward: ``(dq (B, D), dkeys (B, L, D), dw1 (4D, H),
    db1 (H,), dw2 (H,), dalpha (H,))``, fp32.

    CPU tensors take ``din_attention_bwd_plain``. CUDA tensors launch the
    passes of ``csrc/din_attention_bwd.cu``: each row's live 16-step tiles
    (up to its last step with a nonzero mask), a cut of the rows into
    contiguous ranges of even work, one a warp, then the main pass, whose
    warps work their rows tile by tile with the three products over the
    row's ``W_eff = w_k + diag(q) w_p`` on the tensor cores in 3xTF32
    (``din_attention_bwd_unfolded`` is the same function in the unfolded
    form, on the CPU); dq, dkeys and one partial of the parameter gradients
    per block go to memory (``torch.empty`` scratch), and a last pass adds
    the partials in a fixed order, so the gradients are the same bits from
    run to run. It takes fp32 on one device, D in ``DIN_ATTENTION_DIMS``,
    any L, keys on a 16-byte boundary and H up to ``DIN_BWD_MAX_H`` whose
    weights fit one block's shared memory, and raises on anything else.
    ``alpha`` is required: zeros mean relu."""
    if keys.device.type == "cpu":
        return din_attention_bwd_plain(query, keys, mask, w1, b1, w2, alpha, gp, gs)
    _refuse_grad("din_attention_bwd", query, keys, w1, b1, w2, alpha, gp, gs)
    _require_cuda("din_attention_bwd", keys)
    b, l, d = keys.shape
    h = w1.shape[1]
    dev = keys.device
    mask = mask.to(torch.float32)
    _require_cuda_f32(
        "din_attention_bwd", dev, query=query, keys=keys, mask=mask, w1=w1, b1=b1, w2=w2,
        alpha=alpha, gp=gp, gs=gs,
    )
    if (
        query.shape != (b, d) or mask.shape != (b, l) or w1.shape != (4 * d, h)
        or b1.shape != (h,) or w2.shape != (h,) or alpha.shape != (h,)
        or gp.shape != (b, d) or gs.shape != (b, l)
    ):
        raise ValueError(
            "din_attention_bwd: shapes do not agree: query "
            f"{tuple(query.shape)}, keys {tuple(keys.shape)}, mask {tuple(mask.shape)}, "
            f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"alpha {tuple(alpha.shape)}, gp {tuple(gp.shape)}, gs {tuple(gs.shape)}"
        )
    if d not in DIN_ATTENTION_DIMS:
        raise ValueError(f"din_attention_bwd: key width {d} not in {DIN_ATTENTION_DIMS}")
    if h > DIN_BWD_MAX_H:
        raise ValueError(f"din_attention_bwd: hidden width {h} above {DIN_BWD_MAX_H}, the widest built")
    lib = _library("din_attention_bwd")
    smem = lib.din_attention_bwd_smem_bytes(d, h)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"din_attention_bwd: D={d}, H={h} needs {smem} bytes of shared "
            f"memory per block, more than {MAX_SMEM_BYTES}"
        )
    f32 = dict(device=dev, dtype=torch.float32)
    dq = torch.empty(b, d, **f32)
    dk = torch.empty(b, l, d, **f32)
    dw1 = torch.empty(4 * d, h, **f32)
    db1, dw2, dalpha = (torch.empty(h, **f32) for _ in range(3))
    if b == 0 or l == 0:
        return dq.zero_(), dk, dw1.zero_(), db1.zero_(), dw2.zero_(), dalpha.zero_()
    args = [t.contiguous() for t in (query, keys, mask, w1, b1, w2, alpha, gp, gs)]
    if args[1].data_ptr() % 16:
        raise ValueError(
            f"din_attention_bwd: keys must start on a 16-byte boundary (storage offset "
            f"{keys.storage_offset()} floats); pass keys.clone()"
        )
    with torch.cuda.device(dev):
        blocks = lib.din_attention_bwd_blocks(b, l, d, h)
        if blocks < 1:
            _check_launch(lib, -blocks, "din_attention_bwd (occupancy query)")
            raise RuntimeError(f"din_attention_bwd: occupancy query gave {blocks} blocks")
        # one partial of (dw1's three D x H blocks, db1, dw2, dalpha) per block
        partials = torch.empty(blocks * (3 * d * h + 3 * h), **f32)
        # each row's live 16-step tiles, and each warp's first row (8 a block)
        tiles = torch.empty(b, device=dev, dtype=torch.int32)
        starts = torch.empty(8 * blocks + 1, device=dev, dtype=torch.int32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.din_attention_backward(
            *[t.data_ptr() for t in args],
            dq.data_ptr(), dk.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            dalpha.data_ptr(), partials.data_ptr(), tiles.data_ptr(), starts.data_ptr(),
            b, l, d, h, blocks, stream,
        )
    _check_launch(lib, err, "din_attention_bwd")
    din_attention_bwd_fused.launches += 1
    return dq, dk, dw1, db1, dw2, dalpha


din_attention_bwd_fused.launches = 0


class DinAttention(torch.autograd.Function):
    """DIN target attention with a backward: ``din_attention_fused`` forward,
    ``din_attention_bwd_fused`` backward (the kernels on the card, the plain
    versions on the CPU), as ``jax.custom_vjp`` pairs them in the JAX package
    (``_din_fwd``/``_din_bwd``, ``tpurec/ops/pallas/kernels.py:545-573``).
    Inputs are fp32; ``alpha=None`` means relu and then gets no gradient;
    the mask gets none."""

    @staticmethod
    def forward(ctx, query, keys, mask, w1, b1, w2, alpha=None):
        pooled, scores = din_attention_fused(query, keys, mask, w1, b1, w2, alpha)
        ctx.had_alpha = alpha is not None
        ctx.save_for_backward(query, keys, mask, w1, b1, w2, alpha)
        return pooled, scores

    @staticmethod
    def backward(ctx, gp, gs):
        query, keys, mask, w1, b1, w2, alpha = ctx.saved_tensors
        if alpha is None:
            alpha = w1.new_zeros(w1.shape[1])
        mask = mask.to(query.dtype)
        gp, gs = (g.to(query.dtype).contiguous() for g in (gp, gs))
        dq, dk, dw1, db1, dw2, dalpha = din_attention_bwd_fused(
            query, keys, mask, w1, b1, w2, alpha, gp, gs
        )
        return dq, dk, None, dw1, db1, dw2, (dalpha if ctx.had_alpha else None)


# --------------------------------------------------------------------------
# FM second-order cross term
def fm_second_order_plain(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) → (B,): 0.5·Σ_d[(Σ_f e)² − Σ_f e²], as
    ``fm_second_order_reference``."""
    sum_sq = torch.square(emb.sum(dim=1))
    sq_sum = torch.square(emb).sum(dim=1)
    return 0.5 * (sum_sq - sq_sum).sum(dim=-1)


@functools.cache
def _fm_triton_kernel():
    """The Triton FM kernel, defined at first use (``triton`` is imported
    here, never at module import, so the CPU tests import this module).

    Replaces tpurec/ops/pallas/kernels.py:fm_second_order_fused (_fm_kernel).
    Bound: a pure streaming reduction — B·F·D·4 bytes read once (27 MB at
    B=8192, F=26, D=32: ~8 us at 3.35 TB/s), ~3 flops a byte loaded. Design:
    one program per BLOCK_B rows loads the whole (BLOCK_B, F, D) tile at once
    (F and D padded to powers of two with masked loads, so every load of a
    program is in flight together), reduces over fields in registers and
    writes one fp32 per row. Nothing but the input and the (B,) output
    touches device memory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE_DIR))
    import triton
    import triton.language as tl

    @triton.jit
    def fm_kernel(
        emb_ptr, out_ptr, B, F, D,
        BLOCK_B: tl.constexpr, BLOCK_F: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        r3 = rows.to(tl.int64)[:, None, None]
        f3 = tl.arange(0, BLOCK_F)[None, :, None]
        d3 = tl.arange(0, BLOCK_D)[None, None, :]
        valid = (r3 < B) & (f3 < F) & (d3 < D)
        e = tl.load(emb_ptr + r3 * (F * D) + f3 * D + d3, mask=valid, other=0.0)
        total = tl.sum(e, axis=1)  # (BLOCK_B, BLOCK_D)
        cross = total * total - tl.sum(e * e, axis=1)
        tl.store(out_ptr + rows, 0.5 * tl.sum(cross, axis=1), mask=rows < B)

    return triton, fm_kernel


FM_MAX_TILE = 16_384  # largest padded F·D one program reduces


def fm_second_order_fused(emb: torch.Tensor) -> torch.Tensor:
    """FM cross term, (B, F, D) fp32 → (B,) fp32.

    CPU tensors take ``fm_second_order_plain``; CUDA tensors launch the Triton
    kernel, and anything it does not take (not fp32, not 3-D, padded F·D
    above ``FM_MAX_TILE``) raises. It records no backward: on CUDA it raises
    under grad mode when ``emb`` requires grad (training takes the plain
    math, ``ops.interactions.fm_second_order``)."""
    if emb.device.type == "cpu":
        return fm_second_order_plain(emb)
    _refuse_grad("fm_second_order", emb)
    _require_cuda("fm_second_order", emb)
    if emb.dim() != 3:
        raise ValueError(f"fm_second_order: expected (B, F, D), got {tuple(emb.shape)}")
    _require_cuda_f32("fm_second_order", emb.device, emb=emb)
    b, f, d = emb.shape
    block_f, block_d = _next_pow2(f), _next_pow2(d)
    if block_f * block_d > FM_MAX_TILE:
        raise ValueError(
            f"fm_second_order: F={f}, D={d} pad to {block_f}x{block_d}, "
            f"above the {FM_MAX_TILE}-element tile"
        )
    out = torch.empty(b, device=emb.device, dtype=torch.float32)
    if b == 0:
        return out
    block_b = max(1, min(8, FM_MAX_TILE // 2 // (block_f * block_d)))
    triton, kernel = _fm_triton_kernel()
    with torch.cuda.device(emb.device):
        kernel[(triton.cdiv(b, block_b),)](
            emb.contiguous(), out, b, f, d,
            BLOCK_B=block_b, BLOCK_F=block_f, BLOCK_D=block_d, num_warps=4,
        )
    fm_second_order_fused.launches += 1
    return out


fm_second_order_fused.launches = 0


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


# --------------------------------------------------------------------------
# DCN vector-cross stack
def cross_network_plain(
    x0: torch.Tensor,  # (B, D)
    weights: torch.Tensor,  # (L, D)
    biases: torch.Tensor,  # (L, D)
) -> torch.Tensor:
    """x_{l+1} = x0·(x_l·w_l) + b_l + x_l over the L layers, as
    ``cross_network_reference``: each layer a round trip of (B, D)."""
    x = x0
    for w, b in zip(weights, biases):
        x = x0 * (x @ w)[:, None] + b + x
    return x


@functools.cache
def _cross_triton_kernel():
    """The Triton DCN cross kernel, defined at first use (``triton`` is
    imported here, never at module import).

    Replaces tpurec/ops/pallas/kernels.py:cross_network_stack (_cross_kernel).
    Bound: bytes — x0 read once and x written once, B·D·4 bytes each (27 MB
    at B=8192, D=416: ~8 us at 3.35 TB/s), against ~4 flops an element a
    layer. Design: one program per BLOCK_B rows holds the whole rows of x0
    and x (D padded to a power of two, masked) in registers through all L
    layers: a layer is one row reduction (x·w_l) and one elementwise update,
    with w_l and b_l read from L2. Nothing but x0 and the output touches
    device memory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE_DIR))
    import triton
    import triton.language as tl

    @triton.jit
    def cross_kernel(
        x0_ptr, w_ptr, b_ptr, out_ptr, B, D, L,
        BLOCK_B: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        cols = tl.arange(0, BLOCK_D)
        r2 = rows.to(tl.int64)[:, None]
        c2 = cols[None, :]
        valid = (r2 < B) & (c2 < D)
        x0 = tl.load(x0_ptr + r2 * D + c2, mask=valid, other=0.0)
        x = x0
        for layer in range(L):
            w = tl.load(w_ptr + layer * D + cols, mask=cols < D, other=0.0)
            bias = tl.load(b_ptr + layer * D + cols, mask=cols < D, other=0.0)
            xw = tl.sum(x * w[None, :], axis=1)
            x = x0 * xw[:, None] + bias[None, :] + x
        tl.store(out_ptr + r2 * D + c2, x, mask=valid)

    return triton, cross_kernel


CROSS_MAX_D = 8192  # largest padded D one program holds


def cross_network_fused(
    x0: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor
) -> torch.Tensor:
    """Every DCN vector-cross layer at once: x0 (B, D), weights and biases
    (L, D), fp32 → (B, D) fp32.

    CPU tensors take ``cross_network_plain``; CUDA tensors launch the Triton
    kernel, and anything it does not take (not fp32, shapes that disagree,
    padded D above ``CROSS_MAX_D``) raises. It records no backward: on CUDA it
    raises under grad mode when an input requires grad (training takes the
    plain math, ``ops.interactions.CrossNetwork``)."""
    if x0.device.type == "cpu":
        return cross_network_plain(x0, weights, biases)
    _refuse_grad("cross_network", x0, weights, biases)
    _require_cuda("cross_network", x0)
    _require_cuda_f32("cross_network", x0.device, x0=x0, weights=weights, biases=biases)
    if x0.dim() != 2 or weights.dim() != 2 or weights.shape[1] != x0.shape[1] or (
        biases.shape != weights.shape
    ):
        raise ValueError(
            f"cross_network: shapes do not agree: x0 {tuple(x0.shape)}, weights "
            f"{tuple(weights.shape)}, biases {tuple(biases.shape)}"
        )
    b, d = x0.shape
    block_d = _next_pow2(d)
    if block_d > CROSS_MAX_D:
        raise ValueError(f"cross_network: D={d} pads to {block_d}, above {CROSS_MAX_D}")
    out = torch.empty(b, d, device=x0.device, dtype=torch.float32)
    if b == 0:
        return out
    block_b = max(1, min(16, 4096 // block_d))
    triton, kernel = _cross_triton_kernel()
    with torch.cuda.device(x0.device):
        kernel[(triton.cdiv(b, block_b),)](
            x0.contiguous(), weights.contiguous(), biases.contiguous(), out, b, d,
            weights.shape[0], BLOCK_B=block_b, BLOCK_D=block_d,
            num_warps=4 if block_b * block_d <= 4096 else 8,
        )
    cross_network_fused.launches += 1
    return out


cross_network_fused.launches = 0


# --------------------------------------------------------------------------
# CIN (xDeepFM compressed interaction network)
def cin_plain(emb: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every CIN level, as ``cin_reference``: z = outer(x_l, e) over fields,
    materialised as (B, H·F, D), compressed by W_l (H·F, S_l); returns the
    concatenated sums over d, (B, ΣS_l)."""
    b, f, d = emb.shape
    x = emb
    outs = []
    for w in weights:
        h = x.shape[1]
        z = torch.einsum("bhd,bfd->bhfd", x, emb).reshape(b, h * f, d)
        x = torch.einsum("bpd,ps->bsd", z, w)
        outs.append(x.sum(dim=-1))
    return torch.cat(outs, dim=-1)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32's 10-bit mantissa (the 13 low bits cleared): what
    the tensor cores read of an fp32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def cin_products(
    emb: torch.Tensor, weights: Sequence[torch.Tensor], products: str = "fp32"
) -> torch.Tensor:
    """``cin_plain``'s function in the CUDA kernel's order: over the rows
    m = (b, d), each level contracts H first for each field f,
    C_f = x_l · W_l[h·F + f, :], then adds e[:, f] · C_f for f = 0..F−1.
    The products of C_f are taken as ``products`` says: ``"fp32"``,
    ``"3xtf32"`` (as the kernel's tensor cores: each operand v read as
    hi = trunc(v) and lo = trunc(v − trunc(v)), ``hi·hi + hi·lo + lo·hi``
    summed in fp32) or ``"1xtf32"`` (``hi·hi`` alone). It is the kernel's
    arithmetic on the CPU, for the tests and for ``chip_smoke.py``'s broken
    single-TF32 version; no path runs it."""
    if products not in ("fp32", "3xtf32", "1xtf32"):
        raise ValueError(f"products must be fp32, 3xtf32 or 1xtf32, not {products!r}")

    def mm(a, b):
        if products == "fp32":
            return a @ b
        ah, bh = trunc_tf32(a), trunc_tf32(b)
        if products == "1xtf32":
            return ah @ bh
        return ah @ bh + (ah @ trunc_tf32(b - bh) + trunc_tf32(a - ah) @ bh)

    b, f, d = emb.shape
    e = emb.transpose(1, 2).reshape(b * d, f)
    x, outs = e, []
    for w in weights:
        wf = w.reshape(x.shape[1], f, w.shape[1])
        acc = torch.zeros(b * d, w.shape[1], dtype=emb.dtype, device=emb.device)
        for i in range(f):
            acc = acc + e[:, i : i + 1] * mm(x, wf[:, i])
        x = acc
        outs.append(acc.reshape(b, d, -1).sum(dim=1))
    return torch.cat(outs, dim=-1)


CIN_MAX_LEVELS = 8  # levels the CUDA kernel takes in one launch
# (device index, F, D, largest S) -> blocks of the kernel an SM holds
_CIN_BLOCKS: Dict[Tuple[int, int, int, int], int] = {}


def _cin_blocks(lib: ctypes.CDLL, device: torch.device, f: int, d: int, sizes: Sequence[int]) -> int:
    """The kernel's launch configuration for a shape on a device, found once
    (shared memory, the card's shared-memory attribute, the occupancy query)
    and then read from a dict. Raises ValueError on a shape whose shared
    memory does not fit one block."""
    key = (device.index, f, d, max(sizes))
    blocks = _CIN_BLOCKS.get(key)
    if blocks is None:
        smem = lib.cin_smem_bytes(f, d, max(sizes))
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"cin: F={f}, D={d}, level sizes {list(sizes)} need {smem} bytes of shared memory "
                f"per block, more than {MAX_SMEM_BYTES}"
            )
        with torch.cuda.device(device):
            blocks = lib.cin_blocks_per_sm(f, d, max(sizes))
        if blocks < 1:
            _check_launch(lib, -blocks, "cin (occupancy query)")
            raise RuntimeError(f"cin: no block of F={f}, D={d}, level sizes {list(sizes)} fits an SM")
        _CIN_BLOCKS[key] = blocks
    return blocks


def cin_fused(emb: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every CIN level at once: emb (B, F, D) and one W_l (H_l·F, S_l) a
    level (H_0 = F, H_{l+1} = S_l), fp32 → (B, ΣS_l) fp32.

    CPU tensors take ``cin_plain``; CUDA tensors launch the kernel of
    ``csrc/cin.cu``, which never materialises the (B, H·F, D) products: it
    contracts H first for each field on the tensor cores (``wgmma``) in
    3xTF32 and sums over the fields in fp32 (``cin_products`` is its
    arithmetic); shapes whose shared memory it cannot hold (level sizes
    above 136 at F=26, D ≤ 128) run the same source's fp32-FMA kernel. It
    takes any F, D and level sizes (not only multiples of 128), fp32 on one
    device, at most ``CIN_MAX_LEVELS`` levels and shapes whose shared
    memory fits one block of either kernel, and raises on anything else. The
    same bits on every call. It records no backward: on CUDA it raises
    under grad mode when an input requires grad."""
    weights = list(weights)
    if emb.device.type == "cpu":
        return cin_plain(emb, weights)
    _refuse_grad("cin", emb, *weights)
    _require_cuda("cin", emb)
    _require_cuda_f32("cin", emb.device, emb=emb, **{f"w{i}": w for i, w in enumerate(weights)})
    if emb.dim() != 3:
        raise ValueError(f"cin: expected emb (B, F, D), got {tuple(emb.shape)}")
    b, f, d = emb.shape
    if not 1 <= len(weights) <= CIN_MAX_LEVELS:
        raise ValueError(f"cin: {len(weights)} levels, the kernel takes 1 to {CIN_MAX_LEVELS}")
    h = f
    for i, w in enumerate(weights):
        if w.dim() != 2 or w.shape[0] != h * f or w.shape[1] < 1:
            raise ValueError(f"cin: level {i} weight {tuple(w.shape)}, expected ({h * f}, S)")
        h = w.shape[1]
    sizes = [int(w.shape[1]) for w in weights]
    lib = _library("cin")
    if f and d:
        _cin_blocks(lib, emb.device, f, d, sizes)
    out = torch.empty(b, sum(sizes), device=emb.device, dtype=torch.float32)
    if b == 0 or f == 0 or d == 0:
        return out.zero_()
    emb = emb.contiguous()
    weights = [w.contiguous() for w in weights]
    c_weights = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    c_sizes = (ctypes.c_int * len(sizes))(*sizes)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.cin_forward(
            emb.data_ptr(), c_weights, c_sizes, len(sizes), out.data_ptr(), b, f, d, stream
        )
    _check_launch(lib, err, "cin")
    cin_fused.launches += 1
    return out


cin_fused.launches = 0


# --------------------------------------------------------------------------
# SENet reweighting + 'all'-mode bilinear pairs (FiBiNET)
def senet_bilinear_plain(
    emb: torch.Tensor,  # (B, F, D)
    w1: torch.Tensor,  # (F, R) squeeze
    w2: torch.Tensor,  # (R, F) excite
    wb: torch.Tensor,  # (D, D) shared bilinear map
    b1: Optional[torch.Tensor] = None,  # (R,)
    b2: Optional[torch.Tensor] = None,  # (F,)
) -> torch.Tensor:
    """SENet reweighting (mean → relu(·W1+b1) → relu(·W2+b2)) then
    p_ij = (v_i·Wb)∘v_j for i<j, as ``senet_bilinear_reference``: (B, P, D),
    pairs in ``np.triu_indices`` order."""
    a = emb.mean(dim=-1) @ w1
    if b1 is not None:
        a = a + b1
    a = a.clamp_min(0.0) @ w2
    if b2 is not None:
        a = a + b2
    v = emb * a.clamp_min(0.0)[..., None]
    left = torch.einsum("bfd,de->bfe", v, wb)
    iu, ju = torch.triu_indices(emb.shape[1], emb.shape[1], offset=1, device=emb.device)
    return left[:, iu, :] * v[:, ju, :]


def senet_bilinear_fused(
    emb: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    wb: torch.Tensor,
    b1: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SENet → 'all'-mode bilinear pairs: emb (B, F, D), w1 (F, R), w2
    (R, F), wb (D, D), b1 (R,), b2 (F,), fp32 → (B, F(F−1)/2, D) fp32.

    CPU tensors take ``senet_bilinear_plain``; CUDA tensors launch the kernel
    of ``csrc/senet_bilinear.cu``, which keeps v and v·Wb in shared memory and
    writes each output element once. A missing b1 or b2 means zeros. It takes
    fp32 on one device and shapes whose shared memory fits one block, and
    raises on anything else. It records no backward: on CUDA it raises under
    grad mode when an input requires grad."""
    if emb.device.type == "cpu":
        return senet_bilinear_plain(emb, w1, w2, wb, b1, b2)
    _refuse_grad("senet_bilinear", emb, w1, w2, wb, b1, b2)
    _require_cuda("senet_bilinear", emb)
    if emb.dim() != 3:
        raise ValueError(f"senet_bilinear: expected emb (B, F, D), got {tuple(emb.shape)}")
    b, f, d = emb.shape
    r = w1.shape[-1]
    dev = emb.device
    if b1 is None:
        b1 = torch.zeros(r, device=dev, dtype=torch.float32)
    if b2 is None:
        b2 = torch.zeros(f, device=dev, dtype=torch.float32)
    _require_cuda_f32("senet_bilinear", dev, emb=emb, w1=w1, w2=w2, wb=wb, b1=b1, b2=b2)
    if (
        w1.shape != (f, r) or w2.shape != (r, f) or wb.shape != (d, d)
        or b1.shape != (r,) or b2.shape != (f,)
    ):
        raise ValueError(
            f"senet_bilinear: shapes do not agree: emb {tuple(emb.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, wb {tuple(wb.shape)}, b1 "
            f"{tuple(b1.shape)}, b2 {tuple(b2.shape)}"
        )
    p = f * (f - 1) // 2
    lib = _library("senet_bilinear")
    smem = lib.senet_bilinear_smem_bytes(f, d, r)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"senet_bilinear: F={f}, D={d}, R={r} need {smem} bytes of shared memory per "
            f"block, more than {MAX_SMEM_BYTES}"
        )
    out = torch.empty(b, p, d, device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    args = [t.contiguous() for t in (emb, w1, b1, w2, b2, wb)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.senet_bilinear_forward(
            *[t.data_ptr() for t in args], out.data_ptr(), b, f, d, r, stream
        )
    _check_launch(lib, err, "senet_bilinear")
    senet_bilinear_fused.launches += 1
    return out


senet_bilinear_fused.launches = 0


# --------------------------------------------------------------------------
# capsule dynamic routing ('shared' bilinear map, MIND)
def capsule_routing_plain(
    behavior: torch.Tensor,  # (B, L, D)
    mask: torch.Tensor,  # (B, L)
    s: torch.Tensor,  # (D, E)
    logits0: torch.Tensor,  # (B, K, L)
    num_iters: int = 3,
) -> torch.Tensor:
    """Every routing iteration, as ``capsule_routing_reference`` (fp32 in,
    fp32 out): masked softmax over capsules, z = w·u with u = behavior·S,
    squash, logits += caps·uᵀ. Every iteration but the last runs on a
    detached u, so autograd gives the gradients the JAX package's custom
    VJP gives. Returns (B, K, E)."""
    from tpurec_torch.ops.capsule import squash

    u_hat = torch.einsum("bld,de->ble", behavior, s)
    u_sg = u_hat.detach()
    live = mask.bool()[:, None, :]
    logits = logits0
    capsules = None
    for it in range(num_iters):
        w = torch.softmax(torch.where(live, logits, -1e9), dim=1) * mask[:, None, :]
        src = u_hat if it == num_iters - 1 else u_sg
        capsules = squash(torch.einsum("bkl,ble->bke", w, src))
        if it < num_iters - 1:
            logits = logits + torch.einsum("bke,ble->bkl", capsules, u_sg)
    return capsules


def capsule_routing_products(
    behavior, mask, s, logits0, num_iters: int = 3, products: str = "fp32"
) -> torch.Tensor:
    """``capsule_routing_plain``'s function with its products (u = x·S,
    z = w·u, caps·uᵀ) taken as ``products`` says: ``"fp32"``, ``"3xtf32"``
    (operands split into TF32 hi and lo, ``hi·hi + hi·lo + lo·hi`` summed in
    fp32, as the CUDA kernel's tensor-core product u = x·S) or ``"1xtf32"``
    (one product of the TF32-rounded operands). It is the kernel's
    arithmetic on the CPU, for the tests and for ``chip_smoke.py``'s broken
    single-TF32 version; no path runs it."""
    from tpurec_torch.ops.capsule import squash

    if products not in ("fp32", "3xtf32", "1xtf32"):
        raise ValueError(f"products must be fp32, 3xtf32 or 1xtf32, not {products!r}")

    def mm(a, b):
        if products == "fp32":
            return a @ b
        ah, bh = round_tf32(a), round_tf32(b)
        if products == "1xtf32":
            return ah @ bh
        return ah @ bh + (ah @ round_tf32(b - bh) + round_tf32(a - ah) @ bh)

    u = mm(behavior, s)  # (B, L, E)
    live = mask.bool()[:, None, :]
    logits = logits0
    capsules = None
    for it in range(num_iters):
        w = torch.softmax(torch.where(live, logits, -1e9), dim=1) * mask[:, None, :]
        capsules = squash(mm(w, u))
        if it < num_iters - 1:
            logits = logits + mm(capsules, u.transpose(1, 2))
    return capsules


def capsule_routing_bwd_plain(
    behavior: torch.Tensor,
    mask: torch.Tensor,
    s: torch.Tensor,
    logits0: torch.Tensor,
    g: torch.Tensor,  # (B, K, E) cotangent of the capsules
    num_iters: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dbehavior (B, L, D), dS (D, E), dlogits0 (B, K, L))``: autograd of
    ``capsule_routing_plain`` at ``g``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (behavior, s, logits0)]
        caps = capsule_routing_plain(leaves[0], mask, leaves[1], leaves[2], num_iters)
        db, ds, dl0 = torch.autograd.grad(caps, leaves, g)
    return db, ds, dl0


def _capsule_args(what: str, behavior, mask, s, logits0, num_iters: int):
    """Checks the shared shapes and types; returns (B, L, D, E, K, the
    contiguous fp32 mask, logits0 as a contiguous (K, L) slice per row and
    its batch stride in floats)."""
    _require_cuda(what, behavior)
    if behavior.dim() != 3 or s.dim() != 2 or logits0.dim() != 3:
        raise ValueError(
            f"{what}: expected behavior (B, L, D), S (D, E), logits0 (B, K, L); got "
            f"{tuple(behavior.shape)}, {tuple(s.shape)}, {tuple(logits0.shape)}"
        )
    b, l, d = behavior.shape
    e, k = s.shape[1], logits0.shape[1]
    mask = mask.to(torch.float32)
    _require_cuda_f32(what, behavior.device, behavior=behavior, mask=mask, s=s, logits0=logits0)
    if mask.shape != (b, l) or s.shape[0] != d or logits0.shape != (b, k, l):
        raise ValueError(
            f"{what}: shapes do not agree: behavior {tuple(behavior.shape)}, mask "
            f"{tuple(mask.shape)}, S {tuple(s.shape)}, logits0 {tuple(logits0.shape)}"
        )
    if num_iters < 1:
        raise ValueError(f"{what}: num_iters must be at least 1, got {num_iters}")
    if b > 0 and logits0.stride(0) == 0 and logits0[0].is_contiguous():
        stride = 0  # one (K, L) slice for every row, never materialised
    else:
        logits0 = logits0.contiguous()
        stride = k * l
    return b, l, d, e, k, mask.contiguous(), logits0, stride


CAPSULE_MAX_STEPS = 128  # the forward kernel: a warp a 16-step tile, 8 warps a block
CAPSULE_MAX_WIDTH = 128  # capsule columns, held by a warp in 8-column tiles
# (device index, L, D, E, K) -> blocks of the forward the card holds at once
_CAPSULE_BLOCKS: Dict[Tuple[int, int, int, int, int], int] = {}


def _capsule_blocks(lib: ctypes.CDLL, device: torch.device, l: int, d: int, e: int, k: int) -> int:
    """The forward's launch configuration for a shape on a device, found once
    (shared memory, the occupancy query) and then read from a dict: no host
    work beyond it on later calls, and no sync. Raises ValueError on a shape
    the kernel does not take."""
    key = (device.index, l, d, e, k)
    blocks = _CAPSULE_BLOCKS.get(key)
    if blocks is None:
        if l > CAPSULE_MAX_STEPS:
            raise ValueError(
                f"capsule_routing: L={l} steps, more than the {CAPSULE_MAX_STEPS} the kernel takes "
                "(a warp a 16-step tile, 8 warps a block)"
            )
        if e > CAPSULE_MAX_WIDTH:
            raise ValueError(
                f"capsule_routing: capsule width E={e}, more than the {CAPSULE_MAX_WIDTH} the kernel "
                "takes (a warp holds u for all E in registers)"
            )
        smem = lib.capsule_routing_smem_bytes(l, d, e, k)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"capsule_routing: L={l}, D={d}, E={e}, K={k} need {smem} bytes of shared memory "
                f"per block, more than {MAX_SMEM_BYTES}"
            )
        with torch.cuda.device(device):
            blocks = lib.capsule_routing_blocks(l, d, e, k)
        if blocks < 1:
            _check_launch(lib, -blocks, "capsule_routing (occupancy query)")
            raise RuntimeError(f"capsule_routing: no block of L={l}, D={d}, E={e}, K={k} fits an SM")
        _CAPSULE_BLOCKS[key] = blocks
    return blocks


def capsule_routing_fused(
    behavior: torch.Tensor,
    mask: torch.Tensor,
    s: torch.Tensor,
    logits0: torch.Tensor,
    num_iters: int = 3,
) -> torch.Tensor:
    """Dynamic routing, every iteration in one pass: behavior (B, L, D),
    mask (B, L), S (D, E), logits0 (B, K, L), fp32 → capsules (B, K, E) fp32.

    CPU tensors take ``capsule_routing_plain``. CUDA tensors launch the
    kernel of ``csrc/capsule_routing.cu``: a warp owns a 16-step tile of a
    row, computes u = behavior·S for it on the tensor cores in 3xTF32 and
    keeps u in registers through every iteration; tiles past the row's last
    step with a nonzero mask are skipped. logits0 may be a broadcast view
    (batch stride 0) of one (K, L) slice. It takes any B, D, K and
    ``num_iters`` ≥ 1 with L ≤ ``CAPSULE_MAX_STEPS`` and E ≤
    ``CAPSULE_MAX_WIDTH`` whose shared memory fits one block, fp32 on one
    device, and raises on anything else. The same bits on every call. It
    records no backward: on CUDA it raises under grad mode when an input
    requires grad (``CapsuleRouting`` is the differentiable form)."""
    if behavior.device.type == "cpu":
        return capsule_routing_plain(behavior, mask, s, logits0, num_iters)
    _refuse_grad("capsule_routing", behavior, s, logits0)
    b, l, d, e, k, mask, logits0, stride = _capsule_args(
        "capsule_routing", behavior, mask, s, logits0, num_iters
    )
    lib = _library("capsule_routing")
    blocks = _capsule_blocks(lib, behavior.device, l, d, e, k)
    out = torch.empty(b, k, e, device=behavior.device, dtype=torch.float32)
    if b == 0:
        return out
    behavior, s = behavior.contiguous(), s.contiguous()
    with torch.cuda.device(behavior.device):
        stream = torch.cuda.current_stream(behavior.device).cuda_stream
        err = lib.capsule_routing_forward(
            behavior.data_ptr(), mask.data_ptr(), s.data_ptr(), logits0.data_ptr(), stride,
            out.data_ptr(), b, l, d, e, k, num_iters, blocks, stream,
        )
    _check_launch(lib, err, "capsule_routing")
    capsule_routing_fused.launches += 1
    return out


capsule_routing_fused.launches = 0


def capsule_routing_bwd_fused(
    behavior: torch.Tensor,
    mask: torch.Tensor,
    s: torch.Tensor,
    logits0: torch.Tensor,
    g: torch.Tensor,
    num_iters: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing backward: ``(dbehavior (B, L, D), dS (D, E), dlogits0
    (B, K, L))``, fp32, for the forward's inputs and g (B, K, E).

    CPU tensors take ``capsule_routing_bwd_plain``. CUDA tensors launch the
    kernel of ``csrc/capsule_routing.cu``: it recomputes the forward, keeps
    each iteration's softmax, weights and z, and makes one reverse sweep;
    each block writes one partial of dS into a ``torch.empty`` scratch and a
    second pass adds the partials in a fixed order, so dS is the same bits
    from run to run. It takes what the forward takes and raises on anything
    else."""
    if behavior.device.type == "cpu":
        return capsule_routing_bwd_plain(behavior, mask, s, logits0, g, num_iters)
    _refuse_grad("capsule_routing_bwd", behavior, s, logits0, g)
    b, l, d, e, k, mask, logits0, stride = _capsule_args(
        "capsule_routing_bwd", behavior, mask, s, logits0, num_iters
    )
    _require_cuda_f32("capsule_routing_bwd", behavior.device, g=g)
    if g.shape != (b, k, e):
        raise ValueError(f"capsule_routing_bwd: g {tuple(g.shape)}, expected {(b, k, e)}")
    lib = _library("capsule_routing")
    smem = lib.capsule_routing_bwd_smem_bytes(l, d, e, k, num_iters)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"capsule_routing_bwd: L={l}, D={d}, E={e}, K={k}, {num_iters} iterations need "
            f"{smem} bytes of shared memory per block, more than {MAX_SMEM_BYTES}"
        )
    f32 = dict(device=behavior.device, dtype=torch.float32)
    db = torch.empty(b, l, d, **f32)
    ds = torch.empty(d, e, **f32)
    dl0 = torch.empty(b, k, l, **f32)
    if b == 0:
        return db, ds.zero_(), dl0
    behavior, s, g = behavior.contiguous(), s.contiguous(), g.contiguous()
    with torch.cuda.device(behavior.device):
        blocks = lib.capsule_routing_bwd_blocks(b, l, d, e, k, num_iters)
        if blocks < 1:
            _check_launch(lib, -blocks, "capsule_routing_bwd (occupancy query)")
            raise RuntimeError(f"capsule_routing_bwd: occupancy query gave {blocks} blocks")
        partials = torch.empty(blocks * d * e, **f32)
        stream = torch.cuda.current_stream(behavior.device).cuda_stream
        err = lib.capsule_routing_backward(
            behavior.data_ptr(), mask.data_ptr(), s.data_ptr(), logits0.data_ptr(), stride,
            g.data_ptr(), db.data_ptr(), ds.data_ptr(), dl0.data_ptr(), partials.data_ptr(),
            b, l, d, e, k, num_iters, blocks, stream,
        )
    _check_launch(lib, err, "capsule_routing_bwd")
    capsule_routing_bwd_fused.launches += 1
    return db, ds, dl0


capsule_routing_bwd_fused.launches = 0


class CapsuleRouting(torch.autograd.Function):
    """Dynamic routing with a backward: ``capsule_routing_fused`` forward,
    ``capsule_routing_bwd_fused`` backward (the kernels on the card, the
    plain versions on the CPU), as ``capsule_routing_fused.defvjp`` pairs
    them in the JAX package (``tpurec/ops/pallas/kernels.py:947-965``).
    Inputs are fp32; gradients go to behavior, S and logits0, none to the
    mask."""

    @staticmethod
    def forward(ctx, behavior, mask, s, logits0, num_iters=3):
        ctx.num_iters = num_iters
        ctx.save_for_backward(behavior, mask, s, logits0)
        return capsule_routing_fused(behavior, mask, s, logits0, num_iters)

    @staticmethod
    def backward(ctx, g):
        behavior, mask, s, logits0 = ctx.saved_tensors
        db, ds, dl0 = capsule_routing_bwd_fused(
            behavior, mask, s, logits0, g.to(torch.float32).contiguous(), ctx.num_iters
        )
        return db, None, ds, dl0, None


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0 (those of
    ``tpurec_torch.ops.embedding_update`` too)."""
    from tpurec_torch.ops import embedding_update

    din_attention_fused.launches = 0
    din_attention_bwd_fused.launches = 0
    fm_second_order_fused.launches = 0
    cross_network_fused.launches = 0
    cin_fused.launches = 0
    senet_bilinear_fused.launches = 0
    capsule_routing_fused.launches = 0
    capsule_routing_bwd_fused.launches = 0
    embedding_update.fused_scatter_add.launches = 0
    embedding_update.gather_rows_sorted.launches = 0
