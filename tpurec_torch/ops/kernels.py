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
from typing import Dict, Iterable, Optional, Tuple

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
                lib.din_attention_forward.argtypes = (
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                )
                lib.din_attention_forward.restype = ctypes.c_int
            elif name == "din_attention_bwd":
                lib.din_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
                lib.din_attention_bwd_smem_bytes.restype = ctypes.c_size_t
                lib.din_attention_bwd_blocks.argtypes = [ctypes.c_int] * 4
                lib.din_attention_bwd_blocks.restype = ctypes.c_int
                lib.din_attention_backward.argtypes = (
                    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                )
                lib.din_attention_backward.restype = ctypes.c_int
            elif name == "embedding_update":
                lib.embedding_scatter_slice_rows.argtypes = []
                lib.embedding_scatter_slice_rows.restype = ctypes.c_int
                lib.embedding_fused_scatter_add.argtypes = [ctypes.c_void_p] * 5 + [
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
                ]
                lib.embedding_fused_scatter_add.restype = ctypes.c_int
                lib.embedding_gather_rows.argtypes = [ctypes.c_void_p] * 3 + [
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
                ]
                lib.embedding_gather_rows.restype = ctypes.c_int
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


DIN_ATTENTION_DIMS = (8, 16, 32, 64)  # key widths the CUDA kernel is built for


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

    CPU tensors take ``din_attention_plain``. CUDA tensors launch the kernel
    of ``csrc/din_attention.cu``, which never materialises the (B, L, 4D)
    features; it takes fp32 inputs on one device, D in
    ``DIN_ATTENTION_DIMS``, keys that start on a 16-byte boundary and shapes
    whose shared memory fits one block, and raises on anything else.
    ``alpha=None`` means relu (zero slopes). It records no backward: on CUDA
    it raises under grad mode when an input requires grad (``DinAttention``
    is the differentiable form)."""
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
    kernel of ``csrc/din_attention_bwd.cu``: one pass over the rows writes dq,
    dkeys and one partial of the parameter gradients per block into a
    ``torch.empty`` scratch, and a second pass adds the partials in a fixed
    order, so the gradients are the same bits from run to run. It takes what
    the forward kernel takes (fp32 on one device, D in ``DIN_ATTENTION_DIMS``,
    keys on a 16-byte boundary, shared memory that fits one block) and raises
    on anything else. ``alpha`` is required: zeros mean relu."""
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
    lib = _library("din_attention_bwd")
    smem = lib.din_attention_bwd_smem_bytes(l, d, h)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"din_attention_bwd: L={l}, D={d}, H={h} needs {smem} bytes of shared "
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.din_attention_backward(
            *[t.data_ptr() for t in args],
            dq.data_ptr(), dk.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            dalpha.data_ptr(), partials.data_ptr(),
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


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0 (those of
    ``tpurec_torch.ops.embedding_update`` too)."""
    from tpurec_torch.ops import embedding_update

    din_attention_fused.launches = 0
    din_attention_bwd_fused.launches = 0
    fm_second_order_fused.launches = 0
    embedding_update.fused_scatter_add.launches = 0
    embedding_update.gather_rows_sorted.launches = 0
