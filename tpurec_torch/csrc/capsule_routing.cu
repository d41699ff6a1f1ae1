// MIND's capsule dynamic routing ('shared' bilinear map), every iteration in
// one launch, and its backward, for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels tpurec/ops/pallas/kernels.py:779
// capsule_routing_fused (_capsule_kernel, :750-775) and :907
// capsule_routing_bwd_fused (_capsule_bwd_kernel, :816-904). Per batch row,
// with behavior x (L, D), mask m (L,), S (D, E) and logits0 (K, L):
//
//   u = x S                                            (L, E)
//   for it < iters:
//     w[k, l] = softmax_k(logits[k, l] - 1e9 (1 - m[l])) * m[l]
//     z = w u                                          (K, E)
//     caps = |z|^2 / (1 + |z|^2) * z / sqrt(|z|^2 + 1e-9)    (per capsule)
//     logits += caps u^T                               (not after the last)
//   out = caps of the last iteration                   (K, E)
//
// The backward (capsule_routing_bwd) recomputes the forward, keeping each
// iteration's p (the softmax before the mask), w and z, then makes one
// reverse sweep. As in the TPU kernel (the stop-gradient placement of
// capsule_routing_reference, :720-747), x and S get cotangents only through
// the last iteration's live z = w u; logits0 gets the whole softmax chain:
//   dz   = squash'(z_last)^T g,   du = w_last^T dz,   dw = dz u^T
//   dlog = softmax'(p_last)^T (dw * m)
//   for it = iters-2 .. 0: dcaps = dlog u, dz_i = squash'(z_it)^T dcaps,
//                          dlog += softmax'(p_it)^T ((dz_i u^T) * m)
//   dlogits0 = dlog,   dx = du S^T,   dS = sum over rows of x^T du.
//
// What bounds the forward on an H100 (data-sheet rates: 3.35 TB/s, 67
// TFLOP/s fp32 outside the tensor cores, 495 TFLOP/s TF32 on them). At the
// slice's shape (B=8192, L=64, D=E=64, K=4, 3 iterations, lengths L/4..L)
// a masked step needs no work (w = 0 there), so the function reads x at
// live steps (~84 MB) and does ~3.6 GFLOP, of which u = x S is ~2.7: in
// 3xTF32 (three TF32 multiply-adds per fp32 one) ~0.016 ms, the rest in
// fp32 ~0.014, so ~0.030 ms of operations against ~0.025 ms of bytes
// (chip_smoke.py counts both from its mask). On
// the card the kernel is neither: one row's work is a chain of small
// dependent steps (loads, u, then per iteration a softmax, z, the squash
// and the logit update, with the block's warps meeting in between), so
// what bounds it is the latency of that chain and how many rows an SM
// holds at once (registers and shared memory).
//
// The forward's design:
// - A warp owns a 16-step tile of a row, a block (up to 8 warps, L <= 128)
//   one row at a time; blocks walk the rows with a grid stride, as many as
//   the card holds, so S is read once a block. Tiles past the row's last
//   step with a nonzero mask are skipped; zero steps inside that range go
//   through the math (w = 0 there), so masks with holes stay exact.
// - S is put in shared memory once a block, split into TF32 hi and lo in
//   the B-fragment order of mma.sync m16n8k8 (16-byte loads, no bank
//   conflicts). u = x S runs on the tensor cores in 3xTF32 (hi.hi + hi.lo +
//   lo.hi, fp32 accumulation): one TF32 product misses the fp32 limits
//   several-fold, because the softmax and the squash amplify u's error
//   (capsule_routing_products in tpurec_torch/ops/kernels.py, which the
//   CPU tests run). The k order inside each 16-wide chunk of D is permuted
//   so that a lane's A fragments of two k-steps are one 16-byte load of x.
// - u stays in the mma accumulators (C layout: steps gid, gid + 8) for the
//   logit update, where a quad's lanes sum over their columns with two
//   shuffles; a transposed copy through shared memory gives each lane its
//   own columns at all 16 steps, so z = w u needs no reduction across
//   lanes. The routing is fp32 on the CUDA cores, a few capsules at a time.
// - The warps' z partials are added in warp order through a small double-
//   buffered shared array; warp k squashes capsule k (and k + W, ...). Two
//   block barriers an iteration, one in the last. No float atomics: the
//   same bits on every call.
// - Loads are issued before use: a block's first row's x (every tile, its
//   length not known yet), mask and logits0 go out with S's, one trip to
//   device memory; later rows' live x tiles and logits0 (cp.async) arrive
//   while the row before routes, their mask a row earlier still, so a
//   row's live tiles are known when its x is asked for.
// - The launch configuration (blocks the card holds for a shape) is found
//   once for each shape and device by the wrapper.
// logits0 may repeat one (K, L) slice for every row (batch stride 0), as the
// model's fixed routing init does.
//
// The backward (#8) on the tensor cores. du = w_last^T dz has rank K, so
// the two L-deep products of the gradient factor through K: dS = sum over
// rows of x^T du = (w_last x)^T dz and dx = du S^T = w_last^T (dz S^T).
// What bounds it on an H100: at the slice's shape the function reads x at
// live steps, g, the mask and logits0 and writes all of dbehavior and
// dlogits0 (~0.071 ms of bytes at 3.35 TB/s); its operations are the
// forward's again, the reverse sweep and the K-deep products, ~5.5 GFLOP
// at live steps: u = x S and dz S^T (~3.0) in 3xTF32 ~0.018 ms, the rest
// in fp32 ~0.038, so the bytes bound it (chip_smoke.py counts both from
// its mask). As in the forward, what holds the kernel is the row's chain
// of short dependent steps, with its block barriers, and the rows an SM
// holds (two blocks of ~107 KB of shared memory). The design:
// - The forward's layout: a warp a 16-step tile, a block one row at a
//   time, blocks walking the rows. Tiles past the row's last live step are
//   not computed; their dbehavior and dlogits0 rows are written as zeros,
//   which is what the plain version gives there. x of the steps past the
//   last live one arrives as zeros (cp.async's zero fill reads nothing),
//   so a non-finite value there reaches no output. Zero steps inside the
//   live range go through the math, so masks with holes stay exact.
// - The forward again with its parts (u = x S in 3xTF32 in the
//   accumulators, z = w u from u's transpose, the warps' partials added in
//   warp order), keeping each iteration's p at the warp's steps and z; for
//   K <= 4 a step's softmax stays in registers (~1.7 % faster at the
//   slice's shape than the shared-memory path kept for larger K).
// - dz = squash'(z_last)^T g by the warp that squashes capsule k. Then
//   each warp forms its tile's partial of w_last x (K x D) in fp32 from its
//   x tile, and the warps take dz S^T (K x D) in 16-column chunks on the
//   tensor cores in 3xTF32 (mma.sync m16n8k8; single TF32 misses the fp32
//   limits, capsule_routing_bwd_products in tpurec_torch/ops/kernels.py),
//   reading S's fragments transposed: dz S^T's columns are taken in a
//   permuted order (column gid of the n-tile pair (c, h) is d = 16 c + 4
//   (gid % 4) + 2 (gid / 4) + h), so that one 16-byte load holds S at (d,
//   e) for both n-tiles of a pair, and each group of 32 entries is stored
//   swizzled, so that these reads and u's hit distinct banks.
// - dx = w_last^T (dz S^T) at a warp's own steps and dS += (w_last x)^T dz
//   (w_last x the warps' partials added in warp order) are K deep, fp32 on
//   the CUDA cores, each element of the running dS owned by one thread in
//   shared memory. A live tile's dx rows are contiguous in device memory:
//   they go out from the warp's u stage as one bulk copy (the Tensor
//   Memory Accelerator), which costs the warp less than a store a row
//   (~2.3 % of the kernel's time at the slice's shape; a store an element
//   stays for D % 4 != 0 or dx off a 16-byte boundary). On the TPU the
//   grid runs in order and accumulates dS in place (:898-904); here each
//   block writes one partial into a scratch buffer the wrapper allocates
//   (torch.empty) and a second kernel adds the partials in block order. No
//   float atomics: the same bits on every call.
// - Then the reverse sweep for dlogits0 on u's fragments: dw = dz u^T with
//   the quads' shuffles as the forward's logit update, the softmax VJP a
//   step a lane, dcaps = dlog u as z = w u. The next row's x, logits0 and g
//   (cp.async) arrive meanwhile; its mask was read a row earlier.
// - The launch configuration (blocks the card holds for a shape, the
//   shared-memory attribute) is found once for each shape and device by
//   the wrapper; a launch queries nothing.
// Shapes the tensor-core kernel cannot hold (E > 128, L > 128, or more
// shared memory than a block has) take the port's first backward kernel,
// kept as capsule_routing_bwd_fma_kernel: a block keeps one row's x, u and
// du in shared memory with S beside them and runs each product as a
// register-tiled fp32 loop over every step; its row strides are odd, so
// walks along either dimension are free of bank conflicts. It sums dS the
// same way (a running dS a block, a partial each, the ordered second pass).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
constexpr float kNeg = -1e9f;
constexpr float kEps = 1e-9f;
constexpr int kMaxSmemBytes = 232448;  // Hopper's per-block limit (227 KB)

// an odd row stride: walks along a row or down a column hit distinct banks
__host__ __device__ inline int odd(int x) { return x | 1; }

// x = hi + lo, both TF32. hi is x rounded to nearest, ties away from zero
// (half a TF32 ulp added, the 13 low bits cleared: cvt.rna.tf32.f32's
// rounding in two integer operations); lo = x - hi is exact in fp32. The
// tensor cores read a TF32 operand's 19 high bits and ignore the 13 low
// ones, so lo gets the same rounding from the half ulp added alone.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32: the two small terms first, then the big one
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

struct Dims {
  int L, D, E, K, iters;
  int Dp, Ep;  // row strides of x (L, Dp) and of S, u, du, dS (., Ep)
};

__host__ __device__ inline Dims make_dims(int L, int D, int E, int K, int iters) {
  return Dims{L, D, E, K, iters, odd(D), odd(E)};
}

// Shared memory of the backward, in floats: S, x, u, du, dS; mask; per
// iteration p, w (K, L) and z (K, E); logits, dlog, dw (K, L); caps, dz,
// dcaps (K, E); sq, gz (K).
__host__ __device__ inline size_t bwd_floats(const Dims& d) {
  const size_t kl = static_cast<size_t>(d.K) * d.L, ke = static_cast<size_t>(d.K) * d.E;
  return 2 * static_cast<size_t>(d.D) * d.Ep + static_cast<size_t>(d.L) * d.Dp +
         2 * static_cast<size_t>(d.L) * d.Ep + d.L + d.iters * (2 * kl + ke) + 3 * kl + 3 * ke +
         2 * d.K;
}

// C (M x N) = [C +] A (M x Kd) B (Kd x N) over the block, A(m, k) =
// a[m * am + k * ak], B(k, n) = b[k * bk + n * bn], C(m, n) = c[m * cm + n *
// cn] (shared or device memory). A thread owns the TM x TN outputs m = tm +
// i * tiles_m, n = tn + j * tiles_n, so neighbouring threads own
// neighbouring columns; rows past M and columns past N read a valid element
// (clamped) and are not stored.
template <int TM, int TN>
__device__ void block_gemm(const float* a, int am, int ak, const float* b, int bk, int bn, float* c,
                           int cm, int cn, int M, int N, int Kd, bool accumulate) {
  const int tiles_m = (M + TM - 1) / TM;
  const int tiles_n = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < tiles_m * tiles_n; t += blockDim.x) {
    const int tm = t / tiles_n;
    const int tn = t - tm * tiles_n;
    const float* ap[TM];
    const float* bp[TN];
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ap[i] = a + min(tm + i * tiles_m, M - 1) * am;
#pragma unroll
    for (int j = 0; j < TN; ++j) bp[j] = b + min(tn + j * tiles_n, N - 1) * bn;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int m = tm + i * tiles_m, n = tn + j * tiles_n;
        acc[i][j] = (accumulate && m < M && n < N) ? c[m * cm + n * cn] : 0.f;
      }
    }
    for (int k = 0; k < Kd; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = ap[i][k * ak];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bp[j][k * bk];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int m = tm + i * tiles_m, n = tn + j * tiles_n;
        if (m < M && n < N) c[m * cm + n * cn] = acc[i][j];
      }
    }
  }
}

// out[k] = sum_e x[k, e] y[k, e] for the K rows of two (K, E) arrays: one
// warp a row, lanes over e, a shuffle reduction (the same order every call).
__device__ void row_dots(const float* x, const float* y, float* out, int K, int E) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = warp; k < K; k += kWarps) {
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s = fmaf(x[k * E + e], y[k * E + e], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[k] = s;
  }
}

// p[k, l] = softmax over k of logits[k, l] - 1e9 (1 - m[l]); w = p m[l]
__device__ void route_softmax(const float* logits, const float* mask, float* p, float* w, int K,
                              int L) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float m = mask[l];
    const float neg = kNeg * (1.f - m);
    float mx = logits[l] + neg;
    for (int k = 1; k < K; ++k) mx = fmaxf(mx, logits[k * L + l] + neg);
    float sum = 0.f;
    for (int k = 0; k < K; ++k) sum += expf(logits[k * L + l] + neg - mx);
    const float inv = 1.f / sum;
    for (int k = 0; k < K; ++k) {
      const float pk = expf(logits[k * L + l] + neg - mx) * inv;
      if (p != nullptr) p[k * L + l] = pk;
      w[k * L + l] = pk * m;
    }
  }
}

// caps = squash(z) per capsule, given sq[k] = |z_k|^2; to dst (K, E),
// contiguous, in shared or device memory
__device__ void squash_rows(const float* z, const float* sq, float* dst, int K, int E) {
  for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
    const float s = sq[i / E];
    dst[i] = (s / (1.f + s)) * z[i] * rsqrtf(s + kEps);
  }
}

// dz = squash'(z)^T gc, given sq[k] = |z_k|^2 and gz[k] = gc_k . z_k
// (tpurec/ops/pallas/kernels.py:854-862)
__device__ void squash_vjp_rows(const float* gc, const float* z, const float* sq, const float* gz,
                                float* dz, int K, int E) {
  for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
    const int k = i / E;
    const float s = sq[k];
    const float rs = rsqrtf(s + kEps);
    const float a = (s / (1.f + s)) * rs;
    const float ap = rs / (1.f + s) - a / (1.f + s) - a / (2.f * (s + kEps));
    dz[i] = a * gc[i] + 2.f * z[i] * ap * gz[k];
  }
}

// dlog (+)= softmax'(p)^T (dw m): dp = dw m[l]; p (dp - sum_k p dp)
// (tpurec/ops/pallas/kernels.py:864-867)
__device__ void softmax_vjp_cols(const float* dw, const float* p, const float* mask, float* dlog,
                                 int K, int L, bool accumulate) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const float m = mask[l];
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(p[k * L + l], dw[k * L + l] * m, s);
    for (int k = 0; k < K; ++k) {
      const float v = p[k * L + l] * (dw[k * L + l] * m - s);
      dlog[k * L + l] = accumulate ? dlog[k * L + l] + v : v;
    }
  }
}

// one row's x, mask and logits0 into shared memory
__device__ void load_row(const float* x, const float* mask, const float* l0, float* x_s,
                         float* mask_s, float* logit_s, const Dims& d) {
  for (int i = threadIdx.x; i < d.L * d.D; i += blockDim.x) {
    const int l = i / d.D;
    x_s[l * d.Dp + (i - l * d.D)] = __ldg(x + i);
  }
  for (int l = threadIdx.x; l < d.L; l += blockDim.x) mask_s[l] = __ldg(mask + l);
  for (int i = threadIdx.x; i < d.K * d.L; i += blockDim.x) logit_s[i] = __ldg(l0 + i);
}

__device__ void load_s(const float* s, float* s_s, const Dims& d) {
  for (int i = threadIdx.x; i < d.D * d.E; i += blockDim.x) {
    const int r = i / d.E;
    s_s[r * d.Ep + (i - r * d.E)] = __ldg(s + i);
  }
}

__global__ void __launch_bounds__(kThreads) capsule_routing_bwd_fma_kernel(
    const float* __restrict__ x,      // (B, L, D)
    const float* __restrict__ mask,   // (B, L)
    const float* __restrict__ s,      // (D, E)
    const float* __restrict__ l0,     // (B, K, L), batch stride l0_stride
    const float* __restrict__ g,      // (B, K, E)
    float* __restrict__ dx,           // (B, L, D)
    float* __restrict__ dl0,          // (B, K, L)
    float* __restrict__ partials,     // (gridDim.x, D, E)
    int B, int L, int D, int E, int K, int iters, long l0_stride) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = make_dims(L, D, E, K, iters);
  const int kl = K * L, ke = K * E;
  float* s_s = smem;                    // (D, Ep)
  float* ds_s = s_s + D * d.Ep;         // (D, Ep) this block's running dS
  float* x_s = ds_s + D * d.Ep;         // (L, Dp)
  float* u_s = x_s + L * d.Dp;          // (L, Ep)
  float* du_s = u_s + L * d.Ep;         // (L, Ep)
  float* mask_s = du_s + L * d.Ep;      // (L,)
  float* p_s = mask_s + L;              // (iters, K, L)
  float* w_s = p_s + iters * kl;        // (iters, K, L)
  float* z_s = w_s + iters * kl;        // (iters, K, E)
  float* logit_s = z_s + iters * ke;    // (K, L)
  float* dlog_s = logit_s + kl;         // (K, L)
  float* dw_s = dlog_s + kl;            // (K, L)
  float* caps_s = dw_s + kl;            // (K, E) caps, then g
  float* dz_s = caps_s + ke;            // (K, E)
  float* dcaps_s = dz_s + ke;           // (K, E)
  float* sq_s = dcaps_s + ke;           // (K,)
  float* gz_s = sq_s + K;               // (K,)

  load_s(s, s_s, d);
  for (int i = threadIdx.x; i < D * d.Ep; i += blockDim.x) ds_s[i] = 0.f;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    load_row(x + static_cast<size_t>(b) * L * D, mask + static_cast<size_t>(b) * L,
             l0 + b * l0_stride, x_s, mask_s, logit_s, d);
    __syncthreads();
    block_gemm<4, 4>(x_s, d.Dp, 1, s_s, d.Ep, 1, u_s, d.Ep, 1, L, E, D, false);
    __syncthreads();
    // the forward again, keeping p, w and z of every iteration
    for (int it = 0; it < iters; ++it) {
      float* p = p_s + it * kl;
      float* w = w_s + it * kl;
      float* z = z_s + it * ke;
      route_softmax(logit_s, mask_s, p, w, K, L);
      __syncthreads();
      block_gemm<1, 1>(w, L, 1, u_s, d.Ep, 1, z, E, 1, K, E, L, false);
      __syncthreads();
      if (it < iters - 1) {
        row_dots(z, z, sq_s, K, E);
        __syncthreads();
        squash_rows(z, sq_s, caps_s, K, E);
        __syncthreads();
        block_gemm<1, 1>(caps_s, E, 1, u_s, 1, d.Ep, logit_s, L, 1, K, L, E, true);
        __syncthreads();
      }
    }
    // the reverse sweep: the last iteration, through the live u
    const float* z_last = z_s + (iters - 1) * ke;
    const float* gb = g + static_cast<size_t>(b) * ke;
    for (int i = threadIdx.x; i < ke; i += blockDim.x) caps_s[i] = __ldg(gb + i);
    __syncthreads();
    row_dots(z_last, z_last, sq_s, K, E);
    row_dots(caps_s, z_last, gz_s, K, E);
    __syncthreads();
    squash_vjp_rows(caps_s, z_last, sq_s, gz_s, dz_s, K, E);
    __syncthreads();
    // du = w_last^T dz: A(l, k) = w[k, l]
    block_gemm<4, 4>(w_s + (iters - 1) * kl, 1, L, dz_s, E, 1, du_s, d.Ep, 1, L, E, K, false);
    // dw = dz u^T: B(e, l) = u[l, e]
    block_gemm<1, 1>(dz_s, E, 1, u_s, 1, d.Ep, dw_s, L, 1, K, L, E, false);
    __syncthreads();
    softmax_vjp_cols(dw_s, p_s + (iters - 1) * kl, mask_s, dlog_s, K, L, false);
    __syncthreads();
    for (int it = iters - 2; it >= 0; --it) {
      const float* z = z_s + it * ke;
      block_gemm<1, 1>(dlog_s, L, 1, u_s, d.Ep, 1, dcaps_s, E, 1, K, E, L, false);
      __syncthreads();
      row_dots(z, z, sq_s, K, E);
      row_dots(dcaps_s, z, gz_s, K, E);
      __syncthreads();
      squash_vjp_rows(dcaps_s, z, sq_s, gz_s, dz_s, K, E);
      __syncthreads();
      block_gemm<1, 1>(dz_s, E, 1, u_s, 1, d.Ep, dw_s, L, 1, K, L, E, false);
      __syncthreads();
      softmax_vjp_cols(dw_s, p_s + it * kl, mask_s, dlog_s, K, L, true);
      __syncthreads();
    }
    float* dl0_b = dl0 + static_cast<size_t>(b) * kl;
    for (int i = threadIdx.x; i < kl; i += blockDim.x) dl0_b[i] = dlog_s[i];
    // dx = du S^T: B(e, d) = S[d, e]; straight to device memory
    block_gemm<4, 4>(du_s, d.Ep, 1, s_s, 1, d.Ep, dx + static_cast<size_t>(b) * L * D, D, 1, L, D,
                     E, false);
    // dS += x^T du: A(d, l) = x[l, d]
    block_gemm<4, 4>(x_s, 1, d.Dp, du_s, d.Ep, 1, ds_s, d.Ep, 1, D, E, L, true);
    __syncthreads();  // the next row overwrites shared memory
  }
  float* part = partials + static_cast<size_t>(blockIdx.x) * D * E;
  for (int i = threadIdx.x; i < D * E; i += blockDim.x) {
    const int r = i / E;
    part[i] = ds_s[r * d.Ep + (i - r * E)];
  }
}

// Second pass: dS = the blocks' partials added in block order.
__global__ void __launch_bounds__(kReduceThreads) capsule_routing_bwd_reduce(
    const float* __restrict__ partials, int blocks, int n, float* __restrict__ ds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int j = 0; j < blocks; ++j) v += partials[static_cast<size_t>(j) * n + i];
  ds[i] = v;
}

// ---------------------------------------------------------------------------
// #7, the forward: a warp a 16-step tile, u in the mma.sync accumulators

constexpr int kTile = 16;                     // steps a warp owns
constexpr int kMaxTiles = 8;                  // L <= 128: up to 8 warps a block

// n-tiles of 8 capsule columns the kernel is built for; E is padded up to
// the next with zero columns of S (0 = wider than the kernel takes)
__host__ __device__ inline int fwd_nt(int E) {
  const int nt = (E + 7) / 8;
  return nt <= 2 ? nt : nt <= 4 ? 4 : nt <= 6 ? 6 : nt <= 8 ? 8 : nt <= 12 ? 12 : nt <= 16 ? 16 : 0;
}

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Shared memory of the forward, offsets in floats (each a multiple of 4):
//   sfrag (DK/8, NT, 32 lanes, 4): S split into TF32 [hi0, hi1, lo0, lo1]
//         in the B-fragment order of u's product, DK = D rounded up to 16
//   parts (2, tiles, K, 8 NT): each warp's z partials, double-buffered
//   caps  (2, K, 8 NT): the squashed capsules, double-buffered
//   lg    (2, tiles, K, 16): each warp's logits at its steps, one buffer
//         for this row and one the next row's logits0 arrive in
//   ws    (tiles, 16, KP): each warp's routing weights, KP = K rounded up
//         to 4
//   mk    (tiles, LP): each warp's copy of the mask of the row after the
//         next, LP = L rounded up to 4
//   xs    (tiles, 16, ST): each warp's x tile, then u's transpose; ST is a
//         multiple of 16 that is 16 mod 32 (a quarter warp's 16-byte
//         A-fragment loads, two rows of four lanes, hit distinct banks)
struct FwdLayout {
  int tiles, nt, ep, dk, st, kp, lp;
  size_t parts, caps, lg, ws, mk, xs, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int L, int D, int E, int K) {
  FwdLayout f;
  f.tiles = (L + kTile - 1) / kTile;
  f.nt = fwd_nt(E);
  f.ep = 8 * f.nt;
  f.dk = round16(D);
  f.st = round16(f.dk > f.ep + 4 ? f.dk : f.ep + 4);
  f.st += f.st % 32 ? 0 : 16;
  f.kp = (K + 3) & ~3;
  f.lp = (L + 3) & ~3;
  f.parts = static_cast<size_t>(f.dk) * f.nt * 16;
  f.caps = f.parts + 2 * static_cast<size_t>(f.tiles) * K * f.ep;
  f.lg = f.caps + 2 * static_cast<size_t>(K) * f.ep;
  f.ws = f.lg + 2 * static_cast<size_t>(f.tiles) * K * kTile;
  f.mk = f.ws + static_cast<size_t>(f.tiles) * kTile * f.kp;
  f.xs = f.mk + static_cast<size_t>(f.tiles) * f.lp;
  f.total = f.xs + static_cast<size_t>(f.tiles) * kTile * f.st;
  return f;
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// The warp's tile of one row's x (steps t0 .. t0 + 15 that are < L) into
// its stage, 16 bytes a copy where D and x allow, else 4; no register holds
// it on the way.
__device__ void load_x_tile(float* xs, int st, const float* xb, int t0, int L, int D, bool vec,
                            int lane) {
  const int rows = min(kTile, L - t0);
  const int q = vec ? D >> 2 : D;  // copies a step
  int r = lane / q, c = lane - r * q;
  while (r < rows) {
    const float* src = xb + static_cast<size_t>(t0 + r) * D;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(xs + r * st + 4 * c)),
                   "l"(src + 4 * c));
    } else {
      cp_async4(xs + r * st + c, src + c);
    }
    for (c += 32; c >= q; c -= q) ++r;
  }
}

// Zeros where the x tile has no data: columns D .. DK and steps past L.
__device__ void zero_x_pads(float* xs, int st, int D, int dk, int t0, int L, int lane) {
  for (int r = 0; r < kTile; ++r) {
    for (int c = (t0 + r < L ? D : 0) + lane; c < dk; c += 32) xs[r * st + c] = 0.f;
  }
}

// S (D, E) into shared memory, split into TF32 hi and lo, in the
// B-fragment order of u's product: entry (ks, j, lane) holds [hi0, hi1,
// lo0, lo1] of S[d][n], S[d + 1][n] with n = 8 j + gid. The k order inside
// each 16-wide chunk c of D is permuted so that a lane's A fragments of two
// k-steps are one 16-byte load of x: k-step 2c + h reads d = 16c + 4 tig +
// 2h (+1) at its positions tig (+4). A thread builds whole entries, 16 at
// a time with all their loads in flight; past D and E they are zero. With
// kSwizzle, entry (ks, j, lane) is stored at (ks, j, swizzle(lane)), so
// that the backward's transposed reads hit distinct banks too.
__host__ __device__ constexpr int swizzle(int lane) { return lane ^ (((lane >> 3) & 1) << 1); }

template <int NT, bool kSwizzle = false>
__device__ void fill_s(float4* sfrag, const float* __restrict__ s, int D, int E, int dk) {
  constexpr int kBatch = 16;
  const int n = (dk / 8) * NT * 32;
  for (int base = threadIdx.x; base < n; base += kBatch * blockDim.x) {
    float v[kBatch][2];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * blockDim.x, ln = i & 31, ks = (i >> 5) / NT;
      const int d0 = 16 * (ks >> 1) + 4 * (ln & 3) + 2 * (ks & 1), col = 8 * ((i >> 5) % NT) + (ln >> 2);
      const bool in = i < n && col < E;
      v[q][0] = in && d0 < D ? __ldg(s + d0 * E + col) : 0.f;
      v[q][1] = in && d0 + 1 < D ? __ldg(s + (d0 + 1) * E + col) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * blockDim.x;
      if (i < n) {
        uint32_t h0, lo0, h1, lo1;
        split(v[q][0], h0, lo0);
        split(v[q][1], h1, lo1);
        sfrag[kSwizzle ? swizzle(i) : i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                                       __uint_as_float(lo0), __uint_as_float(lo1));
      }
    }
  }
}

// at most 168 registers a thread where the tile fits them: 3 blocks of 4
// warps an SM at the slice's shape
template <int NT>
__global__ void __maxnreg__(NT <= 8 ? 168 : 255) capsule_routing_kernel(
    const float* __restrict__ x,      // (B, L, D)
    const float* __restrict__ mask,   // (B, L)
    const float* __restrict__ s,      // (D, E)
    const float* __restrict__ l0,     // (B, K, L), batch stride l0_stride
    float* __restrict__ out,          // (B, K, E)
    int B, int L, int D, int E, int K, int iters, long l0_stride) {
  constexpr int EP = 8 * NT;             // E padded
  constexpr int CPL = (EP + 31) / 32;    // columns a lane owns: lane + 32 q
  constexpr int KC = 4;                  // capsules worked together
  extern __shared__ __align__(16) float smem[];
  const FwdLayout f = fwd_layout(L, D, E, K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int W = f.tiles, t0 = kTile * warp, kp = f.kp, st = f.st;
  float4* sfrag = reinterpret_cast<float4*>(smem);
  float* parts = smem + f.parts;
  float* caps = smem + f.caps;
  float* lgs = smem + f.lg + warp * K * kTile;  // the other buffer W K 16 floats on
  float* ws = smem + f.ws + warp * kTile * kp;
  float* mk = smem + f.mk + warp * f.lp;
  float* xs = smem + f.xs + warp * kTile * st;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int sl = t0 + (lane & (kTile - 1));  // the step whose weights this lane computes

  // a row's logits0 straight into shared memory
  auto load_logits = [&](int b, float* lg) {
    const float* lb = l0 + b * l0_stride;
    for (int i = lane; i < K * kTile; i += 32) {
      const int step = t0 + (i & (kTile - 1));
      if (step < L) {
        cp_async4(lg + i, lb + (i / kTile) * L + step);
      } else {
        lg[i] = 0.f;
      }
    }
  };
  // a row's mask into the warp's copy, for the row after the next
  auto load_mask_copy = [&](int b) {
    for (int l = lane; l < L; l += 32) cp_async4(mk + l, mask + static_cast<size_t>(b) * L + l);
  };
  // the tiles up to the row's last step with a nonzero mask
  auto live_tiles = [&](const float (&mv)[kMaxTiles / 2]) {
    int last = -1;
#pragma unroll
    for (int r = 0; r < kMaxTiles / 2; ++r) {
      const unsigned bal = __ballot_sync(0xffffffffu, mv[r] != 0.f);
      if (bal) last = 32 * r + 31 - __clz(bal);
    }
    return (last + kTile) / kTile;
  };
  auto load_mask = [&](int b, float (&mv)[kMaxTiles / 2], float& ms) {
    const float* mb = mask + static_cast<size_t>(b) * L;
#pragma unroll
    for (int r = 0; r < kMaxTiles / 2; ++r) mv[r] = 32 * r + lane < L ? __ldg(mb + 32 * r + lane) : 0.f;
    ms = sl < L ? __ldg(mb + sl) : 0.f;
  };

  const bool pads = D % kTile != 0 || t0 + kTile > L;  // x has no data somewhere in the tile
  if (pads) zero_x_pads(xs, st, D, f.dk, t0, L, lane);
  __syncwarp();
  // the first row's loads and S's, all in flight before any is used
  int b = blockIdx.x, cur = 0, phase = 0;  // phase: parity of parts and caps
  float mv[kMaxTiles / 2], ms;
  load_mask(b, mv, ms);
  load_x_tile(xs, st, x + static_cast<size_t>(b) * L * D, t0, L, D, vec, lane);
  load_logits(b, lgs);
  fill_s<NT>(sfrag, s, D, E, f.dk);
  int nlive = live_tiles(mv);
  // the next row's mask, a row ahead of its x, through shared memory so
  // that it is in place when the next row's x is asked for
  if (b + static_cast<int>(gridDim.x) < B) load_mask_copy(b + gridDim.x);
  for (; b < B; b += gridDim.x) {
    const int bn = b + gridDim.x;
    const bool live = warp < nlive;
    float* lg = lgs + cur * W * K * kTile;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if (b == static_cast<int>(blockIdx.x)) __syncthreads();  // S in place

    // u = x S for the tile in 3xTF32, left in the accumulators: u[j] holds
    // steps gid (0, 1) and gid + 8 (2, 3) at columns 8 j + 2 tig (+1)
    float u[NT][4], uc[CPL][kTile];
#pragma unroll
    for (int j = 0; j < NT; ++j) u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.f;
    if (live) {
      const float* xa = xs + gid * st + 4 * tig;
      for (int c = 0; c < f.dk / 16; ++c) {
        const float4 pa = *reinterpret_cast<const float4*>(xa + 16 * c);
        const float4 pb = *reinterpret_cast<const float4*>(xa + 8 * st + 16 * c);
        uint32_t ah[2][4], al[2][4];
        split(pa.x, ah[0][0], al[0][0]);
        split(pb.x, ah[0][1], al[0][1]);
        split(pa.y, ah[0][2], al[0][2]);
        split(pb.y, ah[0][3], al[0][3]);
        split(pa.z, ah[1][0], al[1][0]);
        split(pb.z, ah[1][1], al[1][1]);
        split(pa.w, ah[1][2], al[1][2]);
        split(pb.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float4 bf = sfrag[((2 * c + h) * NT + j) * 32 + lane];
            mma3(u[j], ah[h], al[h], __float_as_uint(bf.x), __float_as_uint(bf.y),
                 __float_as_uint(bf.z), __float_as_uint(bf.w));
          }
        }
      }
      // u again, transposed through the stage: the lane's own columns at
      // all 16 steps, for z = w u without a reduction across lanes
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<float2*>(xs + gid * st + 8 * j + 2 * tig) = make_float2(u[j][0], u[j][1]);
        *reinterpret_cast<float2*>(xs + (gid + 8) * st + 8 * j + 2 * tig) = make_float2(u[j][2], u[j][3]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
#pragma unroll
        for (int r = 0; r < kTile; ++r) uc[q][r] = lane + 32 * q < EP ? xs[r * st + lane + 32 * q] : 0.f;
      }
      __syncwarp();
      if (pads) zero_x_pads(xs, st, D, f.dk, t0, L, lane);
    }
    // the next row's x tiles and logits0 arrive while this row routes
    int nlive_next = 0;
    float ms_next = 0.f;
    if (bn < B) {
#pragma unroll
      for (int r = 0; r < kMaxTiles / 2; ++r) mv[r] = 32 * r + lane < L ? mk[32 * r + lane] : 0.f;
      ms_next = sl < L ? mk[sl] : 0.f;
      nlive_next = live_tiles(mv);
      __syncwarp();
      load_logits(bn, lgs + (cur ^ 1) * W * K * kTile);
      if (warp < nlive_next) load_x_tile(xs, st, x + static_cast<size_t>(bn) * L * D, t0, L, D, vec, lane);
      if (bn + static_cast<int>(gridDim.x) < B) load_mask_copy(bn + gridDim.x);
    }

    const float neg = kNeg * (1.f - ms);
    for (int it = 0; it < iters; ++it) {
      const bool last_it = it == iters - 1;
      float* pbuf = parts + static_cast<size_t>(phase & 1) * W * K * EP;
      float* cbuf = caps + static_cast<size_t>(phase & 1) * K * EP;
      ++phase;
      if (live) {
        // w = softmax over the capsules times the mask, a step a lane, KC
        // capsules at a time with no branch: lg + neg goes to ws, then its
        // exponential, then w (the capsules past K take -FLT_MAX, so their
        // exponential is 0)
        if (lane < kTile) {
          float* wrow = ws + lane * kp;
          float mx = -FLT_MAX, sum = 0.f;
#pragma unroll 1
          for (int k0 = 0; k0 < kp; k0 += KC) {
            float v[KC];
#pragma unroll
            for (int kk = 0; kk < KC; ++kk) {
              v[kk] = k0 + kk < K ? lg[(k0 + kk) * kTile + lane] + neg : -FLT_MAX;
              mx = fmaxf(mx, v[kk]);
            }
            *reinterpret_cast<float4*>(wrow + k0) = make_float4(v[0], v[1], v[2], v[3]);
          }
#pragma unroll 1
          for (int k0 = 0; k0 < kp; k0 += KC) {
            float4 e = *reinterpret_cast<const float4*>(wrow + k0);
            e = make_float4(expf(e.x - mx), expf(e.y - mx), expf(e.z - mx), expf(e.w - mx));
            sum += e.x;
            sum += e.y;
            sum += e.z;
            sum += e.w;
            *reinterpret_cast<float4*>(wrow + k0) = e;
          }
          const float inv = 1.f / sum;
#pragma unroll 1
          for (int k0 = 0; k0 < kp; k0 += KC) {
            const float4 e = *reinterpret_cast<const float4*>(wrow + k0);
            *reinterpret_cast<float4*>(wrow + k0) =
                make_float4(e.x * inv * ms, e.y * inv * ms, e.z * inv * ms, e.w * inv * ms);
          }
        }
        __syncwarp();
        // this tile's z = w u at the lane's columns, KC capsules at a time
#pragma unroll 1
        for (int k0 = 0; k0 < K; k0 += KC) {
          float acc[KC][CPL];
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
            for (int q = 0; q < CPL; ++q) acc[kk][q] = 0.f;
          }
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const float4 wv = *reinterpret_cast<const float4*>(ws + r * kp + k0);
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              acc[0][q] = fmaf(wv.x, uc[q][r], acc[0][q]);
              acc[1][q] = fmaf(wv.y, uc[q][r], acc[1][q]);
              acc[2][q] = fmaf(wv.z, uc[q][r], acc[2][q]);
              acc[3][q] = fmaf(wv.w, uc[q][r], acc[3][q]);
            }
          }
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              if (k0 + kk < K && lane + 32 * q < EP) {
                pbuf[(static_cast<size_t>(warp) * K + k0 + kk) * EP + lane + 32 * q] = acc[kk][q];
              }
            }
          }
        }
      }
      __syncthreads();
      // z = the live warps' partials added in warp order, then the squash;
      // warp w finishes capsules w, w + W, ...
#pragma unroll 1
      for (int k = warp; k < K; k += W) {
        float z[CPL], sq = 0.f;
#pragma unroll
        for (int q = 0; q < CPL; ++q) z[q] = 0.f;
#pragma unroll 1
        for (int w0 = 0; w0 < nlive; w0 += 4) {  // four warps' loads, then their sum in order
          float part[4][CPL];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int c = min(lane + 32 * q, EP - 1);
              part[i][q] = pbuf[(static_cast<size_t>(min(w0 + i, W - 1)) * K + k) * EP + c];
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int q = 0; q < CPL; ++q) z[q] += w0 + i < nlive && lane + 32 * q < EP ? part[i][q] : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < CPL; ++q) sq = fmaf(z[q], z[q], sq);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
        const float scale = sq * __frcp_rn(1.f + sq), rs = rsqrtf(sq + kEps);
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane + 32 * q;
          const float v = scale * z[q] * rs;
          if (last_it) {
            if (c < E) out[(static_cast<size_t>(b) * K + k) * E + c] = v;
          } else if (c < EP) {
            cbuf[k * EP + c] = v;
          }
        }
      }
      if (last_it) break;
      __syncthreads();
      if (live) {
        // logits += caps u^T at the warp's steps gid and gid + 8: the
        // lane's columns, then the quad's, KC capsules at a time
#pragma unroll 1
        for (int k0 = 0; k0 < K; k0 += KC) {
          float a[KC][2];
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) a[kk][0] = a[kk][1] = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int kk = 0; kk < KC; ++kk) {  // rows past K: shared memory, not stored
              const float2 cv = *reinterpret_cast<const float2*>(cbuf + (k0 + kk) * EP + 8 * j + 2 * tig);
              a[kk][0] = fmaf(cv.y, u[j][1], fmaf(cv.x, u[j][0], a[kk][0]));
              a[kk][1] = fmaf(cv.y, u[j][3], fmaf(cv.x, u[j][2], a[kk][1]));
            }
          }
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              a[kk][h] += __shfl_xor_sync(0xffffffffu, a[kk][h], 1);
              a[kk][h] += __shfl_xor_sync(0xffffffffu, a[kk][h], 2);
            }
            if (tig == 0 && k0 + kk < K) {
              lg[(k0 + kk) * kTile + gid] += a[kk][0];
              lg[(k0 + kk) * kTile + gid + 8] += a[kk][1];
            }
          }
        }
        __syncwarp();
      }
    }
    nlive = nlive_next;
    ms = ms_next;
    cur ^= 1;
  }
}

// ---------------------------------------------------------------------------
// #8, the backward on the tensor cores: a warp a live 16-step tile

// The backward's forward parts on a warp's 16-step tile, as the forward
// kernel computes them inline (it keeps its own code: calling these cost
// it 0.6 % on an H100 at the slice's shape): lane =
// threadIdx.x % 32, gid = lane / 4, tig = lane % 4; EP = 8 NT capsule
// columns, CPL = columns a lane owns: lane + 32 q.

// u += x S for the tile in 3xTF32: x from the warp's stage (16 rows, stride
// st, zeros where it has no data), S from sfrag (fill_s<NT, true>'s
// order); u[j]
// holds steps gid (0, 1) and gid + 8 (2, 3) at columns 8 j + 2 tig (+1)
template <int NT>
__device__ __forceinline__ void tile_u(const float* xs, int st, const float4* sfrag, int dk,
                                       float (&u)[NT][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int slot = swizzle(lane);  // where fill_s<NT, true> put the lane's entry
  const float* xa = xs + gid * st + 4 * tig;
  for (int c = 0; c < dk / 16; ++c) {
    const float4 pa = *reinterpret_cast<const float4*>(xa + 16 * c);
    const float4 pb = *reinterpret_cast<const float4*>(xa + 8 * st + 16 * c);
    uint32_t ah[2][4], al[2][4];
    split(pa.x, ah[0][0], al[0][0]);
    split(pb.x, ah[0][1], al[0][1]);
    split(pa.y, ah[0][2], al[0][2]);
    split(pb.y, ah[0][3], al[0][3]);
    split(pa.z, ah[1][0], al[1][0]);
    split(pb.z, ah[1][1], al[1][1]);
    split(pa.w, ah[1][2], al[1][2]);
    split(pb.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 bf = sfrag[((2 * c + h) * NT + j) * 32 + slot];
        mma3(u[j], ah[h], al[h], __float_as_uint(bf.x), __float_as_uint(bf.y), __float_as_uint(bf.z),
             __float_as_uint(bf.w));
      }
    }
  }
}

// u again, transposed through a stage (16 rows, stride ss): uc[q][r] is u at
// step r and the lane's column lane + 32 q (0 past EP), for the products
// over the tile's steps, which then need no reduction across lanes
template <int NT, int CPL>
__device__ __forceinline__ void transpose_u(float* stage, int ss, const float (&u)[NT][4],
                                            float (&uc)[CPL][kTile]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(stage + gid * ss + 8 * j + 2 * tig) = make_float2(u[j][0], u[j][1]);
    *reinterpret_cast<float2*>(stage + (gid + 8) * ss + 8 * j + 2 * tig) = make_float2(u[j][2], u[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
#pragma unroll
    for (int r = 0; r < kTile; ++r) uc[q][r] = lane + 32 * q < 8 * NT ? stage[r * ss + lane + 32 * q] : 0.f;
  }
}

// out[k, c] = sum over the tile's steps r of a[r, k] u[r, c] at the lane's
// columns, KC capsules at a time (a: 16 rows of kp, a multiple of 4; out:
// (K, EP), the warp's partials): z = w u, or dcaps = dlog u
template <int NT, int CPL>
__device__ __forceinline__ void steps_times_u(const float* a, int kp, const float (&uc)[CPL][kTile],
                                              float* out, int K) {
  constexpr int EP = 8 * NT, KC = 4;
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += KC) {
    float acc[KC][CPL];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[kk][q] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(a + r * kp + k0);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        acc[0][q] = fmaf(wv.x, uc[q][r], acc[0][q]);
        acc[1][q] = fmaf(wv.y, uc[q][r], acc[1][q]);
        acc[2][q] = fmaf(wv.z, uc[q][r], acc[2][q]);
        acc[3][q] = fmaf(wv.w, uc[q][r], acc[3][q]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        if (k0 + kk < K && lane + 32 * q < EP) out[(k0 + kk) * EP + lane + 32 * q] = acc[kk][q];
      }
    }
  }
}

// z[q] = the first nlive warps' partials of capsule k (parts: (W, K, EP))
// added in warp order at the lane's columns: four warps' loads, then their
// sum
template <int NT, int CPL>
__device__ __forceinline__ void sum_partials(const float* parts, int k, int nlive, int W, int K,
                                             float (&z)[CPL]) {
  constexpr int EP = 8 * NT;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < CPL; ++q) z[q] = 0.f;
#pragma unroll 1
  for (int w0 = 0; w0 < nlive; w0 += 4) {
    float part[4][CPL];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = min(lane + 32 * q, EP - 1);
        part[i][q] = parts[(static_cast<size_t>(min(w0 + i, W - 1)) * K + k) * EP + c];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) z[q] += w0 + i < nlive && lane + 32 * q < EP ? part[i][q] : 0.f;
    }
  }
}

// out[k, step] (+)= sum_e c[k, e] u[step, e] at the warp's steps gid and
// gid + 8 (out: (K, 16)): the lane's columns, then the quad's two shuffles,
// KC capsules at a time. c is (K, EP); its rows past K are read (and not
// stored), so three rows of shared memory must follow it. The logit
// update, or dw = dz u^T
template <int NT, bool kAdd>
__device__ __forceinline__ void caps_dot_u(const float* c, const float (&u)[NT][4], float* out, int K) {
  constexpr int EP = 8 * NT, KC = 4;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += KC) {
    float a[KC][2];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) a[kk][0] = a[kk][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float2 cv = *reinterpret_cast<const float2*>(c + (k0 + kk) * EP + 8 * j + 2 * tig);
        a[kk][0] = fmaf(cv.y, u[j][1], fmaf(cv.x, u[j][0], a[kk][0]));
        a[kk][1] = fmaf(cv.y, u[j][3], fmaf(cv.x, u[j][2], a[kk][1]));
      }
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[kk][h] += __shfl_xor_sync(0xffffffffu, a[kk][h], 1);
        a[kk][h] += __shfl_xor_sync(0xffffffffu, a[kk][h], 2);
      }
      if (tig == 0 && k0 + kk < K) {
        if (kAdd) {
          out[(k0 + kk) * kTile + gid] += a[kk][0];
          out[(k0 + kk) * kTile + gid + 8] += a[kk][1];
        } else {
          out[(k0 + kk) * kTile + gid] = a[kk][0];
          out[(k0 + kk) * kTile + gid + 8] = a[kk][1];
        }
      }
    }
  }
}

// Shared memory of the backward's tensor-core kernel, offsets in floats
// (each a multiple of 4):
//   sfrag (DK/8, NT, 32, 4): S split into TF32 in the forward's order,
//         each group of 32 entries swizzled (fill_s)
//   caps  (K, EP): the squashed capsules; dz from the last iteration on
//   g     (K, EP): the row's cotangent (zeros past E); with ds it is the
//         shared memory after caps that caps_dot_u reads
//   ds    (DK, EP): the block's running dS, each float4 owned by one thread
//   xs    (tiles, 16, ST): each warp's x tile, ST 16 mod 32 as the forward's
//   ut    (tiles, 16, SD): each warp's stage for u's transpose, SD even
//   z     (iters, K, EP): each iteration's z
//   parts (tiles, K, EP): each warp's z or dcaps partials
//   xw    (tiles, K, DK): each warp's partial of w_last x
//   dzs   (K, DK): dz S^T
//   p     (iters, tiles, 16, KP): each iteration's softmax at the warp's steps
//   ws    (tiles, 16, KP): the iteration's weights; dlog in the reverse sweep
//   lg    (tiles, K, 16): each warp's logits
//   dw    (tiles, K, 16): each warp's dw at its steps
struct BwdLayout {
  int tiles, nt, ep, dk, st, sd, kp;
  size_t caps, g, ds, xs, ut, z, parts, xw, dzs, p, ws, lg, dw, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int L, int D, int E, int K, int iters) {
  BwdLayout f;
  f.tiles = (L + kTile - 1) / kTile;
  f.nt = fwd_nt(E);
  f.ep = 8 * f.nt;
  f.dk = round16(D);
  f.st = f.dk + (f.dk % 32 ? 0 : 16);
  f.sd = f.ep + (40 - f.ep % 32) % 32;
  f.kp = (K + 3) & ~3;
  f.caps = static_cast<size_t>(f.dk) * f.nt * 16;
  f.g = f.caps + static_cast<size_t>(K) * f.ep;
  f.ds = f.g + static_cast<size_t>(K) * f.ep;
  f.xs = f.ds + static_cast<size_t>(f.dk) * f.ep;
  f.ut = f.xs + static_cast<size_t>(f.tiles) * kTile * f.st;
  f.z = f.ut + static_cast<size_t>(f.tiles) * kTile * f.sd;
  f.parts = f.z + static_cast<size_t>(iters) * K * f.ep;
  f.xw = f.parts + static_cast<size_t>(f.tiles) * K * f.ep;
  f.dzs = f.xw + static_cast<size_t>(f.tiles) * K * f.dk;
  f.p = f.dzs + static_cast<size_t>(K) * f.dk;
  f.ws = f.p + static_cast<size_t>(iters) * f.tiles * kTile * f.kp;
  f.lg = f.ws + static_cast<size_t>(f.tiles) * kTile * f.kp;
  f.dw = f.lg + static_cast<size_t>(f.tiles) * K * kTile;
  f.total = f.dw + static_cast<size_t>(f.tiles) * K * kTile;
  return f;
}

// cp.async of 16 or 4 bytes that reads n of them (n = 0 or all) and fills
// the rest with zeros
__device__ __forceinline__ void cp_async16_fill(float* dst, const float* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4_fill(float* dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

// The warp's tile of one row's x: steps t0 .. t0 + 15 up to the row's last
// live step, zeros past it (and past L); 16 bytes a copy where D and x
// allow, else 4
__device__ void load_x_live(float* xs, int st, const float* xb, int t0, int last, int D, bool vec,
                            int lane) {
  const int q = vec ? D >> 2 : D;  // copies a step
  int r = lane / q, c = lane - r * q;
  while (r < kTile) {
    const bool in = t0 + r <= last;
    const float* src = xb + static_cast<size_t>(in ? t0 + r : 0) * D;
    if (vec) {
      cp_async16_fill(xs + r * st + 4 * c, src + 4 * c, in ? 16 : 0);
    } else {
      cp_async4_fill(xs + r * st + c, src + c, in ? 4 : 0);
    }
    for (c += 32; c >= q; c -= q) ++r;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dz = squash'(z)^T gc for one capsule at the lane's columns, given sq =
// |z|^2 (tpurec/ops/pallas/kernels.py:854-862); dz: the capsule's row
template <int NT, int CPL>
__device__ __forceinline__ void squash_vjp_lane(const float (&gc)[CPL], const float (&z)[CPL], float sq,
                                                float* dz) {
  const int lane = threadIdx.x & 31;
  float gz = 0.f;
#pragma unroll
  for (int q = 0; q < CPL; ++q) gz = fmaf(gc[q], z[q], gz);
  gz = warp_sum(gz);
  const float rs = rsqrtf(sq + kEps), a = (sq / (1.f + sq)) * rs;
  const float ap = rs / (1.f + sq) - a / (1.f + sq) - a / (2.f * (sq + kEps));
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    if (lane + 32 * q < 8 * NT) dz[lane + 32 * q] = a * gc[q] + 2.f * z[q] * ap * gz;
  }
}

// dlog (+)= softmax'(p)^T (dw m) at step r = the lane (< 16): dp = dw m;
// p (dp - sum_k p dp) (tpurec/ops/pallas/kernels.py:864-867); p and dlog
// rows of kp (a multiple of 4; p is 0 past K), dw (K, 16); four capsules
// at a time
__device__ __forceinline__ void softmax_vjp_step(const float* dw, const float* p, float* dlog, int kp,
                                                 int K, float m, bool add) {
  const int r = threadIdx.x & 31;
  const float* prow = p + r * kp;
  float* drow = dlog + r * kp;
  float s = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < kp; k0 += 4) {
    const float4 pv = *reinterpret_cast<const float4*>(prow + k0);
    s = fmaf(pv.x, dw[k0 * kTile + r] * m, s);
    if (k0 + 1 < K) s = fmaf(pv.y, dw[(k0 + 1) * kTile + r] * m, s);
    if (k0 + 2 < K) s = fmaf(pv.z, dw[(k0 + 2) * kTile + r] * m, s);
    if (k0 + 3 < K) s = fmaf(pv.w, dw[(k0 + 3) * kTile + r] * m, s);
  }
#pragma unroll 1
  for (int k0 = 0; k0 < kp; k0 += 4) {
    const float4 pv = *reinterpret_cast<const float4*>(prow + k0);
    float v[4] = {pv.x * (dw[k0 * kTile + r] * m - s), 0.f, 0.f, 0.f};
    if (k0 + 1 < K) v[1] = pv.y * (dw[(k0 + 1) * kTile + r] * m - s);
    if (k0 + 2 < K) v[2] = pv.z * (dw[(k0 + 2) * kTile + r] * m - s);
    if (k0 + 3 < K) v[3] = pv.w * (dw[(k0 + 3) * kTile + r] * m - s);
    float4 out = make_float4(v[0], v[1], v[2], v[3]);
    if (add) {
      const float4 o = *reinterpret_cast<const float4*>(drow + k0);
      out = make_float4(o.x + v[0], o.y + v[1], o.z + v[2], o.w + v[3]);
    }
    *reinterpret_cast<float4*>(drow + k0) = out;
  }
}

template <int NT>
__global__ void __launch_bounds__(32 * kMaxTiles) capsule_routing_bwd_tc_kernel(
    const float* __restrict__ x,      // (B, L, D)
    const float* __restrict__ mask,   // (B, L)
    const float* __restrict__ s,      // (D, E)
    const float* __restrict__ l0,     // (B, K, L), batch stride l0_stride
    const float* __restrict__ g,      // (B, K, E)
    float* __restrict__ dx,           // (B, L, D)
    float* __restrict__ dl0,          // (B, K, L)
    float* __restrict__ partials,     // (gridDim.x, D, E)
    int B, int L, int D, int E, int K, int iters, long l0_stride) {
  constexpr int EP = 8 * NT;             // E padded
  constexpr int CPL = (EP + 31) / 32;    // columns a lane owns: lane + 32 q
  constexpr int KC = 4;                  // capsules worked together
  extern __shared__ __align__(16) float smem[];
  const BwdLayout f = bwd_layout(L, D, E, K, iters);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int W = f.tiles, t0 = kTile * warp, kp = f.kp, st = f.st, sd = f.sd, mts = f.dk / 16;
  const int G = gridDim.x;
  float4* sfrag = reinterpret_cast<float4*>(smem);
  float* caps = smem + f.caps;
  float* gs = smem + f.g;
  float4* dsr = reinterpret_cast<float4*>(smem + f.ds);
  float* xs = smem + f.xs + warp * kTile * st;
  float* uts = smem + f.ut + warp * kTile * sd;
  float* zs = smem + f.z;
  const float* parts = smem + f.parts;
  float* wparts = smem + f.parts + static_cast<size_t>(warp) * K * EP;
  const float* xwall = smem + f.xw;
  float* dzs = smem + f.dzs;
  float* ps = smem + f.p + warp * kTile * kp;
  const int p_step = W * kTile * kp;  // floats between two iterations' p
  float* ws = smem + f.ws + warp * kTile * kp;
  float* lg = smem + f.lg + warp * K * kTile;
  float* dwb = smem + f.dw + warp * K * kTile;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  auto load_mask = [&](int b, float (&mv)[kMaxTiles / 2]) {
    const float* mb = mask + static_cast<size_t>(b) * L;
#pragma unroll
    for (int r = 0; r < kMaxTiles / 2; ++r) mv[r] = 32 * r + lane < L ? __ldg(mb + 32 * r + lane) : 0.f;
  };
  // the row's last step with a nonzero mask (-1: none)
  auto last_live = [&](const float (&mv)[kMaxTiles / 2]) {
    int last = -1;
#pragma unroll
    for (int r = 0; r < kMaxTiles / 2; ++r) {
      const unsigned bal = __ballot_sync(0xffffffffu, mv[r] != 0.f);
      if (bal) last = 32 * r + 31 - __clz(bal);
    }
    return last;
  };
  // the mask at the lane's step t0 + lane % 16, from the lane that read it
  auto step_mask = [&](const float (&mv)[kMaxTiles / 2]) {
    float m = mv[0];
#pragma unroll
    for (int r = 1; r < kMaxTiles / 2; ++r) m = (t0 >> 5) == r ? mv[r] : m;
    return __shfl_sync(0xffffffffu, m, (t0 + (lane & (kTile - 1))) & 31);
  };
  // a row's x tile and logits0 at the warp's steps (a live tile only) and
  // its g (the whole block), all cp.async
  auto load_row = [&](int b, int last) {
    if (t0 <= last) {
      load_x_live(xs, st, x + static_cast<size_t>(b) * L * D, t0, last, D, vec, lane);
      const float* lb = l0 + b * l0_stride;
      for (int i = lane; i < K * kTile; i += 32) {
        const int step = t0 + (i & (kTile - 1));
        if (step < L) {
          cp_async4(lg + i, lb + (i / kTile) * L + step);
        } else {
          lg[i] = 0.f;
        }
      }
    }
    const float* gb = g + static_cast<size_t>(b) * K * E;
    for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
      const int k = i / E;
      cp_async4(gs + k * EP + i - k * E, gb + i);
    }
  };

  // once a block: zeros where the stages get no data (x past D, g past E)
  // and in the running dS; S's fragments; the first row's loads
  for (int r = 0; r < kTile; ++r) {
    for (int c = D + lane; c < f.dk; c += 32) xs[r * st + c] = 0.f;
  }
  if (EP > E) {
    for (int i = threadIdx.x; i < K * (EP - E); i += blockDim.x) {
      const int k = i / (EP - E);
      gs[k * EP + E + i - k * (EP - E)] = 0.f;
    }
  }
  for (int i = threadIdx.x; i < f.dk * EP; i += blockDim.x) smem[f.ds + i] = 0.f;
  int b = blockIdx.x;
  float mv[kMaxTiles / 2];
  load_mask(b, mv);
  int last = last_live(mv);
  float ms = step_mask(mv);
  load_row(b, last);
  fill_s<NT, true>(sfrag, s, D, E, f.dk);
  if (b + G < B) load_mask(b + G, mv);  // the next row's, for its loads
  for (; b < B; b += G) {
    const bool live = t0 <= last;
    const int nlive = (last + kTile) / kTile;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the u stage
    __syncwarp();
    if (b == static_cast<int>(blockIdx.x)) __syncthreads();  // S and the zeros in place

    // u = x S for the tile in 3xTF32, kept in the accumulators, and its
    // transpose through the du stage
    float u[NT][4], uc[CPL][kTile];
#pragma unroll
    for (int j = 0; j < NT; ++j) u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.f;
    if (live) {
      tile_u<NT>(xs, st, sfrag, f.dk, u);
      transpose_u<NT, CPL>(uts, sd, u, uc);
    }

    // the forward again, keeping p (at the warp's steps) and z of every
    // iteration; the last iteration's squash is its VJP: dz
    const float neg = kNeg * (1.f - ms);
    for (int it = 0; it < iters; ++it) {
      const bool last_it = it == iters - 1;
      if (live) {
        // p = softmax over the capsules at the lane's step, w = p m, KC
        // capsules at a time (the capsules past K take -FLT_MAX: p = 0)
        if (lane < kTile && kp == KC) {
          // K <= 4: the same arithmetic in registers
          float v[KC], mx = -FLT_MAX, sum = 0.f;
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
            v[kk] = kk < K ? lg[kk * kTile + lane] + neg : -FLT_MAX;
            mx = fmaxf(mx, v[kk]);
          }
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
            v[kk] = expf(v[kk] - mx);
            sum += v[kk];
          }
          const float inv = 1.f / sum;
          const float4 p = make_float4(v[0] * inv, v[1] * inv, v[2] * inv, v[3] * inv);
          *reinterpret_cast<float4*>(ps + it * p_step + lane * kp) = p;
          *reinterpret_cast<float4*>(ws + lane * kp) = make_float4(p.x * ms, p.y * ms, p.z * ms, p.w * ms);
        } else if (lane < kTile) {
          float* wrow = ws + lane * kp;
          float* prow = ps + it * p_step + lane * kp;
          float mx = -FLT_MAX, sum = 0.f;
#pragma unroll 1
          for (int k0 = 0; k0 < kp; k0 += KC) {
            float v[KC];
#pragma unroll
            for (int kk = 0; kk < KC; ++kk) {
              v[kk] = k0 + kk < K ? lg[(k0 + kk) * kTile + lane] + neg : -FLT_MAX;
              mx = fmaxf(mx, v[kk]);
            }
            *reinterpret_cast<float4*>(wrow + k0) = make_float4(v[0], v[1], v[2], v[3]);
          }
#pragma unroll 1
          for (int k0 = 0; k0 < kp; k0 += KC) {
            float4 e = *reinterpret_cast<const float4*>(wrow + k0);
            e = make_float4(expf(e.x - mx), expf(e.y - mx), expf(e.z - mx), expf(e.w - mx));
            sum += e.x;
            sum += e.y;
            sum += e.z;
            sum += e.w;
            *reinterpret_cast<float4*>(wrow + k0) = e;
          }
          const float inv = 1.f / sum;
#pragma unroll 1
          for (int k0 = 0; k0 < kp; k0 += KC) {
            const float4 e = *reinterpret_cast<const float4*>(wrow + k0);
            const float4 p = make_float4(e.x * inv, e.y * inv, e.z * inv, e.w * inv);
            *reinterpret_cast<float4*>(prow + k0) = p;
            *reinterpret_cast<float4*>(wrow + k0) = make_float4(p.x * ms, p.y * ms, p.z * ms, p.w * ms);
          }
        }
        __syncwarp();
        steps_times_u<NT, CPL>(ws, kp, uc, wparts, K);  // this tile's z = w u
      }
      __syncthreads();
      // z = the live warps' partials added in warp order; warp w finishes
      // capsules w, w + W, ...: the squash, or in the last iteration dz =
      // squash'(z)^T g
#pragma unroll 1
      for (int k = warp; k < K; k += W) {
        float z[CPL], sq = 0.f;
        sum_partials<NT, CPL>(parts, k, nlive, W, K, z);
        float* zk = zs + (it * K + k) * EP;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          if (lane + 32 * q < EP) zk[lane + 32 * q] = z[q];
          sq = fmaf(z[q], z[q], sq);
        }
        sq = warp_sum(sq);
        if (last_it) {
          float gc[CPL];
#pragma unroll
          for (int q = 0; q < CPL; ++q) gc[q] = lane + 32 * q < EP ? gs[k * EP + lane + 32 * q] : 0.f;
          squash_vjp_lane<NT, CPL>(gc, z, sq, caps + k * EP);
        } else {
          const float scale = sq * __frcp_rn(1.f + sq), rs = rsqrtf(sq + kEps);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            if (lane + 32 * q < EP) caps[k * EP + lane + 32 * q] = scale * z[q] * rs;
          }
        }
      }
      __syncthreads();
      if (!last_it && live) {
        caps_dot_u<NT, true>(caps, u, lg, K);  // logits += caps u^T
        __syncwarp();
      }
    }

    // du = w_last^T dz has rank K, so the two L-deep products of the
    // backward factor through K: dS = sum over rows of x^T du = (w_last
    // x)^T dz and dx = du S^T = w_last^T (dz S^T). Each warp forms its
    // tile's partial of w_last x (K x D, fp32) at the lane's columns of x;
    // the warps take dz S^T (K x D) in 16-column chunks of D on the tensor
    // cores in 3xTF32 (A = dz, its rows past K zero; B = S^T from sfrag
    // read transposed: column gid of the n-tile pair (c, h) is d = 16 c + 4
    // (gid % 4) + 2 (gid / 4) + h, so entry (2 c + gid / 4, ke, 4 tig + gid
    // % 4) holds S at (d, 8 ke + tig) for h = 0 and 1, and the entry 16
    // lanes on S at (d, 8 ke + tig + 4), both swizzled alike; the hi.hi
    // products and the two small ones in separate accumulators, added at
    // the end).
    if (live) {
#pragma unroll 1
      for (int d = lane; d < f.dk; d += 32) {
#pragma unroll 1
        for (int k0 = 0; k0 < K; k0 += KC) {
          float acc[KC] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const float4 wv = *reinterpret_cast<const float4*>(ws + r * kp + k0);
            const float xv = xs[r * st + d];
            acc[0] = fmaf(wv.x, xv, acc[0]);
            acc[1] = fmaf(wv.y, xv, acc[1]);
            acc[2] = fmaf(wv.z, xv, acc[2]);
            acc[3] = fmaf(wv.w, xv, acc[3]);
          }
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
            if (k0 + kk < K) smem[f.xw + (static_cast<size_t>(warp) * K + k0 + kk) * f.dk + d] = acc[kk];
          }
        }
      }
    }
#pragma unroll 1
    for (int job = warp; job < mts * ((K + 15) / 16); job += W) {
      const int c = job % mts, k0 = 16 * (job / mts);
      const float4* ent = sfrag + (2 * c + (gid >> 2)) * NT * 32 + swizzle(4 * tig + (gid & 3));
      const int ra = k0 + gid, rb = k0 + gid + 8;  // dz's rows in A's rows gid, gid + 8
      float yh[2][4], yl[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) yh[h][i] = yl[h][i] = 0.f;
      }
#pragma unroll
      for (int ke = 0; ke < NT; ++ke) {
        uint32_t ah[4], al[4];
        split(ra < K ? caps[ra * EP + 8 * ke + tig] : 0.f, ah[0], al[0]);
        split(rb < K ? caps[rb * EP + 8 * ke + tig] : 0.f, ah[1], al[1]);
        split(ra < K ? caps[ra * EP + 8 * ke + tig + 4] : 0.f, ah[2], al[2]);
        split(rb < K ? caps[rb * EP + 8 * ke + tig + 4] : 0.f, ah[3], al[3]);
        const float4 ea = ent[ke * 32], eb = ent[ke * 32 + 16];
        mma(yl[0], al, __float_as_uint(ea.x), __float_as_uint(eb.x));
        mma(yl[0], ah, __float_as_uint(ea.z), __float_as_uint(eb.z));
        mma(yh[0], ah, __float_as_uint(ea.x), __float_as_uint(eb.x));
        mma(yl[1], al, __float_as_uint(ea.y), __float_as_uint(eb.y));
        mma(yl[1], ah, __float_as_uint(ea.w), __float_as_uint(eb.w));
        mma(yh[1], ah, __float_as_uint(ea.y), __float_as_uint(eb.y));
      }
      // the lane's outputs: rows ra (0, 1) and rb (2, 3) at columns d (0, 2)
      // and d + 4 (1, 3) for h = 0, one column on for h = 1
      const int d = 16 * c + 8 * (tig & 1) + 2 * (tig >> 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? ra : rb;
        if (row < K) {
          *reinterpret_cast<float2*>(dzs + row * f.dk + d + 4 * (i & 1)) =
              make_float2(yh[0][i] + yl[0][i], yh[1][i] + yl[1][i]);
        }
      }
    }
    __syncthreads();

    // the x and u stages are free: the next row's loads land while this
    // row's dx, dS and reverse sweep run
    const int bn = b + G;
    int last_next = -1;
    float ms_next = 0.f;
    if (bn < B) {
      last_next = last_live(mv);
      ms_next = step_mask(mv);
      load_row(bn, last_next);
      if (bn + G < B) load_mask(bn + G, mv);
    }

    // dx = w_last^T dzs at the lane's columns of the tile's 16 steps (K
    // deep, fp32; 0 at a step with w = 0); a dead tile's rows are zeros
    float* dxb = dx + (static_cast<size_t>(b) * L + t0) * D;
    const int rows = min(kTile, L - t0);
    const bool bulk = D % 4 == 0 && D <= sd && reinterpret_cast<uintptr_t>(dx) % 16 == 0;
    if (live) {
#pragma unroll 1
      for (int d = lane; d < D; d += 32) {
        float y[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) y[r] = 0.f;
#pragma unroll 1
        for (int k0 = 0; k0 < kp; k0 += 4) {
          float dz[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) dz[kk] = k0 + kk < K ? dzs[(k0 + kk) * f.dk + d] : 0.f;
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const float4 wv = *reinterpret_cast<const float4*>(ws + r * kp + k0);
            y[r] = fmaf(wv.w, dz[3], fmaf(wv.z, dz[2], fmaf(wv.y, dz[1], fmaf(wv.x, dz[0], y[r]))));
          }
        }
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          if (r < rows) {
            if (bulk) uts[r * D + d] = y[r]; else dxb[r * D + d] = y[r];
          }
        }
      }
      if (bulk) {
        // the tile's rows are contiguous in dx: one bulk copy from the stage
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                       "cp.async.bulk.commit_group;\n" ::"l"(dxb), "r"(smem_addr(uts)), "r"(rows * D * 4)
                       : "memory");
        }
      }
    } else {
      for (int i = lane; i < rows * D; i += 32) dxb[i] = 0.f;
    }

    // dS += (w_last x)^T dz, K deep in fp32: a thread owns 4 x 8 blocks of
    // dS; w_last x is the live warps' partials added in warp order, and each
    // row's sum is added into the running dS
    if (nlive > 0) {
      const int eb_n = EP / 8;
#pragma unroll 1
      for (int i = threadIdx.x; i < (f.dk / 4) * eb_n; i += blockDim.x) {
        const int d0 = 4 * (i / eb_n), e0 = 8 * (i % eb_n);
        float acc[4][8];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
        }
#pragma unroll 1
        for (int k = 0; k < K; ++k) {
          float4 xw = *reinterpret_cast<const float4*>(xwall + static_cast<size_t>(k) * f.dk + d0);
#pragma unroll 1
          for (int w = 1; w < nlive; ++w) {
            const float4 v = *reinterpret_cast<const float4*>(xwall + (static_cast<size_t>(w) * K + k) * f.dk + d0);
            xw = make_float4(xw.x + v.x, xw.y + v.y, xw.z + v.z, xw.w + v.w);
          }
          const float4 g0 = *reinterpret_cast<const float4*>(caps + k * EP + e0);
          const float4 g1 = *reinterpret_cast<const float4*>(caps + k * EP + e0 + 4);
          const float xv[4] = {xw.x, xw.y, xw.z, xw.w};
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(xv[a], gv[c], acc[a][c]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4& run = dsr[((d0 + a) * EP + e0) / 4 + h];
            run = make_float4(run.x + acc[a][4 * h], run.y + acc[a][4 * h + 1], run.z + acc[a][4 * h + 2],
                              run.w + acc[a][4 * h + 3]);
          }
        }
      }
    }

    // the reverse sweep for dlogits0 on u's fragments: dw = dz u^T at the
    // warp's steps, the softmax VJP a step a lane into dlog (ws), and for
    // the earlier iterations dcaps = dlog u, their squash VJP, dw again
    if (live) {
      caps_dot_u<NT, false>(caps, u, dwb, K);
      __syncwarp();
      if (lane < kTile) softmax_vjp_step(dwb, ps + (iters - 1) * p_step, ws, kp, K, ms, false);
      __syncwarp();
    }
#pragma unroll 1
    for (int it = iters - 2; it >= 0; --it) {
      if (live) steps_times_u<NT, CPL>(ws, kp, uc, wparts, K);
      __syncthreads();
#pragma unroll 1
      for (int k = warp; k < K; k += W) {
        float dc[CPL], z[CPL], sq = 0.f;
        sum_partials<NT, CPL>(parts, k, nlive, W, K, dc);
        const float* zk = zs + (it * K + k) * EP;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          z[q] = lane + 32 * q < EP ? zk[lane + 32 * q] : 0.f;
          sq = fmaf(z[q], z[q], sq);
        }
        squash_vjp_lane<NT, CPL>(dc, z, warp_sum(sq), caps + k * EP);
      }
      __syncthreads();
      if (live) {
        caps_dot_u<NT, false>(caps, u, dwb, K);
        __syncwarp();
        if (lane < kTile) softmax_vjp_step(dwb, ps + it * p_step, ws, kp, K, ms, true);
        __syncwarp();
      }
    }
    if (lane < kTile && t0 + lane < L) {
      float* o = dl0 + static_cast<size_t>(b) * K * L + t0 + lane;
      for (int k = 0; k < K; ++k) o[static_cast<size_t>(k) * L] = live ? ws[lane * kp + k] : 0.f;
    }
    last = last_next;
    ms = ms_next;
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  // the block's partial of dS, once every thread's last update is in
  __syncthreads();
  float* part = partials + static_cast<size_t>(blockIdx.x) * D * E;
  for (int i = threadIdx.x; i < D * E; i += blockDim.x) {
    const int d = i / E;
    part[i] = smem[f.ds + static_cast<size_t>(d) * EP + i - d * E];
  }
}

using FwdKernel = void (*)(const float*, const float*, const float*, const float*, float*, int, int,
                           int, int, int, int, long);

FwdKernel fwd_kernel(int E) {
  switch (fwd_nt(E)) {
    case 1: return capsule_routing_kernel<1>;
    case 2: return capsule_routing_kernel<2>;
    case 4: return capsule_routing_kernel<4>;
    case 6: return capsule_routing_kernel<6>;
    case 8: return capsule_routing_kernel<8>;
    case 12: return capsule_routing_kernel<12>;
    case 16: return capsule_routing_kernel<16>;
    default: return nullptr;
  }
}

using BwdKernel = void (*)(const float*, const float*, const float*, const float*, const float*, float*,
                           float*, float*, int, int, int, int, int, int, long);

BwdKernel bwd_tc_kernel(int E) {
  switch (fwd_nt(E)) {
    case 1: return capsule_routing_bwd_tc_kernel<1>;
    case 2: return capsule_routing_bwd_tc_kernel<2>;
    case 4: return capsule_routing_bwd_tc_kernel<4>;
    case 6: return capsule_routing_bwd_tc_kernel<6>;
    case 8: return capsule_routing_bwd_tc_kernel<8>;
    case 12: return capsule_routing_bwd_tc_kernel<12>;
    case 16: return capsule_routing_bwd_tc_kernel<16>;
    default: return nullptr;
  }
}

bool valid(int B, int L, int D, int E, int K, int iters) {
  return B >= 1 && L >= 1 && D >= 1 && E >= 1 && K >= 1 && iters >= 1;
}

// the backward takes the tensor-core kernel: E and L within its builds and
// its shared memory within a block's; else the fp32-FMA kernel
bool bwd_on_tensor_cores(int L, int D, int E, int K, int iters) {
  return bwd_tc_kernel(E) != nullptr && L <= kTile * kMaxTiles &&
         bwd_layout(L, D, E, K, iters).total * sizeof(float) <= kMaxSmemBytes;
}

// The blocks of `threads` threads and `smem` bytes the card holds at once
// (0: none fits an SM), or a negated cudaError_t. It first lets the kernel
// use all of a block's shared memory, so that no launch sets an attribute.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block of the forward needs; the
// wrapper checks it against the card's per-block limit before launching.
size_t capsule_routing_smem_bytes(int L, int D, int E, int K) {
  return fwd_layout(L, D, E, K).total * sizeof(float);
}

// Dynamic shared memory (bytes) one block of the backward's fp32-FMA
// kernel needs. That kernel takes every shape the tensor-core kernel does
// not, so the wrapper refuses the shapes whose count passes a block's limit.
size_t capsule_routing_bwd_smem_bytes(int L, int D, int E, int K, int iters) {
  return bwd_floats(make_dims(L, D, E, K, iters)) * sizeof(float);
}

// The backward's kernel for a shape: 1 the tensor-core kernel, 0 the
// fp32-FMA one.
int capsule_routing_bwd_route(int L, int D, int E, int K, int iters) {
  return valid(1, L, D, E, K, iters) && bwd_on_tensor_cores(L, D, E, K, iters) ? 1 : 0;
}

// Blocks of the backward's main pass the card holds at once for these
// widths (the most its grid needs), or a negated cudaError_t. The wrapper
// asks once a shape and device and sizes the partials buffer (min(B,
// blocks) x D x E floats) from the answer.
int capsule_routing_bwd_blocks(int L, int D, int E, int K, int iters) {
  if (!valid(1, L, D, E, K, iters)) return -static_cast<int>(cudaErrorInvalidValue);
  if (bwd_on_tensor_cores(L, D, E, K, iters)) {
    const BwdLayout f = bwd_layout(L, D, E, K, iters);
    return resident_blocks(bwd_tc_kernel(E), 32 * f.tiles, f.total * sizeof(float));
  }
  return resident_blocks(capsule_routing_bwd_fma_kernel, kThreads, capsule_routing_bwd_smem_bytes(L, D, E, K, iters));
}

// Blocks of the forward the card holds at once for these widths (the
// most its grid needs), or a negated cudaError_t; 0 for a shape the kernel
// is not built for (E > 128, L > 128). The wrapper asks once a shape and
// device.
int capsule_routing_blocks(int L, int D, int E, int K) {
  const FwdKernel kernel = fwd_kernel(E);
  if (kernel == nullptr || L < 1 || L > kTile * kMaxTiles || D < 1 || K < 1) return 0;
  return resident_blocks(kernel, 32 * fwd_layout(L, D, E, K).tiles, capsule_routing_smem_bytes(L, D, E, K));
}

// Returns a cudaError_t (0 = launched). x, mask, s and out are contiguous
// fp32 device arrays; logits0 holds (K, L) contiguous for each row, rows
// l0_stride floats apart (0 = one slice for every row). blocks is
// capsule_routing_blocks' answer for the shape; the grid is min(B, blocks).
int capsule_routing_forward(const float* x, const float* mask, const float* s, const float* l0,
                            long l0_stride, float* out, int B, int L, int D, int E, int K,
                            int iters, int blocks, void* stream) {
  const FwdKernel kernel = fwd_kernel(E);
  if (!valid(B, L, D, E, K, iters) || kernel == nullptr || L > kTile * kMaxTiles || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdLayout f = fwd_layout(L, D, E, K);
  kernel<<<blocks < B ? blocks : B, 32 * f.tiles, f.total * sizeof(float),
           static_cast<cudaStream_t>(stream)>>>(x, mask, s, l0, out, B, L, D, E, K, iters, l0_stride);
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t (0 = both passes launched). The forward's inputs and
// g (B, K, E), contiguous fp32 device arrays but for logits0 as above;
// blocks is capsule_routing_bwd_blocks' answer for the shape, the grid
// min(B, blocks), and partials holds grid x D x E floats.
int capsule_routing_backward(const float* x, const float* mask, const float* s, const float* l0,
                             long l0_stride, const float* g, float* dx, float* ds, float* dl0,
                             float* partials, int B, int L, int D, int E, int K, int iters,
                             int blocks, void* stream) {
  if (!valid(B, L, D, E, K, iters) || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks < B ? blocks : B;
  if (bwd_on_tensor_cores(L, D, E, K, iters)) {
    const BwdLayout f = bwd_layout(L, D, E, K, iters);
    bwd_tc_kernel(E)<<<grid, 32 * f.tiles, f.total * sizeof(float), st>>>(
        x, mask, s, l0, g, dx, dl0, partials, B, L, D, E, K, iters, l0_stride);
  } else {
    capsule_routing_bwd_fma_kernel<<<grid, kThreads, capsule_routing_bwd_smem_bytes(L, D, E, K, iters), st>>>(
        x, mask, s, l0, g, dx, dl0, partials, B, L, D, E, K, iters, l0_stride);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = D * E;
  capsule_routing_bwd_reduce<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
      partials, grid, n, ds);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
