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
// What bounds it on an H100. At the slice's shape (B=8192, L=64, D=E=64,
// K=4, 3 iterations) the forward reads x (134 MB) and writes (B, K, E),
// ~153 MB: 0.046 ms at 3.35 TB/s, against ~5.6 GFLOP, of which u = x S is
// 4.3: 0.084 ms at 67 TFLOP/s in fp32 without the tensor cores. So it is
// bound by operations; the backward (u again, dx and dS: three L D E
// products a row, ~15.8 GFLOP) even more: ~0.24 ms against ~0.088 ms of
// bytes. Those count every step; a masked step needs no work (w = 0 there),
// so chip_smoke.py counts the live steps of its mask, which it computes
// from the run's inputs. This kernel still works on every step.
//
// Design: the TPU kernel keeps u in VMEM across the iterations; here a
// block keeps one row's x, u (and in the backward du) in shared memory with
// S beside them, so nothing but x, the mask, logits0 (and g) is read and
// nothing but the outputs is written. Each product is a register-tiled
// loop over shared memory (a thread owns up to 4 x 4 outputs, every operand
// loaded once per step of the reduction), with every array's row stride
// made odd so that the walks along either dimension are free of bank
// conflicts. The routing itself (softmax over K per step, the squash per
// capsule with a warp reduction) is a few percent of the work. Blocks walk
// the rows with a grid stride, as many blocks as fit on the card at once,
// so S is loaded once per block. logits0 may repeat one (K, L) slice for
// every row (batch stride 0), as the model's fixed routing init does.
//
// The sum of dS over rows. The TPU grid runs in order and accumulates dS in
// place (:898-904); blocks on Hopper run in no order. Each block keeps its
// running dS in shared memory, each element owned by one thread, and writes
// one partial into a scratch buffer the wrapper allocates (torch.empty); a
// second kernel adds the partials in block order. No atomics: the same bits
// on every call.
//
// It is a first, simple kernel: fp32 FMA from shared memory, no tensor
// cores and no overlap of the next row's load with this row's work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
constexpr float kNeg = -1e9f;
constexpr float kEps = 1e-9f;

// an odd row stride: walks along a row or down a column hit distinct banks
__host__ __device__ inline int odd(int x) { return x | 1; }

struct Dims {
  int L, D, E, K, iters;
  int Dp, Ep;  // row strides of x (L, Dp) and of S, u, du, dS (., Ep)
};

__host__ __device__ inline Dims make_dims(int L, int D, int E, int K, int iters) {
  return Dims{L, D, E, K, iters, odd(D), odd(E)};
}

// Shared memory of the forward, in floats: S, x, u; mask; logits, w; z, caps; sq.
__host__ __device__ inline size_t fwd_floats(const Dims& d) {
  return static_cast<size_t>(d.D) * d.Ep + static_cast<size_t>(d.L) * d.Dp +
         static_cast<size_t>(d.L) * d.Ep + d.L + 2 * static_cast<size_t>(d.K) * d.L +
         2 * static_cast<size_t>(d.K) * d.E + d.K;
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

__global__ void __launch_bounds__(kThreads) capsule_routing_kernel(
    const float* __restrict__ x,      // (B, L, D)
    const float* __restrict__ mask,   // (B, L)
    const float* __restrict__ s,      // (D, E)
    const float* __restrict__ l0,     // (B, K, L), batch stride l0_stride
    float* __restrict__ out,          // (B, K, E)
    int B, int L, int D, int E, int K, int iters, long l0_stride) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = make_dims(L, D, E, K, iters);
  float* s_s = smem;                    // (D, Ep)
  float* x_s = s_s + D * d.Ep;          // (L, Dp)
  float* u_s = x_s + L * d.Dp;          // (L, Ep)
  float* mask_s = u_s + L * d.Ep;       // (L,)
  float* logit_s = mask_s + L;          // (K, L)
  float* w_s = logit_s + K * L;         // (K, L)
  float* z_s = w_s + K * L;             // (K, E)
  float* caps_s = z_s + K * E;          // (K, E)
  float* sq_s = caps_s + K * E;         // (K,)

  load_s(s, s_s, d);
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    load_row(x + static_cast<size_t>(b) * L * D, mask + static_cast<size_t>(b) * L,
             l0 + b * l0_stride, x_s, mask_s, logit_s, d);
    __syncthreads();
    block_gemm<4, 4>(x_s, d.Dp, 1, s_s, d.Ep, 1, u_s, d.Ep, 1, L, E, D, false);
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      const bool last = it == iters - 1;
      route_softmax(logit_s, mask_s, nullptr, w_s, K, L);
      __syncthreads();
      block_gemm<1, 1>(w_s, L, 1, u_s, d.Ep, 1, z_s, E, 1, K, E, L, false);
      __syncthreads();
      row_dots(z_s, z_s, sq_s, K, E);
      __syncthreads();
      squash_rows(z_s, sq_s, last ? out + static_cast<size_t>(b) * K * E : caps_s, K, E);
      __syncthreads();
      if (!last) {
        // logits += caps u^T: B(e, l) = u[l, e]
        block_gemm<1, 1>(caps_s, E, 1, u_s, 1, d.Ep, logit_s, L, 1, K, L, E, true);
        __syncthreads();
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) capsule_routing_bwd_kernel(
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

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// as many blocks as fit on the card at once, at most B; or a negated error
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int B) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long n = static_cast<long>(per_sm > 0 ? per_sm : 1) * sms;
  return static_cast<int>(n < B ? n : B);
}

bool valid(int B, int L, int D, int E, int K, int iters) {
  return B >= 1 && L >= 1 && D >= 1 && E >= 1 && K >= 1 && iters >= 1;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block of the forward / backward needs;
// the wrapper checks it against the card's per-block limit before launching.
size_t capsule_routing_smem_bytes(int L, int D, int E, int K, int iters) {
  return fwd_floats(make_dims(L, D, E, K, iters)) * sizeof(float);
}

size_t capsule_routing_bwd_smem_bytes(int L, int D, int E, int K, int iters) {
  return bwd_floats(make_dims(L, D, E, K, iters)) * sizeof(float);
}

// Blocks of the backward's main pass, or a negated cudaError_t. The wrapper
// sizes the partials buffer (blocks x D x E floats) from it.
int capsule_routing_bwd_blocks(int B, int L, int D, int E, int K, int iters) {
  if (!valid(B, L, D, E, K, iters)) return -static_cast<int>(cudaErrorInvalidValue);
  return resident_blocks(capsule_routing_bwd_kernel,
                         capsule_routing_bwd_smem_bytes(L, D, E, K, iters), B);
}

// Returns a cudaError_t (0 = launched). x, mask, s and out are contiguous
// fp32 device arrays; logits0 holds (K, L) contiguous for each row, rows
// l0_stride floats apart (0 = one slice for every row).
int capsule_routing_forward(const float* x, const float* mask, const float* s, const float* l0,
                            long l0_stride, float* out, int B, int L, int D, int E, int K,
                            int iters, void* stream) {
  if (!valid(B, L, D, E, K, iters)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = capsule_routing_smem_bytes(L, D, E, K, iters);
  const int blocks = resident_blocks(capsule_routing_kernel, smem, B);
  if (blocks < 1) return blocks < 0 ? -blocks : static_cast<int>(cudaErrorInvalidValue);
  capsule_routing_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, mask, s, l0, out, B, L, D, E, K, iters, l0_stride);
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t (0 = both passes launched). The forward's inputs and
// g (B, K, E), contiguous fp32 device arrays but for logits0 as above;
// partials holds blocks x D x E floats, blocks from capsule_routing_bwd_blocks.
int capsule_routing_backward(const float* x, const float* mask, const float* s, const float* l0,
                             long l0_stride, const float* g, float* dx, float* ds, float* dl0,
                             float* partials, int B, int L, int D, int E, int K, int iters,
                             int blocks, void* stream) {
  if (!valid(B, L, D, E, K, iters) || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = capsule_routing_bwd_smem_bytes(L, D, E, K, iters);
  cudaError_t err = set_smem(capsule_routing_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  capsule_routing_bwd_kernel<<<blocks, kThreads, smem, st>>>(
      x, mask, s, l0, g, dx, dl0, partials, B, L, D, E, K, iters, l0_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = D * E;
  capsule_routing_bwd_reduce<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
      partials, blocks, n, ds);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
