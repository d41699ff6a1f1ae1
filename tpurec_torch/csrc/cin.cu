// CIN (the xDeepFM compressed interaction network) forward for Hopper
// (sm_90a), fp32, every level in one launch.
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:cin_fused
// (_cin_kernel). Same function as cin_reference: with x_0 = e (B, F, D) and
// one weight W_l (H_l*F, S_l) per level (H_0 = F, H_{l+1} = S_l),
//
//   x_{l+1}[b, s, d] = sum_{h, f} W_l[h*F + f, s] * x_l[b, h, d] * e[b, f, d]
//   out[b, off_l + s] = sum_d x_{l+1}[b, s, d]        (off_l = S_0 + ... + S_{l-1})
//
// What bounds it on an H100: operations. At the xDeepFM serving shape (B=8192,
// F=26, D=32, sizes (128, 128)) one call is ~272 GFLOP of fp32 multiply-adds
// (45 for level 1, 223 for level 2), ~4 ms at 67 TFLOP/s without tensor
// cores, against ~30 MB of inputs and outputs (~9 us at 3.35 TB/s). The plain
// version materialises z = (B, H*F, D) for every level, 3.5 GB at level 2.
//
// Design: each level is a matrix product over the rows m = (b, d),
//   y[m, s] = sum_k A[m, k] * W_l[k, s],   A[m, h*F + f] = x_l[m, h] * e[m, f],
// whose A is never stored: a block owns Bt = 128 / D batch rows (M = Bt*D
// rows, all of D, so that the sum over d stays in the block) and keeps e and
// the level's x in shared memory, column-major (one row of shared memory per
// field or map, padded to an odd stride). A block tile is 128 rows x 128
// columns of y, computed by 256 threads holding 8 x 8 accumulators each; for
// each map h a thread loads its 8 rows of x_l[:, h] once, and for each field
// f forms the 8 products x*e and does 64 FMAs against 8 weights from shared
// memory (a broadcast across the warp). The weights stream from L2 one map's
// (F, 128) slice at a time, double-buffered with cp.async so the next slice
// is in flight while the current one is used. With M = 128 rows a block,
// each weight element loaded is used 128 times. The new map y stays in
// shared memory as the next level's x; its column sums over d are the
// level's slice of the output. No intermediate leaves the block.
//
// Any F, D and level sizes: rows past the batch are zero (so they add
// nothing), columns past S are skipped, and the wrapper refuses shapes whose
// shared memory does not fit one block. fp32 FMA only: tensor-core (TF32 or
// bf16) products are a later change.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;     // rows and columns of a block tile
constexpr int kTM = 8;         // rows of a thread tile
constexpr int kTN = 8;         // columns of a thread tile
constexpr int kMaxLevels = 8;

struct Levels {
  int n;
  int sizes[kMaxLevels];
};

__host__ __device__ inline int rows_per_block(int D) { return D >= kTile ? 1 : kTile / D; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// One map's slice of W_l, rows h*F .. h*F+F-1, columns ct .. ct+127, into
// dst (F, kTile); columns past S are zero.
__device__ inline void load_w_slice(float* dst, const float* wl, int h, int F, int S, int ct,
                                    int tid) {
  const float* src = wl + static_cast<size_t>(h) * F * S + ct;
  for (int i = tid; i < F * kTile; i += kThreads) {
    const int f = i / kTile;
    const int c = i % kTile;
    if (ct + c < S) {
      cp_async4(dst + i, src + static_cast<size_t>(f) * S + c);
    } else {
      dst[i] = 0.f;
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads) cin_kernel(
    const float* __restrict__ emb,  // (B, F, D)
    const float* __restrict__ w,    // every W_l, flattened one after another
    float* __restrict__ out,        // (B, sum S_l)
    Levels lv, int B, int F, int D, int smax, int total_s) {
  extern __shared__ __align__(16) float smem[];
  const int bt = rows_per_block(D);
  const int mb = bt * D;                // live rows of the block
  const int mr = round_up(mb, kTile);   // rows computed
  const int mp = mr + 1;                // odd stride of a shared-memory row
  float* e_s = smem;                    // (F, mp): e[m, f] at f*mp + m
  float* buf0 = e_s + F * mp;           // (smax, mp)
  float* buf1 = buf0 + smax * mp;       // (smax, mp)
  float* w_s0 = buf1 + smax * mp;       // (F, kTile)
  float* w_s1 = w_s0 + F * kTile;       // (F, kTile)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b0 = blockIdx.x * bt;
  const int nb = min(bt, B - b0);

  // e: the block's rows are contiguous in emb; row m = bl*D + d of field f
  const float* e_g = emb + static_cast<size_t>(b0) * F * D;
  for (int i = tid; i < bt * F * D; i += kThreads) {
    const int bl = i / (F * D);
    const int r = i % (F * D);
    const int f = r / D;
    const int d = r % D;
    e_s[f * mp + bl * D + d] = bl < nb ? __ldg(e_g + i) : 0.f;
  }
  for (int i = tid; i < F * (mr - mb); i += kThreads) {
    e_s[(i / (mr - mb)) * mp + mb + i % (mr - mb)] = 0.f;
  }

  const float* x = e_s;
  float* y = buf0;
  const float* wl = w;
  int h_count = F;
  int off = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int S = lv.sizes[l];
    for (int rt = 0; rt < mr; rt += kTile) {
      for (int ct = 0; ct < S; ct += kTile) {
        float acc[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
        }
        __syncthreads();  // the previous tile is done with both weight buffers
        load_w_slice(w_s0, wl, 0, F, S, ct, tid);
        for (int h = 0; h < h_count; ++h) {
          cp_async_wait_all();
          __syncthreads();  // slice h is in; every thread is done with slice h-1
          const float* w_cur = (h & 1) ? w_s1 : w_s0;
          if (h + 1 < h_count) load_w_slice((h & 1) ? w_s0 : w_s1, wl, h + 1, F, S, ct, tid);
          float xv[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) xv[i] = x[h * mp + rt + ty + 16 * i];
          for (int f = 0; f < F; ++f) {
            float a[kTM];
            float wv[kTN];
#pragma unroll
            for (int i = 0; i < kTM; ++i) a[i] = xv[i] * e_s[f * mp + rt + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kTN; ++j) wv[j] = w_cur[f * kTile + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int s = ct + tx + 16 * j;
          if (s < S) {
#pragma unroll
            for (int i = 0; i < kTM; ++i) y[s * mp + rt + ty + 16 * i] = acc[i][j];
          }
        }
      }
    }
    __syncthreads();  // y is complete
    // this level's slice of the output: sum over d of each (b, s)
    for (int i = tid; i < nb * S; i += kThreads) {
      const int bl = i / S;
      const int s = i % S;
      const float* row = y + s * mp + bl * D;
      float sum = 0.f;
      for (int d = 0; d < D; ++d) sum += row[d];
      out[static_cast<size_t>(b0 + bl) * total_s + off + s] = sum;
    }
    off += S;
    wl += static_cast<size_t>(h_count) * F * S;
    h_count = S;
    x = y;
    y = (y == buf0) ? buf1 : buf0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block needs; the wrapper checks it
// against the card's per-block limit before launching.
size_t cin_smem_bytes(int F, int D, int smax) {
  const size_t mp = round_up(rows_per_block(D) * D, kTile) + 1;
  return sizeof(float) * (static_cast<size_t>(F) * mp + 2 * static_cast<size_t>(smax) * mp +
                          2 * static_cast<size_t>(F) * kTile);
}

// Returns a cudaError_t (0 = launched). w holds every level's weight, each
// (H_l*F, S_l) row-major, one after another; sizes[l] = S_l, at most
// kMaxLevels (8) levels. Every pointer is a contiguous fp32 device array;
// out is (B, sum S_l).
int cin_forward(const float* emb, const float* w, const int* sizes, int num_levels, float* out,
                int B, int F, int D, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || B < 1 || F < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  lv.n = num_levels;
  int smax = 1;
  int total_s = 0;
  for (int l = 0; l < kMaxLevels; ++l) lv.sizes[l] = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (sizes[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    lv.sizes[l] = sizes[l];
    smax = sizes[l] > smax ? sizes[l] : smax;
    total_s += sizes[l];
  }
  const size_t smem = cin_smem_bytes(F, D, smax);
  cudaError_t err = cudaFuncSetAttribute(cin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bt = rows_per_block(D);
  const int blocks = (B + bt - 1) / bt;
  cin_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      emb, w, out, lv, B, F, D, smax, total_s);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
