// SENet reweighting followed by 'all'-mode bilinear field-pair products
// (the FiBiNET hot path) for Hopper (sm_90a), fp32, in one launch.
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:
// senet_bilinear_fused (_senet_bilinear_kernel). Same function as
// senet_bilinear_reference, per batch row with e (F, D):
//
//   z[f]     = mean_d e[f, d]
//   a1       = relu(z . W1 + b1)                 (R,)   W1 (F, R)
//   a2       = relu(a1 . W2 + b2)                (F,)   W2 (R, F)
//   v[f, :]  = a2[f] * e[f, :]
//   left     = v . Wb                            (F, D) Wb (D, D)
//   out[p, :] = left[i_p, :] * v[j_p, :]         p over i < j, np.triu_indices order
//
// What bounds it on an H100: bytes, and nearly all of them the output. At
// FiBiNET's serving shape (B=8192, F=26, D=32, so P=325 pairs, R=8) it reads
// 27 MB and writes (B, P, D) fp32 = 341 MB: ~0.110 ms at 3.35 TB/s, against
// ~0.5 GFLOP (~8 us at 67 TFLOP/s).
//
// Design: so the kernel runs at the write rate, everything before the
// output stays in shared memory and the output is written once, in order.
// A block takes a few batch rows (about 4k elements of e), stages them with
// Wb, W1, W2 and the biases in shared memory, and computes the squeeze, the
// two small relu layers, v and left = v . Wb there (one thread per element of
// left, D multiply-adds each, Wb read across the warp without conflicts).
// The pair table (i_p, j_p) is built once per block in shared memory. Then
// the block's rows of the output, which are contiguous in device memory, are
// written with neighbouring threads on neighbouring addresses (streaming
// stores: the output is not read back by this kernel). Pairs go straight to
// (B, P, D); the TPU kernel's (B, D, P) layout and its swap are not carried
// over.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;
constexpr int kRowElems = 4096;  // about this many elements of e a block

__host__ __device__ inline int rows_per_block(int F, int D) {
  const int r = kRowElems / (F * D);
  return r < 1 ? 1 : (r > kMaxRows ? kMaxRows : r);
}

__host__ __device__ inline size_t smem_floats(int F, int D, int R, int rows, int P) {
  // wb, w1, w2, b1, b2, the pair table (two ints a pair), and per row:
  // v (F*D), left (F*D), z (F), a1 (R), a2 (F)
  return static_cast<size_t>(D) * D + 2 * static_cast<size_t>(F) * R + R + F + 2 * P +
         static_cast<size_t>(rows) * (2 * static_cast<size_t>(F) * D + 2 * F + R);
}

__global__ void __launch_bounds__(kThreads) senet_bilinear_kernel(
    const float* __restrict__ emb,  // (B, F, D)
    const float* __restrict__ w1,   // (F, R)
    const float* __restrict__ b1,   // (R,)
    const float* __restrict__ w2,   // (R, F)
    const float* __restrict__ b2,   // (F,)
    const float* __restrict__ wb,   // (D, D)
    float* __restrict__ out,        // (B, P, D)
    int B, int F, int D, int R, int P, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* wb_s = smem;                     // (D, D)
  float* w1_s = wb_s + D * D;             // (F, R)
  float* w2_s = w1_s + F * R;             // (R, F)
  float* b1_s = w2_s + R * F;             // (R,)
  float* b2_s = b1_s + R;                 // (F,)
  int* pi_s = reinterpret_cast<int*>(b2_s + F);  // (P,)
  int* pj_s = pi_s + P;                   // (P,)
  float* v_s = reinterpret_cast<float*>(pj_s + P);  // (rows, F, D)
  float* left_s = v_s + rows * F * D;     // (rows, F, D)
  float* z_s = left_s + rows * F * D;     // (rows, F)
  float* a1_s = z_s + rows * F;           // (rows, R)
  float* a2_s = a1_s + rows * R;          // (rows, F)

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * rows;
  const int nb = min(rows, B - b0);
  const int fd = F * D;

  for (int i = tid; i < D * D; i += kThreads) wb_s[i] = __ldg(wb + i);
  for (int i = tid; i < F * R; i += kThreads) {
    w1_s[i] = __ldg(w1 + i);
    w2_s[i] = __ldg(w2 + i);
  }
  for (int i = tid; i < R; i += kThreads) b1_s[i] = __ldg(b1 + i);
  for (int i = tid; i < F; i += kThreads) b2_s[i] = __ldg(b2 + i);
  // pairs i < j, row-major: anchor i's pairs start at i*(F-1) - i*(i-1)/2
  for (int i = tid; i < F - 1; i += kThreads) {
    int p = i * (F - 1) - i * (i - 1) / 2;
    for (int j = i + 1; j < F; ++j, ++p) {
      pi_s[p] = i;
      pj_s[p] = j;
    }
  }
  const float* e_g = emb + static_cast<size_t>(b0) * fd;
  for (int i = tid; i < nb * fd; i += kThreads) v_s[i] = __ldg(e_g + i);
  __syncthreads();

  // squeeze: the mean over d of each field
  for (int i = tid; i < nb * F; i += kThreads) {
    const float* row = v_s + i * D;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += row[d];
    z_s[i] = s / static_cast<float>(D);
  }
  __syncthreads();
  for (int i = tid; i < nb * R; i += kThreads) {
    const int r = i / R;
    const int k = i % R;
    float s = b1_s[k];
    for (int f = 0; f < F; ++f) s = fmaf(z_s[r * F + f], w1_s[f * R + k], s);
    a1_s[i] = fmaxf(s, 0.f);
  }
  __syncthreads();
  for (int i = tid; i < nb * F; i += kThreads) {
    const int r = i / F;
    const int f = i % F;
    float s = b2_s[f];
    for (int k = 0; k < R; ++k) s = fmaf(a1_s[r * R + k], w2_s[k * F + f], s);
    a2_s[i] = fmaxf(s, 0.f);
  }
  __syncthreads();
  // v = a2 * e, in place
  for (int i = tid; i < nb * fd; i += kThreads) v_s[i] *= a2_s[i / D];
  __syncthreads();
  // left[r, f, c] = sum_d v[r, f, d] * wb[d, c]
  for (int i = tid; i < nb * fd; i += kThreads) {
    const int c = i % D;
    const float* vrow = v_s + (i - c);
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(vrow[d], wb_s[d * D + c], s);
    left_s[i] = s;
  }
  __syncthreads();

  // the block's rows of (B, P, D) are one contiguous run: written in order
  const int pd = P * D;
  const int step_p = kThreads / D;
  const int step_d = kThreads % D;
  for (int r = 0; r < nb; ++r) {
    const float* lr = left_s + r * fd;
    const float* vr = v_s + r * fd;
    float* o = out + static_cast<size_t>(b0 + r) * pd;
    int p = tid / D;
    int d = tid % D;
    for (int i = tid; i < pd; i += kThreads) {
      __stcs(o + i, lr[pi_s[p] * D + d] * vr[pj_s[p] * D + d]);
      d += step_d;
      p += step_p;
      if (d >= D) {
        d -= D;
        ++p;
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block needs; the wrapper checks it
// against the card's per-block limit before launching.
size_t senet_bilinear_smem_bytes(int F, int D, int R) {
  const int P = F * (F - 1) / 2;
  return sizeof(float) * smem_floats(F, D, R, rows_per_block(F, D), P);
}

// Returns a cudaError_t (0 = launched). Every pointer is a contiguous fp32
// device array; out is (B, F(F-1)/2, D). Needs F >= 2 and B >= 1.
int senet_bilinear_forward(const float* emb, const float* w1, const float* b1, const float* w2,
                           const float* b2, const float* wb, float* out, int B, int F, int D,
                           int R, void* stream) {
  if (B < 1 || F < 2 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int P = F * (F - 1) / 2;
  const int rows = rows_per_block(F, D);
  const size_t smem = senet_bilinear_smem_bytes(F, D, R);
  cudaError_t err = cudaFuncSetAttribute(
      senet_bilinear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + rows - 1) / rows;
  senet_bilinear_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      emb, w1, b1, w2, b2, wb, out, B, F, D, R, P, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
