// DIN target attention forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:
// din_attention_fused (_din_kernel). Same function as din_attention_reference:
//
//   feats_l  = [q, q - k_l, k_l, q * k_l]                 (never materialised)
//   lin_l    = feats_l @ W1 + b1                          (H,)
//   score_l  = mask_l != 0 ? PReLU_alpha(lin_l) . w2 : 0
//   pooled   = sum_l score_l * k_l                        (D,)
//
// W1 (4D, H) splits into three D x H blocks (kernels.py:331-333):
//   w_q = W1[0:D] + W1[D:2D],  w_k = W1[2D:3D] - W1[D:2D],  w_p = W1[3D:4D]
// so lin_l = q.w_q + b1 + k_l.w_k + (q*k_l).w_p. Per batch row this design folds
// the q-dependent terms once:
//   c      = q.w_q + b1                     (H,)
//   W_eff  = w_k + diag(q) w_p              (D, H)
//   lin_l  = c + k_l . W_eff
// which halves the per-step work to one D x H product per sequence step.
//
// What bounds it on an H100 at the serving shape (B=8192, L=64, D=32, H=36,
// lengths uniform in L/4..L, so ~62.5 % of the steps are live; a masked
// step's score is 0 and adds nothing to pooled): the keys of the live steps
// are ~42 MB of the ~48 MB the function must move (~14 us at 3.35 TB/s); the
// folded arithmetic at live steps is ~0.9 GFLOP of fp32 FMA (~13.5 us at
// 67 TFLOP/s without tensor cores). The two are close, so the design keeps
// both lean: keys are read from device memory exactly once (coalesced 16-byte
// loads into shared memory), the (B, L, 4D) and (B, L, H) intermediates never
// leave registers, and the inner loop is register-blocked (each thread holds
// its step's key row in registers and reads W_eff as broadcast float4 from
// shared memory: one 16-byte shared load per four FMAs). It reads and scores
// every step, masked or not. Skipping the masked steps and moving the D x H
// products onto the tensor cores are left for a later change.
//
// Layout: one thread block per batch row, one thread per sequence step (a
// loop over steps when L exceeds the block). Shared memory holds the row's
// keys (padded to D+1 floats a row, so threads reading their own rows hit
// distinct banks), W_eff, c, w2, alpha, q and the row's scores.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

template <int D>
__global__ void __launch_bounds__(kThreads) din_attention_kernel(
    const float* __restrict__ query,  // (B, D)
    const float* __restrict__ keys,   // (B, L, D)
    const float* __restrict__ mask,   // (B, L)
    const float* __restrict__ w1,     // (4D, H)
    const float* __restrict__ b1,     // (H,)
    const float* __restrict__ w2,     // (H,)
    const float* __restrict__ alpha,  // (H,)
    float* __restrict__ pooled,       // (B, D)
    float* __restrict__ scores,       // (B, L)
    int L, int H) {
  extern __shared__ __align__(16) float smem[];
  const int hp = round_up4(H);
  float* weff_s = smem;              // (D, hp), 16-byte aligned rows
  float* c_s = weff_s + D * hp;      // (hp,)
  float* w2_s = c_s + hp;            // (hp,)
  float* a_s = w2_s + hp;            // (hp,)
  float* q_s = a_s + hp;             // (D,)
  float* s_s = q_s + D;              // (L,)
  float* k_s = s_s + L;              // (L, D + 1)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* q_row = query + static_cast<size_t>(b) * D;
  const float* k_row = keys + static_cast<size_t>(b) * L * D;

  for (int d = tid; d < D; d += kThreads) q_s[d] = q_row[d];
  // keys: coalesced 16-byte loads (D is a multiple of 4), padded rows in smem
  const float4* k4 = reinterpret_cast<const float4*>(k_row);
  for (int i = tid; i < L * D / 4; i += kThreads) {
    const float4 v = __ldg(k4 + i);
    const int l = (4 * i) / D;
    const int d = (4 * i) % D;
    float* dst = k_s + l * (D + 1) + d;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __syncthreads();

  // fold the q-dependent terms: W_eff = w_k + diag(q) w_p, c = q.w_q + b1
  for (int i = tid; i < D * hp; i += kThreads) {
    const int d = i / hp;
    const int h = i % hp;
    float v = 0.f;
    if (h < H) {
      const float wk = __ldg(w1 + (2 * D + d) * H + h) - __ldg(w1 + (D + d) * H + h);
      v = fmaf(q_s[d], __ldg(w1 + (3 * D + d) * H + h), wk);
    }
    weff_s[i] = v;
  }
  for (int h = tid; h < hp; h += kThreads) {
    float c = 0.f, w = 0.f, a = 0.f;
    if (h < H) {
      c = __ldg(b1 + h);
      for (int d = 0; d < D; ++d) {
        c = fmaf(q_s[d], __ldg(w1 + d * H + h) + __ldg(w1 + (D + d) * H + h), c);
      }
      w = __ldg(w2 + h);
      a = __ldg(alpha + h);
    }
    c_s[h] = c;  // padded columns: lin = 0 -> hidden 0 -> w2 0, no contribution
    w2_s[h] = w;
    a_s[h] = a;
  }
  __syncthreads();

  for (int l = tid; l < L; l += kThreads) {
    float k[D];
#pragma unroll
    for (int d = 0; d < D; ++d) k[d] = k_s[l * (D + 1) + d];
    float s = 0.f;
    for (int h = 0; h < hp; h += 4) {
      float4 acc = *reinterpret_cast<const float4*>(c_s + h);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float4 w = *reinterpret_cast<const float4*>(weff_s + d * hp + h);
        acc.x = fmaf(k[d], w.x, acc.x);
        acc.y = fmaf(k[d], w.y, acc.y);
        acc.z = fmaf(k[d], w.z, acc.z);
        acc.w = fmaf(k[d], w.w, acc.w);
      }
      const float lin[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float hidden = fmaxf(lin[j], 0.f) + a_s[h + j] * fminf(lin[j], 0.f);
        s = fmaf(hidden, w2_s[h + j], s);
      }
    }
    s = mask[static_cast<size_t>(b) * L + l] != 0.f ? s : 0.f;
    s_s[l] = s;
    scores[static_cast<size_t>(b) * L + l] = s;
  }
  __syncthreads();

  for (int d = tid; d < D; d += kThreads) {
    float p = 0.f;
    for (int l = 0; l < L; ++l) p = fmaf(s_s[l], k_s[l * (D + 1) + d], p);
    pooled[static_cast<size_t>(b) * D + d] = p;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* m, const float* w1,
                   const float* b1, const float* w2, const float* alpha, float* pooled,
                   float* scores, int B, int L, int H, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      din_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  din_attention_kernel<D><<<B, kThreads, smem, stream>>>(
      q, k, m, w1, b1, w2, alpha, pooled, scores, L, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block needs; the wrapper checks it
// against the card's per-block limit before launching.
size_t din_attention_smem_bytes(int L, int D, int H) {
  const int hp = round_up4(H);
  return sizeof(float) *
         (static_cast<size_t>(D) * hp + 3 * hp + D + L + static_cast<size_t>(L) * (D + 1));
}

// Returns a cudaError_t (0 = launched). D must be one of the instantiated
// widths; every pointer is a contiguous fp32 device array.
int din_attention_forward(const float* q, const float* k, const float* m, const float* w1,
                          const float* b1, const float* w2, const float* alpha,
                          float* pooled, float* scores, int B, int L, int D, int H,
                          void* stream) {
  const size_t smem = din_attention_smem_bytes(L, D, H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, smem, s);
    case 16: return launch<16>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, smem, s);
    case 32: return launch<32>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, smem, s);
    case 64: return launch<64>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
