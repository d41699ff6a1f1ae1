// DIN target attention backward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:484
// din_attention_bwd_fused (_din_bwd_kernel, kernels.py:391-481). Same function
// as din_attention_bwd_plain in tpurec_torch/ops/kernels.py: recompute the
// activation unit, then the gradients of pooled = sum_l s_l k_l and of the
// scores s with respect to q, keys, W1, b1, w2 and alpha, the parameter
// gradients summed over the batch. The mask gets no gradient.
//
// The algebra (the forward's fold, din_attention.cu, reused). With
//   w_q = W1[0:D] + W1[D:2D],  w_k = W1[2D:3D] - W1[D:2D],  w_p = W1[3D:4D],
//   c = q.w_q + b1,  W_eff = w_k + diag(q) w_p,  lin_l = c + k_l.W_eff,
// per batch row:
//   g_l    = (gs_l + gp.k_l) * mask_l                 (kernels.py:430)
//   dlin_l = g_l * w2 * PReLU'(lin_l)                 (1 if lin > 0, alpha if
//                                                      lin < 0, 0 at 0: :434)
//   dk_l   = W_eff dlin_l + s_l gp
//   M      = sum_l k_l (x) dlin_l                     (D x H)
//   dq[d]  = sum_h w_q[d,h] dlin_b[h] + sum_h w_p[d,h] M[d,h],  dlin_b = sum_l dlin_l
// and the row's parameter pieces: a += q (x) dlin_b, k += M, p += diag(q) M,
// db1 += dlin_b, dw2 += sum_l g_l hidden_l, dalpha += w2 * sum_l g_l min(lin_l, 0);
// dW1 = [a, a - k, k, p] (kernels.py:465-468). That is three D x H products
// per sequence step (lin, dk, M): ~3 L D H FMAs a row, where the TPU kernel's
// matmul chain does ~6.
//
// What bounds it on an H100 at the training shape (B=8192, L=64, D=32, H=36,
// lengths uniform in L/4..L, so ~62.5 % of the steps are live): a masked step
// has s = 0 and dlin = 0, so the function needs keys and gs at live steps
// only; it reads q, mask and gp once, writes dq and all of dkeys once,
// ~116 MB (35 us at 3.35 TB/s). The fold's arithmetic is 3 D H FMAs per live
// step in the three products, ~2.5 GFLOP with the fold, dq, the running sums
// and the activation (37 us at 67 TFLOP/s without the tensor cores;
// chip_smoke.py counts it from its mask the same way). So the bound is
// ~0.037 ms, set by operations. The design keeps the arithmetic at the
// fold's count and the traffic at the function's own: keys are read once
// (16-byte loads into shared memory), the (L, H) recompute (lin, dlin) lives
// in shared memory only, dkeys is staged in shared memory and written with
// 16-byte stores, and the W1 blocks are loaded once per block. It is a first,
// simple kernel: it recomputes every step, masked or not; at the training
// shape a block takes 66 KB of shared memory, so ~3 blocks of two warps share
// an SM, and it runs at ~8 % of the bound (0.448 ms on an H100 SXM at 700 W).
// Skipping the masked steps, more rows per block, or the tensor cores
// (3xTF32) for the three D x H products, are the next steps.
//
// The sum across rows. On the TPU the grid runs in order and accumulates the
// parameter gradients in place (kernels.py:463-481); blocks on Hopper run in
// no order. Each block here walks a fixed set of rows (grid-stride), keeps its
// running sums in shared memory, each element owned by one thread, and writes
// one partial into a scratch buffer the wrapper allocates (torch.empty). A
// second kernel in this file adds the partials in block order. No atomics:
// the gradients are the same bits from run to run, which float atomics would
// not give.
//
// Layout: one block of 64 threads per row at a time, one thread per sequence
// step for the recompute and for dkeys, one thread per (d, 4 columns of H) for
// M and the running sums. The grid is as many blocks as fit on the card at
// once (occupancy query), capped at B.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kReduceThreads = 256;

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

// Shared memory, in floats (hp = H rounded up to 4; every float4-read array
// starts on a 16-byte boundary):
//   wq, wk, wp, weff, m, acc_a, acc_k, acc_p   8 x (D, hp)
//   c, w2, alpha, dlin_b, acc_b1, acc_w2, acc_al   7 x hp
//   lin, dlin                                  2 x (L, hp)
//   q, gp                                      2 x D
//   mask, gs, g, s                             4 x L
//   keys, then dkeys                           (L, D + 1)
size_t smem_floats(int L, int D, int H) {
  const size_t hp = round_up4(H);
  return 8 * D * hp + 7 * hp + 2 * static_cast<size_t>(L) * hp + 2 * D + 4 * static_cast<size_t>(L) +
         static_cast<size_t>(L) * (D + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads) din_attention_bwd_kernel(
    const float* __restrict__ query,  // (B, D)
    const float* __restrict__ keys,   // (B, L, D)
    const float* __restrict__ mask,   // (B, L)
    const float* __restrict__ w1,     // (4D, H)
    const float* __restrict__ b1,     // (H,)
    const float* __restrict__ w2,     // (H,)
    const float* __restrict__ alpha,  // (H,)
    const float* __restrict__ gp,     // (B, D)
    const float* __restrict__ gs,     // (B, L)
    float* __restrict__ dq,           // (B, D)
    float* __restrict__ dk,           // (B, L, D)
    float* __restrict__ partials,     // (gridDim.x, 3 D H + 3 H)
    int B, int L, int H) {
  extern __shared__ __align__(16) float smem[];
  const int hp = round_up4(H);
  const int dh = D * hp;
  float* wq_s = smem;
  float* wk_s = wq_s + dh;
  float* wp_s = wk_s + dh;
  float* weff_s = wp_s + dh;
  float* m_s = weff_s + dh;
  float* acc_a = m_s + dh;
  float* acc_k = acc_a + dh;
  float* acc_p = acc_k + dh;
  float* c_s = acc_p + dh;
  float* w2_s = c_s + hp;
  float* a_s = w2_s + hp;
  float* dlinb_s = a_s + hp;
  float* acc_b1 = dlinb_s + hp;
  float* acc_w2 = acc_b1 + hp;
  float* acc_al = acc_w2 + hp;
  float* lin_s = acc_al + hp;      // (L, hp)
  float* dlin_s = lin_s + L * hp;  // (L, hp)
  float* q_s = dlin_s + L * hp;    // (D,)
  float* gp_s = q_s + D;           // (D,)
  float* mask_s = gp_s + D;        // (L,)
  float* gs_s = mask_s + L;        // (L,)
  float* g_s = gs_s + L;           // (L,)
  float* s_s = g_s + L;            // (L,)
  float* k_s = s_s + L;            // (L, D + 1)

  const int tid = threadIdx.x;
  const int hq = hp / 4;

  // the block's constants (padded columns are zero) and zeroed running sums
  for (int i = tid; i < dh; i += kThreads) {
    const int d = i / hp;
    const int h = i % hp;
    float wq = 0.f, wk = 0.f, wp = 0.f;
    if (h < H) {
      const float w_qk = __ldg(w1 + (D + d) * H + h);
      wq = __ldg(w1 + d * H + h) + w_qk;
      wk = __ldg(w1 + (2 * D + d) * H + h) - w_qk;
      wp = __ldg(w1 + (3 * D + d) * H + h);
    }
    wq_s[i] = wq;
    wk_s[i] = wk;
    wp_s[i] = wp;
    acc_a[i] = 0.f;
    acc_k[i] = 0.f;
    acc_p[i] = 0.f;
  }
  for (int h = tid; h < hp; h += kThreads) {
    w2_s[h] = h < H ? __ldg(w2 + h) : 0.f;
    a_s[h] = h < H ? __ldg(alpha + h) : 0.f;
    acc_b1[h] = 0.f;
    acc_w2[h] = 0.f;
    acc_al[h] = 0.f;
  }
  __syncthreads();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const size_t row_d = static_cast<size_t>(b) * D;
    const size_t row_l = static_cast<size_t>(b) * L;
    for (int d = tid; d < D; d += kThreads) {
      q_s[d] = __ldg(query + row_d + d);
      gp_s[d] = __ldg(gp + row_d + d);
    }
    for (int l = tid; l < L; l += kThreads) {
      mask_s[l] = __ldg(mask + row_l + l);
      gs_s[l] = __ldg(gs + row_l + l);
    }
    // keys: coalesced 16-byte loads (D is a multiple of 4), padded rows
    const float4* k4 = reinterpret_cast<const float4*>(keys + row_l * D);
    for (int i = tid; i < L * D / 4; i += kThreads) {
      const float4 v = __ldg(k4 + i);
      float* dst = k_s + ((4 * i) / D) * (D + 1) + (4 * i) % D;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();

    // fold the q-dependent terms: W_eff = w_k + diag(q) w_p, c = q.w_q + b1
    for (int i = tid; i < dh; i += kThreads) {
      weff_s[i] = fmaf(q_s[i / hp], wp_s[i], wk_s[i]);
    }
    for (int h = tid; h < hp; h += kThreads) {
      float c = 0.f;
      if (h < H) {
        c = __ldg(b1 + h);
        for (int d = 0; d < D; ++d) c = fmaf(q_s[d], wq_s[d * hp + h], c);
      }
      c_s[h] = c;  // padded columns: lin = 0, slope 0, dlin 0
    }
    __syncthreads();

    // per step: recompute lin, the score, and dlin
    for (int l = tid; l < L; l += kThreads) {
      float k[D];
#pragma unroll
      for (int d = 0; d < D; ++d) k[d] = k_s[l * (D + 1) + d];
      float g = gs_s[l];
#pragma unroll
      for (int d = 0; d < D; ++d) g = fmaf(gp_s[d], k[d], g);
      const float m = mask_s[l];
      g *= m;
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
        float dl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = a_s[h + j];
          const float w = w2_s[h + j];
          s = fmaf(fmaxf(lin[j], 0.f) + a * fminf(lin[j], 0.f), w, s);
          const float slope = lin[j] > 0.f ? 1.f : (lin[j] < 0.f ? a : 0.f);
          dl[j] = (g * w) * slope;
        }
        *reinterpret_cast<float4*>(lin_s + l * hp + h) = acc;
        *reinterpret_cast<float4*>(dlin_s + l * hp + h) = make_float4(dl[0], dl[1], dl[2], dl[3]);
      }
      g_s[l] = g;
      s_s[l] = s * m;
    }
    __syncthreads();

    // per column h: dlin_b, and the row's db1, dw2, dalpha pieces
    for (int h = tid; h < hp; h += kThreads) {
      const float a = a_s[h];
      float db = 0.f, dw = 0.f, dn = 0.f;
      for (int l = 0; l < L; ++l) {
        const float lin = lin_s[l * hp + h];
        const float g = g_s[l];
        db += dlin_s[l * hp + h];
        dw = fmaf(g, fmaxf(lin, 0.f) + a * fminf(lin, 0.f), dw);
        dn = fmaf(g, fminf(lin, 0.f), dn);
      }
      dlinb_s[h] = db;
      acc_b1[h] += db;
      acc_w2[h] += dw;
      acc_al[h] = fmaf(w2_s[h], dn, acc_al[h]);
    }
    __syncthreads();

    // per (d, four columns): M = sum_l k_l (x) dlin_l and the running sums
    for (int it = tid; it < D * hq; it += kThreads) {
      const int d = it / hq;
      const int h = (it % hq) * 4;
      float4 mm = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int l = 0; l < L; ++l) {
        const float kv = k_s[l * (D + 1) + d];
        const float4 dl = *reinterpret_cast<const float4*>(dlin_s + l * hp + h);
        mm.x = fmaf(kv, dl.x, mm.x);
        mm.y = fmaf(kv, dl.y, mm.y);
        mm.z = fmaf(kv, dl.z, mm.z);
        mm.w = fmaf(kv, dl.w, mm.w);
      }
      const int i = d * hp + h;
      const float qd = q_s[d];
      const float4 lb = *reinterpret_cast<const float4*>(dlinb_s + h);
      float4 ak = *reinterpret_cast<float4*>(acc_k + i);
      float4 ap = *reinterpret_cast<float4*>(acc_p + i);
      float4 aa = *reinterpret_cast<float4*>(acc_a + i);
      ak.x += mm.x;
      ak.y += mm.y;
      ak.z += mm.z;
      ak.w += mm.w;
      ap.x = fmaf(qd, mm.x, ap.x);
      ap.y = fmaf(qd, mm.y, ap.y);
      ap.z = fmaf(qd, mm.z, ap.z);
      ap.w = fmaf(qd, mm.w, ap.w);
      aa.x = fmaf(qd, lb.x, aa.x);
      aa.y = fmaf(qd, lb.y, aa.y);
      aa.z = fmaf(qd, lb.z, aa.z);
      aa.w = fmaf(qd, lb.w, aa.w);
      *reinterpret_cast<float4*>(m_s + i) = mm;
      *reinterpret_cast<float4*>(acc_k + i) = ak;
      *reinterpret_cast<float4*>(acc_p + i) = ap;
      *reinterpret_cast<float4*>(acc_a + i) = aa;
    }
    __syncthreads();

    // dq = w_q dlin_b + rowsum(w_p * M)
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int h = 0; h < H; ++h) {
        acc = fmaf(wq_s[d * hp + h], dlinb_s[h], acc);
        acc = fmaf(wp_s[d * hp + h], m_s[d * hp + h], acc);
      }
      dq[row_d + d] = acc;
    }
    // dkeys = W_eff dlin_l + s_l gp, staged over the keys (no longer read)
    for (int l = tid; l < L; l += kThreads) {
      const float s = s_s[l];
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = s * gp_s[d];
      for (int h = 0; h < hp; h += 4) {
        const float4 dl = *reinterpret_cast<const float4*>(dlin_s + l * hp + h);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float4 w = *reinterpret_cast<const float4*>(weff_s + d * hp + h);
          acc[d] = fmaf(w.x, dl.x, acc[d]);
          acc[d] = fmaf(w.y, dl.y, acc[d]);
          acc[d] = fmaf(w.z, dl.z, acc[d]);
          acc[d] = fmaf(w.w, dl.w, acc[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) k_s[l * (D + 1) + d] = acc[d];
    }
    __syncthreads();
    float4* dk4 = reinterpret_cast<float4*>(dk + row_l * D);
    for (int i = tid; i < L * D / 4; i += kThreads) {
      const float* src = k_s + ((4 * i) / D) * (D + 1) + (4 * i) % D;
      dk4[i] = make_float4(src[0], src[1], src[2], src[3]);
    }
    __syncthreads();  // the next row overwrites shared memory
  }

  // this block's partial: [a (D, H), k (D, H), p (D, H), db1, dw2, dalpha]
  float* part = partials + static_cast<size_t>(blockIdx.x) * (3 * D * H + 3 * H);
  for (int i = tid; i < D * H; i += kThreads) {
    const int j = (i / H) * hp + i % H;
    part[i] = acc_a[j];
    part[D * H + i] = acc_k[j];
    part[2 * D * H + i] = acc_p[j];
  }
  for (int h = tid; h < H; h += kThreads) {
    part[3 * D * H + h] = acc_b1[h];
    part[3 * D * H + H + h] = acc_w2[h];
    part[3 * D * H + 2 * H + h] = acc_al[h];
  }
}

// Second pass: add the blocks' partials in block order and assemble
// dW1 = [a, a - k, k, p]. One thread per output element.
__global__ void __launch_bounds__(kReduceThreads) din_attention_bwd_reduce(
    const float* __restrict__ partials, int blocks, int D, int H, float* __restrict__ dw1,
    float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ dalpha) {
  const int dh = D * H;
  const size_t stride = 3 * static_cast<size_t>(dh) + 3 * H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < dh) {
    float a = 0.f, k = 0.f, p = 0.f;
    for (int j = 0; j < blocks; ++j) {
      const float* part = partials + j * stride;
      a += part[i];
      k += part[dh + i];
      p += part[2 * dh + i];
    }
    dw1[i] = a;
    dw1[dh + i] = a - k;
    dw1[2 * dh + i] = k;
    dw1[3 * dh + i] = p;
  } else if (i < dh + 3 * H) {
    const int r = i - dh;
    float v = 0.f;
    for (int j = 0; j < blocks; ++j) v += partials[j * stride + 3 * dh + r];
    if (r < H) {
      db1[r] = v;
    } else if (r < 2 * H) {
      dw2[r - H] = v;
    } else {
      dalpha[r - 2 * H] = v;
    }
  }
}

template <int D>
int blocks_for(int B, int L, int H) {
  const size_t smem = smem_floats(L, D, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      din_attention_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, din_attention_bwd_kernel<D>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long n = static_cast<long>(per_sm > 0 ? per_sm : 1) * sms;
  return static_cast<int>(n < B ? n : B);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* m, const float* w1,
                   const float* b1, const float* w2, const float* alpha, const float* gp,
                   const float* gs, float* dq, float* dk, float* partials, int B, int L,
                   int H, int blocks, cudaStream_t stream) {
  const size_t smem = smem_floats(L, D, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      din_attention_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  din_attention_bwd_kernel<D><<<blocks, kThreads, smem, stream>>>(
      q, k, m, w1, b1, w2, alpha, gp, gs, dq, dk, partials, B, L, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block of the main pass needs; the
// wrapper checks it against the card's per-block limit before launching.
size_t din_attention_bwd_smem_bytes(int L, int D, int H) {
  return smem_floats(L, D, H) * sizeof(float);
}

// Blocks of the main pass (as many as fit on the card at once, at most B),
// or a negated cudaError_t. The wrapper sizes the partials buffer from it.
int din_attention_bwd_blocks(int B, int L, int D, int H) {
  switch (D) {
    case 8: return blocks_for<8>(B, L, H);
    case 16: return blocks_for<16>(B, L, H);
    case 32: return blocks_for<32>(B, L, H);
    case 64: return blocks_for<64>(B, L, H);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns a cudaError_t (0 = both passes launched). Every pointer is a
// contiguous fp32 device array; partials holds blocks x (3 D H + 3 H) floats.
int din_attention_backward(const float* q, const float* k, const float* m, const float* w1,
                           const float* b1, const float* w2, const float* alpha,
                           const float* gp, const float* gs, float* dq, float* dk,
                           float* dw1, float* db1, float* dw2, float* dalpha, float* partials,
                           int B, int L, int D, int H, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 8: err = launch<8>(q, k, m, w1, b1, w2, alpha, gp, gs, dq, dk, partials, B, L, H, blocks, s); break;
    case 16: err = launch<16>(q, k, m, w1, b1, w2, alpha, gp, gs, dq, dk, partials, B, L, H, blocks, s); break;
    case 32: err = launch<32>(q, k, m, w1, b1, w2, alpha, gp, gs, dq, dk, partials, B, L, H, blocks, s); break;
    case 64: err = launch<64>(q, k, m, w1, b1, w2, alpha, gp, gs, dq, dk, partials, B, L, H, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = D * H + 3 * H;
  din_attention_bwd_reduce<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      partials, blocks, D, H, dw1, db1, dw2, dalpha);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
