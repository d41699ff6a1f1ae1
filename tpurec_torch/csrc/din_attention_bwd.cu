// DIN target attention backward for Hopper (sm_90a), fp32 in and out.
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:484
// din_attention_bwd_fused (_din_bwd_kernel, kernels.py:391-481). Same function
// as din_attention_bwd_plain in tpurec_torch/ops/kernels.py: recompute the
// activation unit, then the gradients of pooled = sum_l s_l k_l and of the
// scores s with respect to q, keys, W1, b1, w2 and alpha, the parameter
// gradients summed over the batch. The mask scales the scores and gets no
// gradient.
//
// The algebra. With w_q = W1[0:D] + W1[D:2D], w_k = W1[2D:3D] - W1[D:2D],
// w_p = W1[3D:4D], and per row c = q.w_q + b1, W_eff = w_k + diag(q) w_p:
//   lin = K W_eff + c,  g_l = (gs_l + gp.k_l) mask_l,  s_l = mask_l sum_h w2 PReLU(lin)
//   dlin = g w2 PReLU'(lin)      (1 if lin > 0, alpha if lin < 0, 0 at 0)
//   dkeys = dlin W_eff^T + s (x) gp,  M = K^T dlin (D x H),  dlin_b = sum_l dlin_l
//   dq = w_q dlin_b + rowsum(w_p o M)
//   a += q (x) dlin_b,  k += M,  p += diag(q) M,  db1 += dlin_b,
//   dw2 += sum_l g_l PReLU(lin_l),  dalpha += w2 sum_l g_l min(lin_l, 0)
// and dW1 = [a, a - k, k, p] (kernels.py:465-468). The unfolded form
// X_l = [k_l, q o k_l], W = [w_k; w_p] (din_attention_bwd_unfolded in
// kernels.py, which the CPU tests hold to the plain version in fp32, 3xTF32
// and 1xTF32) is the same function: X W = K W_eff, and dlin W^T read as
// [Y_k, Y_p] gives dkeys = Y_k + q o Y_p = dlin W_eff^T.
//
// What bounds it on an H100 (B=8192, L=64, D=32, H=36, lengths uniform in
// L/4..L, so ~62.5 % of the steps are live): a masked step has s = 0 and
// dlin = 0, so its dkeys row is 0 and it adds nothing to any sum. The
// function reads keys and gs at live steps only, q, mask and gp once, and
// writes dq and all of dkeys: ~116 MB, 35 us at 3.35 TB/s. Counted as the
// fold's fp32 work it is ~2.5 GFLOP, 37 us at 67 TFLOP/s (chip_smoke.py
// counts both from its mask). The three products go to the tensor cores, so
// what is left is the per-step work on the CUDA cores (the activation, the
// TF32 splits, shared-memory traffic) and its latency at 6 warps an SM.
//
// The design:
// - Live steps only: pass 1 counts each row's 16-step tiles up to its last
//   step with a nonzero mask; the main pass works those tiles and writes
//   dkeys beyond as zeros. Zero-mask steps inside that range go through the
//   math and give zeros, so masks with holes stay exact.
// - The three products (lin = K W_eff, dlin W_eff^T, M += K^T dlin) are
//   mma.sync m16n8k8 TF32 tiles of 16 steps of one row, where W_eff is the
//   same for all 16: the per-row weight the fold makes is a shared weight
//   inside a tile. One TF32 product keeps ~3 decimal digits: PReLU's slope
//   flips where lin is near 0 and the gradients miss their fp32 limits by
//   four orders of magnitude. So each operand is split into TF32 hi and lo
//   parts and a product is hi.hi + hi.lo + lo.hi, accumulated in fp32
//   (3xTF32): ~fp32 accuracy.
// - W_eff is built once a row, split, in the B-fragment order of lin's
//   product (16-byte loads, no bank conflicts); the dkeys product reads the
//   same words transposed. M stays in registers through the row's tiles.
// - One warp a row at a time, with its own tiles (keys, dlin), W_eff and
//   running sums in shared memory; a block of up to 8 warps (6 at the
//   training shape, by shared memory) shares the weights. Only __syncwarp
//   inside the row loop. The kernel is built for each D and for H in
//   8-column tiles (NT of 1-6, 8, 10, 12 or 16, H padded up with zero
//   columns), so lin's tile stays in registers through the activation and
//   each lane keeps its columns' sums (dlin_b a row; db1, dw2 and dalpha the
//   block's life) in registers, reduced across lanes once a row or a block.
//   dlin goes through shared memory once, where the next products need it
//   in another operand layout.
// - The next tile's keys, mask and gs are loaded into registers while this
//   tile computes, and the next row's first tile and q, gp with the last.
// - The kink. 3xTF32 products with the tensor cores' truncating fp32
//   accumulation leave lin ~2^-18 |k| |W_eff| off, eight times fp32's
//   error, so where lin lies that close to 0 PReLU's slope can take the
//   other side from an fp32 reference: at key width 64 and B=8192 a row or
//   two a batch, each off by a whole g w2 (1 - alpha) in dkeys and dq. An
//   x = lin + c within 2^-14 max_l |k_l| |W_eff[:, h]| + 2^-16 (sum_d
//   |q_d w_q[d, h]| + |b1[h]|) of 0 (max over the tile's 16 steps; some
//   1e-4 of the elements) is taken again in fp64 from the keys tile and the
//   raw w1, x = b1 + sum_d q_d w1_a + (q_d - k_d) w1_b + k_d w1_c +
//   q_d k_d w1_d: the slope then agrees with the plain version's in fp64
//   down to fp64's rounding (the fp32 folds w_k, w_q would misplace an x
//   ~1e-8 from the kink: some 1e-8 of the elements, a few in the
//   context-parallel check's 3e8). The lanes vote once a tile and the flagged
//   x go through one fp64 loop; the test and the branch cost the common
//   path time (PERF.md, the kernel table's #5).
// - Even work: pass 2 cuts the rows into contiguous ranges of equal work,
//   one a warp (live tiles per row vary 1 to 4 at the training shape; a
//   grid-stride walk left the slowest warp well above the mean).
//
// The sum across rows. On the TPU the grid runs in order and accumulates the
// parameter gradients in place (kernels.py:463-481); blocks on Hopper run in
// no order. Each warp walks a fixed range of rows, each block adds its
// warps' sums in warp order into one partial in a scratch buffer the
// wrapper allocates (torch.empty), and pass 4 adds the partials in block
// order. No float atomics: the gradients are the same bits from run to run,
// which float atomics would not give.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kReduceThreads = 256;
constexpr int kMaxSmemBytes = 232448;  // Hopper's per-block limit (227 KB)
// the kink's margin: 2^-14 of |k| |W_eff[:, h]|, 2^-16 of c's absolute sum
constexpr float kKinkK = 6.103515625e-05f;
constexpr float kKinkC = 1.52587890625e-05f;

// n-tiles of 8 columns the kernel is built for: H is padded up to the next
__host__ __device__ inline int nt_for(int H) {
  const int nt = (H + 7) / 8;
  return nt <= 6 ? nt : (nt <= 8 ? 8 : (nt <= 10 ? 10 : (nt <= 12 ? 12 : (nt <= 16 ? 16 : 0))));
}

// Shared memory, in floats (Hp = 8 NT; DM = D rounded up to 16; every array
// starts on a 16-byte boundary). The block's constants:
//   wkp: w_k and w_p in the B-fragment order of lin's product,
//        [D/8][NT][32 lanes][wk0, wk1, wp0, wp1], and wqf: w_q in the same
//        order, [D/8][NT][32][wq0, wq1]
//   wqp: w_q and w_p in the C-fragment order of M, [DM/16][NT][32][wq 4, wp 4]
//   b1, w2, alpha (Hp each)
// and each warp's own:
//   keys tile (16, D + 4); dlin tile (16, Hp + 4)
//   weff: the row's W_eff = w_k + diag(q) w_p split into TF32, in wkp's
//         order, [D/8][NT][32][hi0, hi1, lo0, lo1]
//   acc: the running a, k and p in C-fragment order, [3][DM/16][NT][32][4]
//   c, and the block's db1, dw2, dalpha (Hp each)
//   q, gp (D each); g, mask of the tile (16 each)
//   |W_eff[:, h]| and sum_d |q_d w_q[d, h]| + |b1[h]| (Hp each), the kink's
//   margin
__host__ __device__ constexpr int pad16(int d) { return (d + 15) & ~15; }
__host__ __device__ constexpr int const_floats(int D, int Hp) { return 3 * D * Hp + 2 * pad16(D) * Hp + 3 * Hp; }
__host__ __device__ constexpr int warp_floats(int D, int Hp) {
  return 16 * (D + 4) + 16 * (Hp + 4) + 2 * D * Hp + 3 * pad16(D) * Hp + 4 * Hp + 2 * D + 32 + 2 * Hp;
}

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

__device__ __forceinline__ float warp_sum_rows(float v) {  // over gid (lane bits 2-4)
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float quad_sum(float v) {  // over tig (lane bits 0-1)
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x = lin + c of step s (a row of the keys tile) and column h in fp64, from
// the raw (4D, H) w1 over the features the plain version builds, q, q - k,
// k and q k (each exact in fp64): for a lane whose x lies near PReLU's
// kink. The fp32 folds w_k = w1_c - w1_b and w_q = w1_a + w1_b would each
// round by up to 2^-24 of their size, enough to put an x ~1e-8 from the
// kink on the other side. Not inlined: its loads stay out of the main
// loop's registers (on an H100 at 700 W, D=64: 0.615 ms a launch, against
// 0.645 inlined).
template <int D>
__device__ __noinline__ float exact_x(const float* kt_s, const float* q_s, const float* __restrict__ w1,
                                      int H, float b1h, int s, int h) {
  double x = b1h;
  // eight steps of d a round: their 32 loads from L2 are in flight together
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 8) {
    float w[4][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int f = 0; f < 4; ++f) w[f][j] = __ldg(w1 + (f * D + d0 + j) * H + h);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const double k = kt_s[s * (D + 4) + d0 + j], q = q_s[d0 + j];
      x += q * static_cast<double>(w[0][j]) + (q - k) * static_cast<double>(w[1][j]) +
           k * static_cast<double>(w[2][j]) + (q * k) * static_cast<double>(w[3][j]);
    }
  }
  return static_cast<float>(x);
}

// Pass 3, the main pass: a warp a row at a time over its range of rows.
template <int D, int NT>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) din_attention_bwd_kernel(
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
    const int* __restrict__ tiles_of,  // (B,) live 16-step tiles of each row
    const int* __restrict__ starts,    // (gridDim.x * warps + 1,) each warp's first row
    int B, int L, int H) {
  constexpr int KT = D / 8;          // k-tiles of lin, n-tiles of Y
  constexpr int MT = pad16(D) / 16;  // m-tiles of M = K^T dlin
  constexpr int SK = D + 4;
  constexpr int Hp = 8 * NT;
  constexpr int SD = Hp + 4;
  constexpr int V4 = D / 8;  // float4s of a keys tile a lane
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;

  float* wkp = smem;
  float* wqf = wkp + 2 * D * Hp;
  float* wqp = wqf + D * Hp;
  float* b1_s = wqp + 2 * pad16(D) * Hp;
  float* w2_s = b1_s + Hp;
  float* al_s = w2_s + Hp;
  float* mine = smem + const_floats(D, Hp) + warp * warp_floats(D, Hp);
  float* kt_s = mine;                       // (16, SK)
  float* dl_s = kt_s + 16 * SK;             // (16, SD)
  float* weff = dl_s + 16 * SD;          // 2 D Hp, fragment order
  float* acc = weff + 2 * D * Hp;        // 3 DM Hp, C-fragment order: a, k, p
  float* c_s = acc + 3 * pad16(D) * Hp;
  float* db1_s = c_s + Hp;
  float* dw2_s = db1_s + Hp;
  float* dal_s = dw2_s + Hp;
  float* q_s = dal_s + Hp;
  float* gp_s = q_s + D;
  float* g_s = gp_s + D;
  float* m_s = g_s + 16;
  float* wn_s = m_s + 16;
  float* ca_s = wn_s + Hp;

  // this warp's rows
  const int r0 = __ldg(starts + blockIdx.x * warps + warp), r1 = __ldg(starts + blockIdx.x * warps + warp + 1);

  // the block's constants (padded columns are zero: lin = c = 0 there, so
  // slope and dlin are 0) and each warp's zeroed running sums
  for (int i = threadIdx.x; i < KT * NT * 32; i += blockDim.x) {
    // lin's B: (k = d = 8 kt + tig (+4), n = h = 8 nt + gid)
    const int ln = i % 32, nt = (i / 32) % NT, kt = i / (32 * NT);
    const int d = 8 * kt + (ln & 3), h = 8 * nt + (ln >> 2);
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (h < H) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wd = __ldg(w1 + (D + d + 4 * e) * H + h);
        v[e] = __ldg(w1 + (2 * D + d + 4 * e) * H + h) - wd;
        v[2 + e] = __ldg(w1 + (3 * D + d + 4 * e) * H + h);
        v[4 + e] = __ldg(w1 + (d + 4 * e) * H + h) + wd;
      }
    }
    reinterpret_cast<float4*>(wkp)[i] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float2*>(wqf)[i] = make_float2(v[4], v[5]);
  }
  for (int i = threadIdx.x; i < MT * NT * 32; i += blockDim.x) {
    const int ln = i % 32, nt = (i / 32) % NT, mt = i / (32 * NT);
    float v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // (d, h) of C-fragment entry e
      const int d = 16 * mt + (ln >> 2) + 8 * (e >> 1), h = 8 * nt + 2 * (ln & 3) + (e & 1);
      const bool in = d < D && h < H;
      v[e] = in ? __ldg(w1 + d * H + h) + __ldg(w1 + (D + d) * H + h) : 0.f;
      v[4 + e] = in ? __ldg(w1 + (3 * D + d) * H + h) : 0.f;
    }
    reinterpret_cast<float4*>(wqp)[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(wqp)[2 * i + 1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  for (int h = threadIdx.x; h < Hp; h += blockDim.x) {
    b1_s[h] = h < H ? __ldg(b1 + h) : 0.f;
    w2_s[h] = h < H ? __ldg(w2 + h) : 0.f;
    al_s[h] = h < H ? __ldg(alpha + h) : 0.f;
  }
  for (int i = lane; i < 3 * pad16(D) * Hp; i += 32) acc[i] = 0.f;
  // this lane's share of dw2 and dalpha (columns 8 nt + 2 tig + cc, its
  // rows), and db1 (the same columns, every lane the warp's total)
  float pdw[NT][2], pdn[NT][2], pdb1[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) pdw[nt][cc] = pdn[nt][cc] = pdb1[nt][cc] = 0.f;
  }
  __syncthreads();

  // a row's start (q, gp, its tile count) and its first tile are loaded
  // into registers one row ahead, a tile's keys, mask and gs one tile ahead
  constexpr int QV = (D + 31) / 32;
  float4 kv[V4];
  float mv = 0.f, gv = 0.f, qv[QV], gpv[QV];
  int tv = 0;
  auto fetch = [&](int r, int l0) {
    const size_t rl = static_cast<size_t>(r) * L;
#pragma unroll
    for (int v = 0; v < V4; ++v) {
      const int i = lane + 32 * v, s = i / (D / 4);
      kv[v] = l0 + s < L ? __ldg(reinterpret_cast<const float4*>(keys + (rl + l0 + s) * D) + i % (D / 4))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const bool in = lane < 16 && l0 + lane < L;
    mv = in ? __ldg(mask + rl + l0 + lane) : 0.f;
    gv = in ? __ldg(gs + rl + l0 + lane) : 0.f;
  };
  auto fetch_row = [&](int r) {
    fetch(r, 0);
    tv = __ldg(tiles_of + r);
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int d = lane + 32 * i;
      qv[i] = d < D ? __ldg(query + static_cast<size_t>(r) * D + d) : 0.f;
      gpv[i] = d < D ? __ldg(gp + static_cast<size_t>(r) * D + d) : 0.f;
    }
  };
  if (r0 < r1) fetch_row(r0);
  for (int row = r0; row < r1; ++row) {
    const size_t row_d = static_cast<size_t>(row) * D;
    const size_t row_l = static_cast<size_t>(row) * L;
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        q_s[d] = qv[i];
        gp_s[d] = gpv[i];
      }
    }
    const int tiles = tv;
    __syncwarp();
    // the row's W_eff = w_k + diag(q) w_p in TF32 parts, and c = q.w_q + b1
    // (lane sums over d = 8 kt + tig (+4), then over tig)
    if (tiles > 0) {
      float cq[NT], ca[NT], wn[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) cq[nt] = ca[nt] = wn[nt] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const float qa = q_s[8 * kt + tig], qb = q_s[8 * kt + tig + 4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int i = (kt * NT + nt) * 32 + lane;
          const float4 w = reinterpret_cast<const float4*>(wkp)[i];
          const float2 wq = reinterpret_cast<const float2*>(wqf)[i];
          uint32_t h0, l0, h1, l1;
          const float e0 = fmaf(qa, w.z, w.x), e1 = fmaf(qb, w.w, w.y);
          split(e0, h0, l0);
          split(e1, h1, l1);
          reinterpret_cast<float4*>(weff)[i] =
              make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0), __uint_as_float(l1));
          cq[nt] = fmaf(qa, wq.x, fmaf(qb, wq.y, cq[nt]));
          ca[nt] += fabsf(qa * wq.x) + fabsf(qb * wq.y);
          wn[nt] = fmaf(e0, e0, fmaf(e1, e1, wn[nt]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float c = quad_sum(cq[nt]), a = quad_sum(ca[nt]), n = quad_sum(wn[nt]);
        if (tig == 0) {
          const int h = 8 * nt + gid;
          c_s[h] = c + b1_s[h];
          ca_s[h] = a + fabsf(b1_s[h]);
          wn_s[h] = sqrtf(n);
        }
      }
    }
    // M = sum_l k_l (x) dlin_l over the row, in C fragments (rows d, columns h)
    float mm[MT][NT][4], pdb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pdb[nt][0] = pdb[nt][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mm[mt][nt][e] = 0.f;
      }
    }

    for (int t = 0; t < tiles; ++t) {
      const int l0 = 16 * t;
#pragma unroll
      for (int v = 0; v < V4; ++v) {
        const int i = lane + 32 * v;
        *reinterpret_cast<float4*>(kt_s + (i / (D / 4)) * SK + 4 * (i % (D / 4))) = kv[v];
      }
      if (lane < 16) {
        m_s[lane] = mv;
        g_s[lane] = gv;
      }
      __syncwarp();
      // in flight while this tile computes
      if (t + 1 < tiles) {
        fetch(row, l0 + 16);
      } else if (row + 1 < r1) {
        fetch_row(row + 1);
      }
      float kmax;  // 2^-14 of the tile's largest |k_l|
      {  // g = (gs + gp.k) mask and |k|: two lanes a step
        const int r = lane >> 1, half = lane & 1;
        const float4* kr = reinterpret_cast<const float4*>(kt_s + r * SK + half * (D / 2));
        const float4* gp4 = reinterpret_cast<const float4*>(gp_s + half * (D / 2));
        float dot = 0.f, sq = 0.f;
#pragma unroll
        for (int v = 0; v < D / 8; ++v) {
          const float4 k = kr[v], p = gp4[v];
          dot = fmaf(p.w, k.w, fmaf(p.z, k.z, fmaf(p.y, k.y, fmaf(p.x, k.x, dot))));
          sq = fmaf(k.w, k.w, fmaf(k.z, k.z, fmaf(k.y, k.y, fmaf(k.x, k.x, sq))));
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq = fmaxf(sq, __shfl_xor_sync(0xffffffffu, sq, 2));
        sq = fmaxf(sq, __shfl_xor_sync(0xffffffffu, sq, 4));
        sq = fmaxf(sq, __shfl_xor_sync(0xffffffffu, sq, 8));
        kmax = kKinkK * sqrtf(fmaxf(sq, __shfl_xor_sync(0xffffffffu, sq, 16)));
        __syncwarp();
        if (!half) g_s[r] = (g_s[r] + dot) * m_s[r];
      }
      // K's A fragments: rows (steps) gid, gid + 8; columns tig, tig + 4
      uint32_t xh[KT][4], xl[KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split(kt_s[(gid + 8 * (e & 1)) * SK + 8 * kt + tig + 4 * (e >> 1)], xh[kt][e], xl[kt][e]);
        }
      }
      // lin = K W_eff: NT independent chains
      float lin[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) lin[nt][e] = 0.f;
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 b = reinterpret_cast<const float4*>(weff)[(kt * NT + nt) * 32 + lane];
          mma3(lin[nt], xh[kt], xl[kt], __float_as_uint(b.x), __float_as_uint(b.y), __float_as_uint(b.z),
               __float_as_uint(b.w));
        }
      }
      __syncwarp();
      // x = lin + c in place; a lane flags the x near the kink (bit 4 nt +
      // 2 r + cc) and, where any lane has one, the warp takes those in fp64
      uint64_t near = 0;  // 4 NT <= 64 bits
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 c2 = *reinterpret_cast<const float2*>(c_s + 8 * nt + 2 * tig);
        const float2 wn2 = *reinterpret_cast<const float2*>(wn_s + 8 * nt + 2 * tig);
        const float2 ca2 = *reinterpret_cast<const float2*>(ca_s + 8 * nt + 2 * tig);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float c = cc ? c2.y : c2.x, wnh = cc ? wn2.y : wn2.x, cah = kKinkC * (cc ? ca2.y : ca2.x);
          const float tau = 8 * nt + 2 * tig + cc < H ? fmaf(kmax, wnh, cah) : -1.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = lin[nt][2 * r + cc];
            x += c;
            if (fabsf(x) <= tau) near |= 1ull << (4 * nt + 2 * r + cc);
          }
        }
      }
      if (__any_sync(0xffffffffu, near != 0)) {
        // each flagged x in fp64 into the dlin tile at its place (free until
        // the activation writes it; a lane's places are its own), then back
        for (uint64_t m = near; m != 0; m &= m - 1) {
          const int b = __ffsll(static_cast<long long>(m)) - 1, e = b & 3;
          const int h = 8 * (b >> 2) + 2 * tig + (e & 1), st = gid + 8 * (e >> 1);
          dl_s[st * SD + h] = exact_x<D>(kt_s, q_s, w1, H, b1_s[h], st, h);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (near & (1ull << (4 * nt + e))) {
              lin[nt][e] = dl_s[(gid + 8 * (e >> 1)) * SD + 8 * nt + 2 * tig + (e & 1)];
            }
          }
        }
      }
      // the activation in registers: dlin to the dlin tile, the score, and
      // this lane's column sums (reduced once a row, or once a block)
      const float g0 = g_s[gid], g1 = g_s[gid + 8];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 w2v = *reinterpret_cast<const float2*>(w2_s + 8 * nt + 2 * tig);
        const float2 a2 = *reinterpret_cast<const float2*>(al_s + 8 * nt + 2 * tig);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int h = 8 * nt + 2 * tig + cc;
          const float w = cc ? w2v.y : w2v.x, a = cc ? a2.y : a2.x;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float g = r ? g1 : g0;
            const float x = lin[nt][2 * r + cc];
            const float neg = fminf(x, 0.f);
            const float hv = fmaxf(x, 0.f) + a * neg;
            const float slope = x > 0.f ? 1.f : (x < 0.f ? a : 0.f);
            const float dl = (g * w) * slope;
            if (r) s1 = fmaf(hv, w, s1); else s0 = fmaf(hv, w, s0);
            dl_s[(gid + 8 * r) * SD + h] = dl;
            pdb[nt][cc] += dl;
            pdw[nt][cc] = fmaf(g, hv, pdw[nt][cc]);
            pdn[nt][cc] = fmaf(g, neg, pdn[nt][cc]);
          }
        }
      }
      s0 = quad_sum(s0) * m_s[gid];
      s1 = quad_sum(s1) * m_s[gid + 8];
      __syncwarp();

      // dkeys = dlin W_eff^T + s gp (16 x D); B from weff read transposed
      float y[KT][4];
#pragma unroll
      for (int n = 0; n < KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) y[n][e] = 0.f;
      }
#pragma unroll
      for (int kh = 0; kh < NT; ++kh) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split(dl_s[(gid + 8 * (e & 1)) * SD + 8 * kh + tig + 4 * (e >> 1)], ah[e], al[e]);
        }
#pragma unroll
        for (int n = 0; n < KT; ++n) {
          // (k = h = 8 kh + tig (+4), n = d = 8 n + gid): held by lane
          // 4 tig (+16) + gid % 4, entry gid / 4
          const float* slot = weff + 4 * ((n * NT + kh) * 32 + (gid & 3)) + (gid >> 2);
          mma3(y[n], ah, al, __float_as_uint(slot[16 * tig]), __float_as_uint(slot[16 * (tig + 4)]),
               __float_as_uint(slot[16 * tig + 2]), __float_as_uint(slot[16 * (tig + 4) + 2]));
        }
      }
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        const int d = 8 * n + 2 * tig;
        const float2 gpd = *reinterpret_cast<const float2*>(gp_s + d);
        const float gp0 = gpd.x, gp1 = gpd.y;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = gid + 8 * r;
          const float s = r ? s1 : s0;
          if (l0 + rr < L) {
            *reinterpret_cast<float2*>(dk + (row_l + l0 + rr) * D + d) =
                make_float2(fmaf(s, gp0, y[n][2 * r]), fmaf(s, gp1, y[n][2 * r + 1]));
          }
        }
      }

      // M += K^T dlin (D x Hp): A = K^T from the keys tile (rows past D zero)
      uint32_t th[MT][2][4], tl[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 16 * mt + gid + 8 * (e & 1);
            split(d < D ? kt_s[(8 * ks + tig + 4 * (e >> 1)) * SK + d] : 0.f, th[mt][ks][e], tl[mt][ks][e]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
          for (int e = 0; e < 2; ++e) split(dl_s[(8 * ks + tig + 4 * e) * SD + 8 * nt + gid], bh[ks][e], bl[ks][e]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // the tile's sum in a fresh accumulator, added to M on the CUDA
          // cores: the tensor cores' fp32 accumulation is not rounded to
          // nearest, and M runs over every tile of the row
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            mma3(t, th[mt][ks], tl[mt][ks], bh[ks][0], bh[ks][1], bl[ks][0], bl[ks][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) mm[mt][nt][e] += t[e];
        }
      }
      __syncwarp();  // the next tile overwrites the keys and dlin tiles
    }
    if (tiles == 0 && row + 1 < r1) fetch_row(row + 1);

    // the row's end: every lane gets dlin_b at its columns; then, at its
    // C-fragment places (d, h), dq = w_q dlin_b + rowsum(w_p o M),
    // a += q (x) dlin_b, k += M, p += diag(q) M; dkeys past the last live
    // tile is zero
    float lb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        lb[nt][cc] = warp_sum_rows(pdb[nt][cc]);
        pdb1[nt][cc] += lb[nt][cc];
      }
    }
    float v[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float q0 = q_s[16 * mt + gid], q1 = 16 * mt + gid + 8 < D ? q_s[16 * mt + gid + 8] : 0.f;
      v[mt][0] = v[mt][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int slot = (mt * NT + nt) * 32 + lane;
        const float4 wq = reinterpret_cast<const float4*>(wqp)[2 * slot];
        const float4 wp = reinterpret_cast<const float4*>(wqp)[2 * slot + 1];
        const float* m = mm[mt][nt];
        const float l0 = lb[nt][0], l1 = lb[nt][1];
        v[mt][0] = fmaf(wq.x, l0, fmaf(wq.y, l1, fmaf(wp.x, m[0], fmaf(wp.y, m[1], v[mt][0]))));
        v[mt][1] = fmaf(wq.z, l0, fmaf(wq.w, l1, fmaf(wp.z, m[2], fmaf(wp.w, m[3], v[mt][1]))));
        float4* pa = reinterpret_cast<float4*>(acc) + slot;
        float4* pk = pa + MT * NT * 32;
        float4* pp = pk + MT * NT * 32;
        float4 va = *pa, vk = *pk, vp = *pp;
        va = make_float4(fmaf(q0, l0, va.x), fmaf(q0, l1, va.y), fmaf(q1, l0, va.z), fmaf(q1, l1, va.w));
        vk = make_float4(vk.x + m[0], vk.y + m[1], vk.z + m[2], vk.w + m[3]);
        vp = make_float4(fmaf(q0, m[0], vp.x), fmaf(q0, m[1], vp.y), fmaf(q1, m[2], vp.z), fmaf(q1, m[3], vp.w));
        *pa = va;
        *pk = vk;
        *pp = vp;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int d = 16 * mt + gid + 8 * a;
        const float val = quad_sum(v[mt][a]);
        if (tig == 0 && d < D) dq[row_d + d] = val;
      }
    }
    float4* dk4 = reinterpret_cast<float4*>(dk + row_l * D);
    for (int i = 16 * tiles * (D / 4) + lane; i < L * (D / 4); i += 32) {
      dk4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();  // the next row overwrites q, gp, c and W_eff
  }
  // this warp's dw2 and dalpha
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int h = 8 * nt + 2 * tig + cc;
      const float w = warp_sum_rows(pdw[nt][cc]), n = warp_sum_rows(pdn[nt][cc]);
      if (gid == 0) {
        db1_s[h] = pdb1[nt][cc];
        dw2_s[h] = w;
        dal_s[h] = w2_s[h] * n;
      }
    }
  }
  __syncthreads();

  // this block's partial, its warps added in order:
  // [a (D, H), k (D, H), p (D, H), db1, dw2, dalpha]
  constexpr int acc_at = 16 * SK + 16 * SD + 2 * D * Hp;  // acc in a warp's region
  const int wfl = warp_floats(D, Hp);
  const float* base = smem + const_floats(D, Hp);
  float* part = partials + static_cast<size_t>(blockIdx.x) * (3 * D * H + 3 * H);
  for (int i = threadIdx.x; i < 3 * D * H; i += blockDim.x) {
    const int which = i / (D * H), d = (i / H) % D, h = i % H;
    const int rm = d % 16, cn = h % 8;
    const int ln = (rm % 8) * 4 + cn / 2;
    const int off =
        acc_at + which * pad16(D) * Hp + (((d / 16) * NT + h / 8) * 32 + ln) * 4 + (rm / 8) * 2 + cn % 2;
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += base[w * wfl + off];
    part[i] = v;
  }
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) {
    const int which = i / H, h = i % H;
    const int off = acc_at + 3 * pad16(D) * Hp + (1 + which) * Hp + h;  // db1, dw2, dalpha
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += base[w * wfl + off];
    part[3 * D * H + i] = v;
  }
}

// The warps' rows. Every warp of the main pass takes a contiguous range of
// rows, cut so that the work is even: a row's work is its live tiles plus
// one for its start and end, and row r goes to warp floor(S_r nw / S), S_r
// the work before it, S the total and nw the grid's warps. The ranges
// depend on the mask alone, so the sums are the same bits on every call.
// din_attention_bwd_plan writes each warp's first row.
constexpr int kPlanRows = 8;

// the warp of a row whose work starts at S: monotone in S, so the ranges
// are contiguous (fp64 is exact here up to 2^53 and spares a 64-bit divide)
__device__ __forceinline__ long long owner(long long S, long long nw, double scale) {
  const long long w = static_cast<long long>(static_cast<double>(S) * scale);
  return w < nw ? w : nw - 1;
}

// inclusive scan over the block and the block's total; every thread calls it
__device__ __forceinline__ long long block_scan(long long v, long long* wsum, long long* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long t = lane < warps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += n;
    }
    if (lane < warps) wsum[lane] = t;
  }
  __syncthreads();
  const long long out = v + (warp > 0 ? wsum[warp - 1] : 0);
  *total = wsum[warps - 1];
  __syncthreads();  // wsum is reused
  return out;
}

// Pass 1: each row's live 16-step tiles, up to its last step with a nonzero
// mask. A warp a row.
__global__ void __launch_bounds__(256) din_attention_bwd_tiles(const float* __restrict__ mask, int B, int L,
                                                              int* __restrict__ tiles) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= B) return;
  int last = -1;
  for (int l = lane; l < L; l += 32) {
    if (__ldg(mask + static_cast<size_t>(row) * L + l) != 0.f) last = l;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if (lane == 0) tiles[row] = (last + 16) / 16;
}

// Pass 2, one block: each warp's first row (see owner), into starts (nw + 1
// ints; B where a warp has no row). Thread t plans kPlanRows consecutive
// rows a round.
__global__ void __launch_bounds__(1024) din_attention_bwd_plan(const int* __restrict__ tiles, int B, int nw,
                                                              int* __restrict__ starts) {
  __shared__ long long wsum[32];
  const int round = kPlanRows * blockDim.x;
  int work[kPlanRows], wprev = 0;
  auto load = [&](int base) {  // this thread's rows of a round, the row before, and their sum
    long long v = 0;
    const int first = base + kPlanRows * threadIdx.x;
    wprev = first > 0 && first <= B ? __ldg(tiles + first - 1) + 1 : 0;
#pragma unroll
    for (int i = 0; i < kPlanRows; ++i) {
      work[i] = first + i < B ? __ldg(tiles + first + i) + 1 : 0;
      v += work[i];
    }
    return v;
  };
  long long round_total, v = load(0);
  long long incl = block_scan(v, wsum, &round_total), total = round_total;
  for (int base = round; base < B; base += round) {
    block_scan(load(base), wsum, &round_total);
    total += round_total;
  }
  for (int w = threadIdx.x; w <= nw; w += blockDim.x) starts[w] = B;
  __syncthreads();
  const double scale = static_cast<double>(nw) / static_cast<double>(total);
  long long carry = 0;
  for (int base = 0; base < B; base += round) {
    if (B > round) {  // with one round, its rows are still in registers
      v = load(base);
      incl = block_scan(v, wsum, &round_total);
    } else {
      round_total = total;
    }
    long long S = carry + incl - v;
    const int first = base + kPlanRows * threadIdx.x;
    long long prev = first == 0 || first >= B ? -1 : owner(S - wprev, nw, scale);
#pragma unroll
    for (int i = 0; i < kPlanRows; ++i) {
      const int r = first + i;
      if (r < B) {
        const long long own = owner(S, nw, scale);
        for (long long w = prev + 1; w <= own; ++w) starts[w] = r;
        prev = own;
        S += work[i];
      }
    }
    carry += round_total;
  }
}

// Pass 4: add the blocks' partials and assemble dW1 = [a, a - k, k, p].
// A warp an output: lane i adds blocks i, i + 32, ... in turn, then a fixed
// butterfly adds the lanes, so the order is the same on every call.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kReduceThreads) din_attention_bwd_reduce(
    const float* __restrict__ partials, int blocks, int D, int H, float* __restrict__ dw1,
    float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ dalpha) {
  const int dh = D * H;
  const size_t stride = 3 * static_cast<size_t>(dh) + 3 * H;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (i < dh) {
    float a = 0.f, k = 0.f, p = 0.f;
    for (int j = lane; j < blocks; j += 32) {
      const float* part = partials + j * stride;
      a += part[i];
      k += part[dh + i];
      p += part[2 * dh + i];
    }
    a = warp_sum(a);
    k = warp_sum(k);
    p = warp_sum(p);
    if (lane == 0) {
      dw1[i] = a;
      dw1[dh + i] = a - k;
      dw1[2 * dh + i] = k;
      dw1[3 * dh + i] = p;
    }
  } else if (i < dh + 3 * H) {
    const int r = i - dh;
    float v = 0.f;
    for (int j = lane; j < blocks; j += 32) v += partials[j * stride + 3 * dh + r];
    v = warp_sum(v);
    if (lane == 0) {
      if (r < H) {
        db1[r] = v;
      } else if (r < 2 * H) {
        dw2[r - H] = v;
      } else {
        dalpha[r - 2 * H] = v;
      }
    }
  }
}

// Warps a block (up to 8, as many as its shared memory allows); 0 when one
// warp does not fit or H is past the widest build.
int warps_for(int D, int H) {
  const int nt = nt_for(H);
  if (nt == 0) return 0;
  const long room = kMaxSmemBytes / 4 - const_floats(D, 8 * nt);
  const long w = room / warp_floats(D, 8 * nt);
  return static_cast<int>(w < 0 ? 0 : (w > kMaxWarps ? kMaxWarps : w));
}

size_t smem_bytes(int D, int H, int warps) {
  const int Hp = 8 * nt_for(H);
  return 4 * (static_cast<size_t>(const_floats(D, Hp)) + static_cast<size_t>(warps) * warp_floats(D, Hp));
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float*, float*, float*,
                        float*, const int*, const int*, int, int, int);

template <int D>
Kernel kernel_nt(int nt) {
  switch (nt) {
    case 1: return din_attention_bwd_kernel<D, 1>;
    case 2: return din_attention_bwd_kernel<D, 2>;
    case 3: return din_attention_bwd_kernel<D, 3>;
    case 4: return din_attention_bwd_kernel<D, 4>;
    case 5: return din_attention_bwd_kernel<D, 5>;
    case 6: return din_attention_bwd_kernel<D, 6>;
    case 8: return din_attention_bwd_kernel<D, 8>;
    case 10: return din_attention_bwd_kernel<D, 10>;
    case 12: return din_attention_bwd_kernel<D, 12>;
    // D=64 at 16 tiles would not fit one warp's shared memory: not built
    case 16: return D < 64 ? din_attention_bwd_kernel<D < 64 ? D : 32, 16> : nullptr;
    default: return nullptr;
  }
}

// the build for (D, H), its warps a block and its shared memory, with the
// shared-memory limit set; nullptr when there is none
Kernel kernel_for(int D, int H, int* warps, size_t* smem, cudaError_t* err) {
  Kernel k = nullptr;
  switch (D) {
    case 8: k = kernel_nt<8>(nt_for(H)); break;
    case 16: k = kernel_nt<16>(nt_for(H)); break;
    case 32: k = kernel_nt<32>(nt_for(H)); break;
    case 64: k = kernel_nt<64>(nt_for(H)); break;
    default: break;
  }
  *warps = warps_for(D, H);
  *err = cudaErrorInvalidValue;
  if (k == nullptr || *warps < 1) return nullptr;
  *smem = smem_bytes(D, H, *warps);
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
  return *err == cudaSuccess ? k : nullptr;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a block of one warp needs, the least the
// kernel can run with; the wrapper refuses shapes where it exceeds the
// card's per-block limit. It depends on D and H only: L is tiled.
size_t din_attention_bwd_smem_bytes(int D, int H) { return smem_bytes(D, H, 1); }

// Blocks of the main pass (as many as fit on the card at once, at most one
// row for each warp), or a negated cudaError_t. The wrapper sizes the
// partials buffer from it.
int din_attention_bwd_blocks(int B, int L, int D, int H) {
  (void)L;
  int warps = 0, per_sm = 0, dev = 0, sms = 0;
  size_t smem = 0;
  cudaError_t err;
  Kernel k = kernel_for(D, H, &warps, &smem, &err);
  if (k == nullptr) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32 * warps, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long n = static_cast<long>(per_sm > 0 ? per_sm : 1) * sms;
  const long need = (B + warps - 1) / warps;
  return static_cast<int>(n < need ? n : need);
}

// Returns a cudaError_t (0 = the four passes launched). Every pointer is a
// contiguous device array, fp32 but for tiles (B int32) and starts (8 blocks
// + 1 int32); partials holds blocks x (3 D H + 3 H) floats.
int din_attention_backward(const float* q, const float* k, const float* m, const float* w1,
                           const float* b1, const float* w2, const float* alpha,
                           const float* gp, const float* gs, float* dq, float* dk,
                           float* dw1, float* db1, float* dw2, float* dalpha, float* partials,
                           int* tiles, int* starts, int B, int L, int D, int H, int blocks,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int warps = 0;
  size_t smem = 0;
  cudaError_t err;
  Kernel kern = kernel_for(D, H, &warps, &smem, &err);
  if (kern == nullptr) return static_cast<int>(err);
  din_attention_bwd_tiles<<<(B + 7) / 8, 256, 0, s>>>(m, B, L, tiles);
  din_attention_bwd_plan<<<1, 1024, 0, s>>>(tiles, B, blocks * warps, starts);
  kern<<<blocks, 32 * warps, smem, s>>>(q, k, m, w1, b1, w2, alpha, gp, gs, dq, dk, partials, tiles, starts, B,
                                        L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 32 * (D * H + 3 * H);  // a warp an output
  din_attention_bwd_reduce<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      partials, blocks, D, H, dw1, db1, dw2, dalpha);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
