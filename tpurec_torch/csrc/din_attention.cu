// DIN target attention forward for Hopper (sm_90a), fp32 in and out.
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:350
// din_attention_fused (_din_kernel, kernels.py:320-347). Same function as
// din_attention_plain in tpurec_torch/ops/kernels.py:
//
//   feats_l  = [q, q - k_l, k_l, q * k_l]                 (never materialised)
//   lin_l    = feats_l @ W1 + b1                          (H,)
//   score_l  = mask_l != 0 ? PReLU_alpha(lin_l) . w2 : 0
//   pooled   = sum_l score_l * k_l                        (D,)
//
// W1 (4D, H) splits into three D x H blocks (kernels.py:331-333):
//   w_q = W1[0:D] + W1[D:2D],  w_k = W1[2D:3D] - W1[D:2D],  w_p = W1[3D:4D]
// and per batch row the q-dependent terms fold into
//   c = q.w_q + b1 (H,),  W_eff = w_k + diag(q) w_p (D, H),  lin_l = c + k_l . W_eff
// so a step costs one D x H product. din_attention_unfolded (kernels.py) is
// the same arithmetic on the CPU in fp32, 3xTF32 and single TF32.
//
// What bounds it on an H100 at the serving shape (B=8192, L=64, D=32, H=36,
// lengths uniform in L/4..L, so ~62.5 % of the steps are live): a masked step
// scores 0 and adds nothing to pooled, so the function needs the keys of the
// live steps only, ~42 MB of the ~48 MB it must move: 14.4 us at 3.35 TB/s
// (chip_smoke.py counts it from its mask). Counted as fp32 FMA on the CUDA
// cores the folded products alone are ~0.9 GFLOP (~14 us at 67 TFLOP/s), so
// they go to the tensor cores.
//
// The design, against each cost of the earlier kernel (one 64-thread block a
// row, every step scored, the fold rebuilt from L2 in every block, a serial
// pooled sum; kept below as din_attention_fma_kernel):
// - Live tiles only. A warp takes a row, finds its last step with a nonzero
//   mask by ballots over the mask row, and works the 16-step tiles up to it.
//   Keys past that step are never read: a non-finite key there does not
//   reach pooled (the plain version's 0 * NaN does), as in the backward
//   kernel. Zero-mask steps inside the range go through the math and are set
//   to 0, so masks with holes stay exact. Scores past the range are written
//   as zeros.
// - Keys go straight from memory into mma.sync A fragments. The contraction
//   index of a 16 x 8 TF32 A tile may be permuted as long as the B tile takes
//   the same permutation, so lane (gid, tig) reads its rows gid and gid + 8 as
//   16-byte vectors of columns 16 c + 4 tig .. + 3 (8-byte ones at D = 8), a
//   quad reading 64 contiguous bytes; its vector element j serves the k-step
//   j / 2 (col<D> below). No shared-memory staging, every sector used once.
//   The next tile's keys and mask, or the next row's mask head and q and
//   then its first tile, are loaded while this tile computes; a warp's first
//   row's while the block stages its constants.
// - The fold once a row, from shared memory. A block holds w_k, w_p, w_q (in
//   the B-fragment order of lin's product), b1, w2 and alpha for its life;
//   per row a warp builds W_eff split into TF32 hi and lo, and c, from them.
// - lin = K W_eff on the tensor cores: mma.sync m16n8k8 TF32, D/8 k-steps by
//   H/8 n-tiles a tile (4 x 5 at H=36). One TF32 product keeps ~3 decimal
//   digits and misses the fp32 limits (chip_smoke.py's broken_single_tf32),
//   so each operand is split into TF32 hi and lo and a product is
//   hi.hi + hi.lo + lo.hi in fp32 (3xTF32). lin stays in the accumulators
//   through c, PReLU and the .w2 dot; a quad's four partial dots are added
//   by shuffles, the mask applied and the score stored.
// - pooled from the tile already in registers: each lane adds s_l k_l for
//   its two steps and its D/4 columns; at the row's end the eight lanes of a
//   column add by a shuffle butterfly.
// - Even work without a planning pass: the grid is as many blocks as the
//   card holds at once, each takes a contiguous range of rows, and its warps
//   take the range's rows one at a time (warp w the w-th first, then the
//   next from a shared counter), so a warp that drew short rows takes more. The counter decides which warp works a
//   row, never how: each row's outputs come from one warp in a fixed order.
//
// The sum order (the same bits on every call): a step's score adds its H
// columns as lane (gid, tig) takes columns 8 nt + 2 tig (+1) in nt order,
// then the quad's four lanes by xor 1, xor 2. pooled[d] is, for each of the
// eight lanes holding column d, fma(s_{gid+8}, k, fma(s_gid, k, acc)) tile by
// tile, then those eight added by xor 4, 8, 16. No float atomics.
//
// Shapes: D in {8, 16, 32, 64}, any B and L, H up to 128 (NT of 1-6, 8, 10,
// 12 or 16 n-tiles, H padded up with zero columns: c = W_eff = w2 = 0 there).
// Wider H runs din_attention_fma_kernel, the earlier fp32 kernel, which holds
// a row's keys in shared memory and so takes L only as far as that fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxSmemBytes = 232448;  // Hopper's per-block limit (227 KB)
constexpr int kMaskAhead = 2;          // 32-step mask chunks loaded a row ahead

// n-tiles of 8 columns the tensor-core kernel is built for: H is padded up to
// the next; 0 past the widest (that H runs the fp32 kernel)
__host__ __device__ inline int nt_for(int H) {
  const int nt = (H + 7) / 8;
  return nt <= 6 ? nt : (nt <= 8 ? 8 : (nt <= 10 ? 10 : (nt <= 12 ? 12 : (nt <= 16 ? 16 : 0))));
}

// Shared memory, in floats (Hp = 8 NT). The block's constants: w_k and w_p
// as [D/8][NT][32 lanes][wk0, wk1, wp0, wp1] and w_q as [D/8][NT][32][wq0,
// wq1], each lane's entries its B fragment of lin's product; b1, w2, alpha
// (Hp each). Each warp's own: the row's W_eff as [D/8][NT][32][hi0, hi1, lo0,
// lo1], and c (Hp).
__host__ __device__ constexpr int const_floats(int D, int Hp) { return 3 * D * Hp + 3 * Hp; }
__host__ __device__ constexpr int warp_floats(int D, int Hp) { return 2 * D * Hp + Hp; }

// x = hi + lo, both TF32 (as in din_attention_bwd.cu): hi is x rounded to
// nearest, ties away from zero; lo = x - hi is exact in fp32 and gets the
// same rounding from the half ulp added, the tensor cores reading its 19
// high bits.
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

__device__ __forceinline__ float quad_sum(float v) {  // over tig (lane bits 0-1)
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float gid_sum(float v) {  // over gid (lane bits 2-4)
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The column of a row that lane tig holds as its element j (j < D/4): chunks
// of W contiguous columns (W = 4, or 2 at D = 8), lane tig the tig-th chunk
// of each group of four. Elements 2 kt and 2 kt + 1 are the A fragment's
// columns tig and tig + 4 of k-step kt.
template <int D>
__host__ __device__ constexpr int col(int j, int tig) {
  constexpr int W = D == 8 ? 2 : 4;
  return 4 * W * (j / W) + W * tig + j % W;
}

// this lane's D/4 columns of a D-wide row, from p = the row + its first
// column (16- or 8-byte loads)
template <int D>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, float (&v)[D / 4]) {
  if constexpr (D == 8) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + 16 * c));
      v[4 * c] = x.x;
      v[4 * c + 1] = x.y;
      v[4 * c + 2] = x.z;
      v[4 * c + 3] = x.w;
    }
  }
}

template <int D>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int tig, const float (&v)[D / 4]) {
  if constexpr (D == 8) {
    reinterpret_cast<float2*>(row)[tig] = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      reinterpret_cast<float4*>(row + 16 * c)[tig] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    }
  }
}

template <int D, int NT>
__global__ void __launch_bounds__(32 * kMaxWarps, (D <= 32 && NT <= 6) ? 2 : 1) din_attention_tc_kernel(
    const float* __restrict__ query,  // (B, D)
    const float* __restrict__ keys,   // (B, L, D)
    const float* __restrict__ mask,   // (B, L)
    const float* __restrict__ w1,     // (4D, H)
    const float* __restrict__ b1,     // (H,)
    const float* __restrict__ w2,     // (H,)
    const float* __restrict__ alpha,  // (H,)
    float* __restrict__ pooled,       // (B, D)
    float* __restrict__ scores,       // (B, L)
    int B, int L, int H) {
  constexpr int KT = D / 8;  // k-steps of lin's product
  constexpr int J = D / 4;   // columns a lane holds of a row
  constexpr int Hp = 8 * NT;
  extern __shared__ __align__(16) float smem[];
  __shared__ int next_row;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;

  float* wkp = smem;
  float* wqf = wkp + 2 * D * Hp;
  float* b1_s = wqf + D * Hp;
  float* w2_s = b1_s + Hp;
  float* al_s = w2_s + Hp;
  float* weff = smem + const_floats(D, Hp) + warp * warp_floats(D, Hp);
  float* c_s = weff + 2 * D * Hp;

  // the block's rows: warp w takes the range's w-th, then the next from the
  // counter
  const int r_begin = static_cast<int>(static_cast<long long>(B) * blockIdx.x / gridDim.x);
  const int r_end = static_cast<int>(static_cast<long long>(B) * (blockIdx.x + 1) / gridDim.x);

  // what is loaded ahead: the next row's mask head and q, and the next
  // tile's keys (rows gid, gid + 8) and mask
  float mh[kMaskAhead], qv[J], kn[2][J], mn[2];
  auto start_row = [&](int r) {
    if (r >= r_end) return;
#pragma unroll
    for (int c = 0; c < kMaskAhead; ++c) {
      const int l = 32 * c + lane;
      mh[c] = l < L ? __ldg(mask + static_cast<size_t>(r) * L + l) : 0.f;
    }
    load_cols<D>(query + static_cast<size_t>(r) * D + (D == 8 ? 2 : 4) * tig, qv);
  };
  int row = r_begin + warp;
  start_row(row);  // in flight while the constants are staged

  // the block's constants; padded columns are zero
  for (int i = threadIdx.x; i < KT * NT * 32; i += blockDim.x) {
    const int ln = i % 32, nt = (i / 32) % NT, kt = i / (32 * NT);
    const int h = 8 * nt + (ln >> 2);
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (h < H) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = col<D>(2 * kt + e, ln & 3);
        const float wd = __ldg(w1 + (D + d) * H + h);
        v[e] = __ldg(w1 + (2 * D + d) * H + h) - wd;  // w_k
        v[2 + e] = __ldg(w1 + (3 * D + d) * H + h);   // w_p
        v[4 + e] = __ldg(w1 + d * H + h) + wd;        // w_q
      }
    }
    reinterpret_cast<float4*>(wkp)[i] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float2*>(wqf)[i] = make_float2(v[4], v[5]);
  }
  for (int h = threadIdx.x; h < Hp; h += blockDim.x) {
    b1_s[h] = h < H ? __ldg(b1 + h) : 0.f;
    w2_s[h] = h < H ? __ldg(w2 + h) : 0.f;
    al_s[h] = h < H ? __ldg(alpha + h) : 0.f;
  }
  if (threadIdx.x == 0) next_row = r_begin + blockDim.x / 32;
  __syncthreads();

  auto grab = [&]() {
    int r = 0;
    if (lane == 0) r = atomicAdd(&next_row, 1);
    return __shfl_sync(0xffffffffu, r, 0);
  };
  // the row's live 16-step tiles, up to its last step with a nonzero mask
  auto live_tiles = [&](int r) {
    if (r >= r_end) return 0;
    int last = -1;
#pragma unroll
    for (int c = 0; c < kMaskAhead; ++c) {
      const unsigned bits = __ballot_sync(0xffffffffu, mh[c] != 0.f);
      if (bits) last = 32 * c + 31 - __clz(bits);
    }
    for (int l0 = 32 * kMaskAhead; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      const float m = l < L ? __ldg(mask + static_cast<size_t>(r) * L + l) : 0.f;
      const unsigned bits = __ballot_sync(0xffffffffu, m != 0.f);
      if (bits) last = l0 + 31 - __clz(bits);
    }
    return (last + 16) / 16;
  };
  // a tile's keys (rows gid, gid + 8) and mask, from the row's keys kr
  // (at lane's step gid and first column) and mask mr (at step gid)
  const float *kr = keys, *mr = mask;
  auto fetch = [&](int l0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = l0 + 8 * e;
      if (l + gid < L) {
        load_cols<D>(kr + static_cast<size_t>(l) * D, kn[e]);
        mn[e] = __ldg(mr + l);
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) kn[e][j] = 0.f;
        mn[e] = 0.f;
      }
    }
  };
  auto fetch_row = [&](int r) {
    kr = keys + (static_cast<size_t>(r) * L + gid) * D + (D == 8 ? 2 : 4) * tig;
    mr = mask + static_cast<size_t>(r) * L + gid;
    fetch(0);
  };

  int tiles = live_tiles(row);
  if (tiles > 0) fetch_row(row);
  while (row < r_end) {
    const size_t row_l = static_cast<size_t>(row) * L;
    // the fold: W_eff in TF32 parts (this lane's B fragments) and c = q.w_q
    // + b1 (lane sums over its columns, then over the quad)
    if (tiles > 0) {
      float cq[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) cq[nt] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const float qa = qv[2 * kt], qb = qv[2 * kt + 1];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int i = (kt * NT + nt) * 32 + lane;
          const float4 w = reinterpret_cast<const float4*>(wkp)[i];
          const float2 wq = reinterpret_cast<const float2*>(wqf)[i];
          uint32_t h0, l0, h1, l1;
          split(fmaf(qa, w.z, w.x), h0, l0);
          split(fmaf(qb, w.w, w.y), h1, l1);
          reinterpret_cast<float4*>(weff)[i] =
              make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0), __uint_as_float(l1));
          cq[nt] = fmaf(qa, wq.x, fmaf(qb, wq.y, cq[nt]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float c = quad_sum(cq[nt]);
        if (tig == 0) c_s[8 * nt + gid] = c + b1_s[8 * nt + gid];
      }
      __syncwarp();
    }

    float p[J];
#pragma unroll
    for (int j = 0; j < J; ++j) p[j] = 0.f;
    int nrow = row, ntiles = 0;
    for (int t = 0; t < tiles; ++t) {
      const int l0 = 16 * t;
      float k[2][J];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int j = 0; j < J; ++j) k[e][j] = kn[e][j];
      }
      const float m0 = mn[0], m1 = mn[1];
      // in flight while this tile computes
      const bool last = t + 1 == tiles;
      if (!last) {
        fetch(l0 + 16);
      } else {
        nrow = grab();
        start_row(nrow);
      }
      // lin = K W_eff: NT independent chains of KT 3xTF32 products
      float lin[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) lin[nt][e] = 0.f;
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t ah[4], al[4];
        split(k[0][2 * kt], ah[0], al[0]);
        split(k[1][2 * kt], ah[1], al[1]);
        split(k[0][2 * kt + 1], ah[2], al[2]);
        split(k[1][2 * kt + 1], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 b = reinterpret_cast<const float4*>(weff)[(kt * NT + nt) * 32 + lane];
          mma3(lin[nt], ah, al, __float_as_uint(b.x), __float_as_uint(b.y), __float_as_uint(b.z),
               __float_as_uint(b.w));
        }
      }
      // c, PReLU and .w2 in registers: lin[nt][cc] is step gid, lin[nt][2 + cc]
      // step gid + 8, both at column 8 nt + 2 tig + cc
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 c2 = *reinterpret_cast<const float2*>(c_s + 8 * nt + 2 * tig);
        const float2 w2v = *reinterpret_cast<const float2*>(w2_s + 8 * nt + 2 * tig);
        const float2 a2 = *reinterpret_cast<const float2*>(al_s + 8 * nt + 2 * tig);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float c = cc ? c2.y : c2.x, w = cc ? w2v.y : w2v.x, a = cc ? a2.y : a2.x;
          const float x0 = lin[nt][cc] + c, x1 = lin[nt][2 + cc] + c;
          s0 = fmaf(fmaxf(x0, 0.f) + a * fminf(x0, 0.f), w, s0);
          s1 = fmaf(fmaxf(x1, 0.f) + a * fminf(x1, 0.f), w, s1);
        }
      }
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      s0 = m0 != 0.f ? s0 : 0.f;
      s1 = m1 != 0.f ? s1 : 0.f;
      if (tig == 0) {
        if (l0 + gid < L) scores[row_l + l0 + gid] = s0;
        if (l0 + gid + 8 < L) scores[row_l + l0 + gid + 8] = s1;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) p[j] = fmaf(s1, k[1][j], fmaf(s0, k[0][j], p[j]));
      if (last) {
        ntiles = live_tiles(nrow);
        if (ntiles > 0) fetch_row(nrow);
      }
    }
    if (tiles == 0) {
      nrow = grab();
      start_row(nrow);
      ntiles = live_tiles(nrow);
      if (ntiles > 0) fetch_row(nrow);
    }

    // the row's end: pooled (the eight lanes of each column added), and the
    // scores past the live range
#pragma unroll
    for (int j = 0; j < J; ++j) p[j] = gid_sum(p[j]);
    if (gid == 0) store_cols<D>(pooled + static_cast<size_t>(row) * D, tig, p);
    for (int l = 16 * tiles + lane; l < L; l += 32) scores[row_l + l] = 0.f;
    row = nrow;
    tiles = ntiles;
    __syncwarp();  // the next row overwrites W_eff and c
  }
}

// Warps a block (up to 8, as many as shared memory allows) and its shared
// memory; 0 warps when H is past the widest build.
int warps_for(int D, int H) {
  const int nt = nt_for(H);
  if (nt == 0) return 0;
  const long room = (kMaxSmemBytes - 16) / 4 - const_floats(D, 8 * nt);  // 16: next_row
  const long w = room / warp_floats(D, 8 * nt);
  return static_cast<int>(w < 0 ? 0 : (w > kMaxWarps ? kMaxWarps : w));
}

size_t tc_smem_bytes(int D, int H, int warps) {
  const int Hp = 8 * nt_for(H);
  return 4 * (static_cast<size_t>(const_floats(D, Hp)) + static_cast<size_t>(warps) * warp_floats(D, Hp));
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int);

template <int D>
Kernel kernel_nt(int nt) {
  switch (nt) {
    case 1: return din_attention_tc_kernel<D, 1>;
    case 2: return din_attention_tc_kernel<D, 2>;
    case 3: return din_attention_tc_kernel<D, 3>;
    case 4: return din_attention_tc_kernel<D, 4>;
    case 5: return din_attention_tc_kernel<D, 5>;
    case 6: return din_attention_tc_kernel<D, 6>;
    case 8: return din_attention_tc_kernel<D, 8>;
    case 10: return din_attention_tc_kernel<D, 10>;
    case 12: return din_attention_tc_kernel<D, 12>;
    case 16: return din_attention_tc_kernel<D, 16>;
    default: return nullptr;
  }
}

Kernel tc_kernel(int D, int H) {
  switch (D) {
    case 8: return kernel_nt<8>(nt_for(H));
    case 16: return kernel_nt<16>(nt_for(H));
    case 32: return kernel_nt<32>(nt_for(H));
    case 64: return kernel_nt<64>(nt_for(H));
    default: return nullptr;
  }
}

// The tensor-core kernel's launch for (B, D, H): its blocks (as many as the
// card holds at once, at most one row a warp), warps and shared memory, with
// the shared-memory limit set. Returns a cudaError_t.
cudaError_t tc_launch_shape(Kernel k, int B, int D, int H, int* blocks, int* warps, size_t* smem) {
  *warps = warps_for(D, H);
  if (*warps < 1) return cudaErrorInvalidValue;
  *smem = tc_smem_bytes(D, H, *warps);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32 * *warps, *smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long n = static_cast<long>(per_sm > 0 ? per_sm : 1) * sms;
  const long need = (static_cast<long>(B) + *warps - 1) / *warps;
  *blocks = static_cast<int>(n < need ? n : need);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The fp32 kernel, for H past the tensor-core kernel's widest build: one
// thread block a row, one thread a step, the row's keys in shared memory
// (padded to D + 1 floats a row), W_eff and c folded in each block from w1,
// every step scored on the CUDA cores (one 16-byte shared load of W_eff per
// four FMAs), pooled summed by D threads in step order.
constexpr int kFmaThreads = 64;

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

template <int D>
__global__ void __launch_bounds__(kFmaThreads) din_attention_fma_kernel(
    const float* __restrict__ query, const float* __restrict__ keys, const float* __restrict__ mask,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ alpha, float* __restrict__ pooled, float* __restrict__ scores, int L, int H) {
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

  for (int d = tid; d < D; d += kFmaThreads) q_s[d] = q_row[d];
  const float4* k4 = reinterpret_cast<const float4*>(k_row);
  for (int i = tid; i < L * D / 4; i += kFmaThreads) {
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

  for (int i = tid; i < D * hp; i += kFmaThreads) {
    const int d = i / hp;
    const int h = i % hp;
    float v = 0.f;
    if (h < H) {
      const float wk = __ldg(w1 + (2 * D + d) * H + h) - __ldg(w1 + (D + d) * H + h);
      v = fmaf(q_s[d], __ldg(w1 + (3 * D + d) * H + h), wk);
    }
    weff_s[i] = v;
  }
  for (int h = tid; h < hp; h += kFmaThreads) {
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

  for (int l = tid; l < L; l += kFmaThreads) {
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

  for (int d = tid; d < D; d += kFmaThreads) {
    float p = 0.f;
    for (int l = 0; l < L; ++l) p = fmaf(s_s[l], k_s[l * (D + 1) + d], p);
    pooled[static_cast<size_t>(b) * D + d] = p;
  }
}

size_t fma_smem_bytes(int L, int D, int H) {
  const int hp = round_up4(H);
  return sizeof(float) * (static_cast<size_t>(D) * hp + 3 * hp + D + L + static_cast<size_t>(L) * (D + 1));
}

template <int D>
cudaError_t launch_fma(const float* q, const float* k, const float* m, const float* w1, const float* b1,
                       const float* w2, const float* alpha, float* pooled, float* scores, int B, int L, int H,
                       cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(L, D, H);
  cudaError_t err =
      cudaFuncSetAttribute(din_attention_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  din_attention_fma_kernel<D><<<B, kFmaThreads, smem, stream>>>(q, k, m, w1, b1, w2, alpha, pooled, scores, L, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Which kernel (D, H) runs: 1 the tensor-core kernel, 0 the fp32 kernel.
int din_attention_route(int D, int H) { return tc_kernel(D, H) != nullptr && warps_for(D, H) > 0 ? 1 : 0; }

// Dynamic shared memory (bytes) one block of the kernel that runs (L, D, H)
// uses; the wrapper checks it against the card's per-block limit (only the
// fp32 kernel, which holds a row's keys, can exceed it).
size_t din_attention_smem_bytes(int L, int D, int H) {
  return din_attention_route(D, H) ? tc_smem_bytes(D, H, warps_for(D, H)) : fma_smem_bytes(L, D, H);
}

// Warps a block of the kernel that runs (D, H).
int din_attention_warps(int D, int H) { return din_attention_route(D, H) ? warps_for(D, H) : kFmaThreads / 32; }

// Blocks the kernel that runs (B, D, H) launches, or a negated cudaError_t.
int din_attention_blocks(int B, int D, int H) {
  if (!din_attention_route(D, H)) return B;  // a block a row
  int blocks = 0, warps = 0;
  size_t smem = 0;
  const cudaError_t err = tc_launch_shape(tc_kernel(D, H), B, D, H, &blocks, &warps, &smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Returns a cudaError_t (0 = launched). D must be one of the built widths;
// every pointer is a contiguous fp32 device array, keys on a 16-byte boundary.
int din_attention_forward(const float* q, const float* k, const float* m, const float* w1, const float* b1,
                          const float* w2, const float* alpha, float* pooled, float* scores, int B, int L, int D,
                          int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (din_attention_route(D, H)) {
    Kernel kern = tc_kernel(D, H);
    int blocks = 0, warps = 0;
    size_t smem = 0;
    const cudaError_t err = tc_launch_shape(kern, B, D, H, &blocks, &warps, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<blocks, 32 * warps, smem, s>>>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H);
    return static_cast<int>(cudaGetLastError());
  }
  switch (D) {
    case 8: return launch_fma<8>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, s);
    case 16: return launch_fma<16>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, s);
    case 32: return launch_fma<32>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, s);
    case 64: return launch_fma<64>(q, k, m, w1, b1, w2, alpha, pooled, scores, B, L, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
