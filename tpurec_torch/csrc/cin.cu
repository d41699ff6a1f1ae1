// CIN (the xDeepFM compressed interaction network) forward for Hopper
// (sm_90a), fp32 in and out, every level in one launch, its products on the
// tensor cores (wgmma) in 3xTF32.
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:cin_fused
// (_cin_kernel, :218-245). Same function as cin_reference: with x_0 = e
// (B, F, D) and one weight W_l (H_l*F, S_l) per level (H_0 = F,
// H_{l+1} = S_l),
//
//   x_{l+1}[b, s, d] = sum_{h, f} W_l[h*F + f, s] * x_l[b, h, d] * e[b, f, d]
//   out[b, off_l + s] = sum_d x_{l+1}[b, s, d]        (off_l = S_0 + ... + S_{l-1})
//
// What bounds it on an H100: operations. At the xDeepFM serving shape
// (B=8192, F=26, D=32, sizes (128, 128)) one call is ~269 GFLOP of
// multiply-adds over M = B*D = 262,144 rows (b, d): 45.4 for level 1
// (K = H*F = 676), 223.3 for level 2 (K = 3,328), against ~30 MB of inputs
// and outputs (~9 us at 3.35 TB/s): 4.0 ms on the CUDA cores in fp32 at 67
// TFLOP/s. On the tensor cores a product keeps fp32's accuracy in 3xTF32:
// v = hi + lo (both TF32), a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, three
// TF32 multiply-adds per fp32 one, so the least time is 3 * 269 GFLOP /
// 495 TFLOP/s = 1.63 ms (plus ~0.05 ms of fp32 work below). One TF32
// product misses the fp32 limit (cin_products in tpurec_torch/ops/kernels.py,
// which the CPU tests run); 3xTF32 holds it.
//
// Design. As the TPU kernel, each level contracts H first, per field f:
//
//   C_f[m, s] = sum_h x_l[m, h] * W_l[h*F + f, s]      (tensor cores, K = H)
//   acc[m, s] += e[m, f] * C_f[m, s]                    (fp32 FMA, f = 0..F-1)
//
// This replaces a design that formed A[m, h*F + f] = x*e in registers
// and summed its K = H*F products in fp32 FMA on the CUDA cores, which
// stays below for shapes this one cannot hold.
// Every tensor-core sum here is short (a fresh C for each f, K = H rounded
// up to 8), which matters because the tensor cores' fp32 accumulation does
// not round to nearest; the sum over f is fp32 FMA in a fixed order. Level
// 1's K = F = 26 is padded to 32 (4 % of the call's work).
//
// - A block owns Bt = 128 / D whole batch rows (M = Bt*D rows, so the sum
//   over d stays in the block; D > 128 takes one batch row in 128-row
//   tiles) and keeps e, x_l and the next level's x in shared memory,
//   column-major (one row of shared memory per field or map, stride
//   rows + 8, so that a warp's fragment loads hit 32 distinct banks).
// - A block tile is 128 rows x 128 columns: two warpgroups of 64 rows, each
//   C_f and acc in registers (64 floats a thread). A warpgroup's products
//   are wgmma m64n128k8 TF32: A, this warp's 16 x 8 slice of x_l, from
//   registers; B, W_l's 8 x 128 slice for field f, from shared memory as
//   K-major core matrices (8 columns x 4 maps, 128 contiguous bytes).
//   (mma.sync m16n8k8 with the same tiles took 3.14 ms at B=4096 where
//   this takes 1.89, chip_smoke.py --cin on an NVIDIA H100 80GB HBM3 at
//   700 W.)
// - Operands split as v = hi + lo with hi = v itself (the tensor cores read
//   a TF32 operand's 19 high bits, so hi is v truncated to TF32) and lo =
//   v - trunc(v), exact in fp32 and truncated in turn: two operations a
//   value. x's fragments are split as they are loaded; W when it is staged.
//   W is never pre-split in device memory, which would double the bytes
//   from L2.
// - W_l streams from L2 in stages of 32 maps x 128 columns of one field (hi
//   and lo, double-buffered, one block barrier a stage): F * ceil(H / 32)
//   stages a tile, 26 at level 1 and 104 at level 2 of the slice. Each
//   thread holds a quarter of the next stage in registers and stores it,
//   and fetches the stage after, a quarter after each k-step's products: a
//   warp cannot pass its queued wgmma until they have read their A
//   registers, about as long as they take to run, so the staging fills that
//   time instead of following it.
// - The new maps are stored into shared memory as the next level's x; the
//   level's slice of the output is their column sums over d, one thread an
//   output, d in order. No float atomics: the same bits on every call.
//
// Resources at the slice's shape: 222,208 bytes of shared memory a block
// (e 32 x 136, two maps buffers 128 x 136, the W stages 4 x 32 x 128
// floats), so one block of 8 warps an SM; ~226 registers a thread. Bytes
// from L2: every block reads the whole of every W_l, 2.05 MB at the slice's
// shape, so 4.2 GB a call at B=8192 (2,048 blocks) and 0.52 GB at B=1024.
// Waves: 2,048 blocks on 132 SMs are 15.5 waves at B=8192; at B=1024
// (evaluate's shape) 256 blocks are 1.94 waves.
//
// Any F, D and level sizes: rows past the batch and maps past H are zero
// (so they add nothing), columns past S are computed on zero weights and
// not stored. Shapes whose shared memory this kernel cannot hold (level
// sizes above 136 at F = 26, D <= 128) run the fp32-FMA kernel
// (cin_fma_kernel, below), and the wrapper refuses shapes neither fits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;            // rows of a block tile
constexpr int kTileN = 128;            // columns of a block tile
constexpr int kKC = 32;                // maps h of one W stage
constexpr int kStageFloats = kKC * kTileN;
constexpr uint32_t kLBO = 128;             // bytes to a core matrix's next 4 maps
constexpr uint32_t kSBO = kKC / 4 * 128;   // bytes to the next 8 columns
constexpr int kMaxLevels = 8;
constexpr int kMaxSmemBytes = 232448;  // Hopper's per-block limit (227 KB)

struct Levels {
  int n;
  int sizes[kMaxLevels];
  const float* w[kMaxLevels];
};

__host__ __device__ inline int rows_per_block(int D) { return D >= kTileM ? 1 : kTileM / D; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {
  int bt;  // batch rows of a block
  int mb;  // live rows (bt * D)
  int mr;  // rows computed (mb rounded up to a tile)
  int mp;  // row stride of e and the maps (mr + 8: 8 mod 32)
  int fp;  // rows of e (F rounded up to 8: the level-1 K padding)
  int sp;  // rows of a maps buffer (largest S rounded up to 8)
};

__host__ __device__ inline Layout make_layout(int F, int D, int smax) {
  Layout L;
  L.bt = rows_per_block(D);
  L.mb = L.bt * D;
  L.mr = round_up(L.mb, kTileM);
  L.mp = L.mr + 8;
  L.fp = round_up(F, 8);
  L.sp = round_up(smax, 8);
  return L;
}

// e, two maps buffers, and the W stages (hi and lo, two of each)
__host__ __device__ inline size_t smem_floats(const Layout& L) {
  return static_cast<size_t>(L.fp + 2 * L.sp) * L.mp + 4 * static_cast<size_t>(kStageFloats);
}

// v = hi + lo, both read as TF32 by the tensor cores (their 19 high bits):
// hi is v itself (truncated to TF32 by the read), lo = v - trunc(v) is exact
// in fp32 (and is truncated by the read in turn)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v);
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));
}

// d (64 rows x 128 columns of a warpgroup) [+]= a (this warp's 16 x 8
// TF32 fragment, mma.sync's A layout) . b (8 x 128 TF32 in shared memory,
// K-major, described by desc); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps a register live (and unchanged) up to this point: the A fragments
// and C must outlive the wgmma that read and write them
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Descriptor of a K-major TF32 tile without swizzle: core matrices of 8
// rows (columns n of W) x 16 bytes (4 maps k) stored as 128 contiguous
// bytes, the next 4 k lbo bytes on, the next 8 rows sbo bytes on.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// A W stage (maps h0 .. h0+31 of field f, columns ct .. ct+127) as TF32
// core matrices: element (n, k) at float ((n/8)*8 + k/4)*32 + (n%8)*4 + k%4.
// Thread (warp w, lane) holds k = 4w + lane%4 and n = 8i + lane/4 for
// i = 0..15, whose offset is i*256 + tid: a stage's stores are linear.
constexpr int kPer = kKC * kTileN / kThreads;  // elements of a stage a thread holds
struct StageSrc {
  const float* p;  // W_l row (h0 + k)*F + f, column ct + lane/4
  int ncol;        // columns S - ct - lane/4 this thread may read
};
__device__ __forceinline__ StageSrc stage_src(const float* wl, int f, int h0, int H, int F, int S,
                                              int ct, int warp, int lane) {
  const int h = h0 + 4 * warp + lane % 4;
  const int n0 = ct + lane / 4;
  StageSrc s;
  s.p = wl + (static_cast<size_t>(min(h, H - 1)) * F + f) * S + min(n0, S - 1);
  s.ncol = h < H ? S - n0 : 0;
  return s;
}
__device__ __forceinline__ float fetch1(const StageSrc& s, int i) {
  return 8 * i < s.ncol ? __ldg(s.p + 8 * i) : 0.f;
}
__device__ __forceinline__ void store1(float v, float* hi, float* lo, int i, int tid) {
  uint32_t h, l;
  split(v, h, l);
  hi[i * kThreads + tid] = __uint_as_float(h);
  lo[i * kThreads + tid] = __uint_as_float(l);
}

__global__ void __launch_bounds__(kThreads, 1) cin_kernel(
    const float* __restrict__ emb,  // (B, F, D)
    float* __restrict__ out,        // (B, sum S_l)
    Levels lv, int B, int F, int D, int smax, int total_s) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(F, D, smax);
  const int mp = L.mp;
  float* e_s = smem;                 // (fp, mp): e[m, f] at f*mp + m
  float* buf0 = e_s + L.fp * mp;     // (sp, mp)
  float* buf1 = buf0 + L.sp * mp;    // (sp, mp)
  float* bhi = buf1 + L.sp * mp;       // 2 W stages, hi (kKC x kTileN core matrices)
  float* blo = bhi + 2 * kStageFloats;  // 2 W stages, lo

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int wg = warp / 4;  // warpgroup: rows wg*64 .. +63 of a tile
  const int wq = warp % 4;  // warp of the warpgroup: its rows wq*16 .. +15
  const int b0 = blockIdx.x * L.bt;
  const int nb = min(L.bt, B - b0);

  // e, row m = bl*D + d of field f; rows past the batch and fields past F
  // are zero
  const float* e_g = emb + static_cast<size_t>(b0) * F * D;
  for (int i = tid; i < L.fp * L.mr; i += kThreads) {
    const int f = i / L.mr;
    const int m = i % L.mr;
    const int bl = m / D;
    float v = 0.f;
    if (f < F && m < L.mb && bl < nb) v = __ldg(e_g + (static_cast<size_t>(bl) * F + f) * D + m % D);
    e_s[f * mp + m] = v;
  }

  const float* x = e_s;
  float* y = buf0;
  int H = F;
  int off = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int S = lv.sizes[l];
    const float* wl = lv.w[l];
    const int nkc = (H + kKC - 1) / kKC;
    const int T = F * nkc;
    // maps S .. round_up(S, 8) - 1 are the next level's K padding: zero
    for (int i = tid; i < (round_up(S, 8) - S) * L.mr; i += kThreads) {
      y[(S + i / L.mr) * mp + i % L.mr] = 0.f;
    }
    for (int rt = 0; rt < L.mr; rt += kTileM) {
      for (int ct = 0; ct < S; ct += kTileN) {
        const int m0 = rt + wg * 64 + wq * 16;  // this warp's 16 rows
        float acc[64];
        float c[64];
#pragma unroll
        for (int r = 0; r < 64; ++r) acc[r] = 0.f;
        float v[kPer];
        __syncthreads();  // the W stages are free; e, x and y's zeros are in
        {
          const StageSrc s0 = stage_src(wl, 0, 0, H, F, S, ct, warp, lane);
#pragma unroll
          for (int i = 0; i < kPer; ++i) store1(fetch1(s0, i), bhi, blo, i, tid);
          const StageSrc s1 = stage_src(wl, 1 / nkc, (1 % nkc) * kKC, H, F, S, ct, warp, lane);
#pragma unroll
          for (int i = 0; i < kPer; ++i) v[i] = T > 1 ? fetch1(s1, i) : 0.f;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        for (int t = 0; t < T; ++t) {
          const int f = t / nkc;
          const int kc = t % nkc;
          const int h0 = kc * kKC;
          const int nks = (min(kKC, H - h0) + 7) / 8;
          const float* bh = bhi + (t & 1) * kStageFloats;
          const float* bl = blo + (t & 1) * kStageFloats;
          uint32_t ah[kKC / 8][4], al[kKC / 8][4];
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
            if (ks < nks) {
              const float* xa = x + (h0 + ks * 8 + tig) * mp + m0 + gid;
              split(xa[0], ah[ks][0], al[ks][0]);
              split(xa[8], ah[ks][1], al[ks][1]);
              split(xa[4 * mp], ah[ks][2], al[ks][2]);
              split(xa[4 * mp + 8], ah[ks][3], al[ks][3]);
            }
          }
          // stage t+1's W (fetched a stage ago) is stored, and stage t+2's
          // fetched, a quarter after each k-step's products: a warp's wgmma
          // take about as long to issue as to run
          float* nh = bhi + ((t + 1) & 1) * kStageFloats;
          float* nl = blo + ((t + 1) & 1) * kStageFloats;
          const bool next1 = t + 1 < T;
          const bool next2 = t + 2 < T;
          const StageSrc s2 =
              stage_src(wl, (t + 2) / nkc, ((t + 2) % nkc) * kKC, H, F, S, ct, warp, lane);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
            if (ks < nks) {
              const uint64_t dh = smem_desc(bh + ks * 64, kLBO, kSBO);
              const uint64_t dl = smem_desc(bl + ks * 64, kLBO, kSBO);
              wgmma(c, al[ks], dh, kc != 0 || ks != 0);
              wgmma(c, ah[ks], dl, 1);
              wgmma(c, ah[ks], dh, 1);
            }
#pragma unroll
            for (int i = ks * kPer / 4; i < (ks + 1) * kPer / 4; ++i) {
              if (next1) store1(v[i], nh, nl, i, tid);
              if (next2) v[i] = fetch1(s2, i);
            }
          }
          wgmma_commit();
          wgmma_wait0();
#pragma unroll
          for (int ks = 0; ks < kKC / 8; ++ks) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              keep(ah[ks][r]);
              keep(al[ks][r]);
            }
          }
#pragma unroll
          for (int r = 0; r < 64; ++r) keep(c[r]);
          if (kc == nkc - 1) {  // C_f is complete: acc += e[:, f] * C_f
            const float e0 = e_s[f * mp + m0 + gid];
            const float e1 = e_s[f * mp + m0 + gid + 8];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              acc[4 * j + 0] = fmaf(e0, c[4 * j + 0], acc[4 * j + 0]);
              acc[4 * j + 1] = fmaf(e0, c[4 * j + 1], acc[4 * j + 1]);
              acc[4 * j + 2] = fmaf(e1, c[4 * j + 2], acc[4 * j + 2]);
              acc[4 * j + 3] = fmaf(e1, c[4 * j + 3], acc[4 * j + 3]);
            }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncthreads();  // stage t+1 is in; every warp is done with stage t
        }
        // the tile's new maps (rows gid and gid + 8 of the warp's 16,
        // columns 8j + 2*tig and 8j + 2*tig + 1)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int s = ct + 8 * j + 2 * tig;
          const int m = m0 + gid;
          if (s < S) {
            y[s * mp + m] = acc[4 * j + 0];
            y[s * mp + m + 8] = acc[4 * j + 2];
          }
          if (s + 1 < S) {
            y[(s + 1) * mp + m] = acc[4 * j + 1];
            y[(s + 1) * mp + m + 8] = acc[4 * j + 3];
          }
        }
      }
    }
    __syncthreads();  // y is complete
    // this level's slice of the output: sum over d of each (b, s), d in order
    for (int i = tid; i < nb * S; i += kThreads) {
      const int bl = i / S;
      const int s = i % S;
      const float* row = y + s * mp + bl * D;
      float sum = 0.f;
      for (int d = 0; d < D; ++d) sum += row[d];
      out[static_cast<size_t>(b0 + bl) * total_s + off + s] = sum;
    }
    off += S;
    H = S;
    x = y;
    y = (y == buf0) ? buf1 : buf0;
  }
}

// The fp32-FMA kernel (the earlier design), for shapes whose shared memory the
// tensor-core kernel cannot hold: at D <= 128 the tensor-core kernel takes
// level sizes up to 136 at F = 26 (144 at F = 3), this one up to 186 (220).
// Each level is a product over the rows (b, d) whose A[m, h*F + f] =
// x[m, h] * e[m, f] is formed in registers and never stored: a thread owns
// 8 x 8 outputs of a 128 x 128 block tile, the weights stream from L2 one
// map's (F, 128) slice at a time (cp.async, double-buffered), and the new
// maps stay in shared memory (rows of an odd stride) as the next level's x.
constexpr int kTM = 8;  // rows of a thread tile
constexpr int kTN = 8;  // columns of a thread tile

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// shared memory of cin_fma_kernel, in floats: e, two maps buffers (rows of
// stride mr + 1) and two weight slices
__host__ __device__ inline size_t fma_smem_floats(int F, int D, int smax) {
  const size_t mp = round_up(rows_per_block(D) * D, kTileM) + 1;
  return static_cast<size_t>(F) * mp + 2 * static_cast<size_t>(smax) * mp +
         2 * static_cast<size_t>(F) * kTileN;
}

// One map's slice of W_l, rows h*F .. h*F+F-1, columns ct .. ct+127, into
// dst (F, kTileN); columns past S are zero.
__device__ inline void load_w_slice(float* dst, const float* wl, int h, int F, int S, int ct,
                                    int tid) {
  const float* src = wl + static_cast<size_t>(h) * F * S + ct;
  for (int i = tid; i < F * kTileN; i += kThreads) {
    const int f = i / kTileN;
    const int c = i % kTileN;
    if (ct + c < S) {
      cp_async4(dst + i, src + static_cast<size_t>(f) * S + c);
    } else {
      dst[i] = 0.f;
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads) cin_fma_kernel(
    const float* __restrict__ emb,  // (B, F, D)
    float* __restrict__ out,        // (B, sum S_l)
    Levels lv, int B, int F, int D, int smax, int total_s) {
  extern __shared__ __align__(16) float smem[];
  const int bt = rows_per_block(D);
  const int mb = bt * D;                // live rows of the block
  const int mr = round_up(mb, kTileM);  // rows computed
  const int mp = mr + 1;                // odd stride of a shared-memory row
  float* e_s = smem;                    // (F, mp): e[m, f] at f*mp + m
  float* buf0 = e_s + F * mp;           // (smax, mp)
  float* buf1 = buf0 + smax * mp;       // (smax, mp)
  float* w_s0 = buf1 + smax * mp;       // (F, kTileN)
  float* w_s1 = w_s0 + F * kTileN;      // (F, kTileN)

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
  int h_count = F;
  int off = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int S = lv.sizes[l];
    const float* wl = lv.w[l];
    for (int rt = 0; rt < mr; rt += kTileM) {
      for (int ct = 0; ct < S; ct += kTileN) {
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
            for (int j = 0; j < kTN; ++j) wv[j] = w_cur[f * kTileN + tx + 16 * j];
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
    h_count = S;
    x = y;
    y = (y == buf0) ? buf1 : buf0;
  }
}

// The tensor-core kernel runs where its shared memory fits a block, else
// the fp32-FMA one.
bool tensor_cores(int F, int D, int smax) {
  return sizeof(float) * smem_floats(make_layout(F, D, smax)) <= static_cast<size_t>(kMaxSmemBytes);
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) one block of the kernel that runs this
// shape needs; the wrapper checks it against the card's per-block limit
// before launching.
size_t cin_smem_bytes(int F, int D, int smax) {
  return sizeof(float) * (tensor_cores(F, D, smax) ? smem_floats(make_layout(F, D, smax))
                                                   : fma_smem_floats(F, D, smax));
}

// Run once for each device and shape by the wrapper: lets the kernel use
// the card's whole per-block shared memory and returns the blocks of this
// shape an SM holds (occupancy query), or minus a cudaError_t.
int cin_blocks_per_sm(int F, int D, int smax) {
  if (F < 1 || D < 1 || smax < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = tensor_cores(F, D, smax) ? reinterpret_cast<const void*>(cin_kernel)
                                                 : reinterpret_cast<const void*>(cin_fma_kernel);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        cin_smem_bytes(F, D, smax));
  }
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// Returns a cudaError_t (0 = launched). w[l] is level l's weight, (H_l*F,
// S_l) row-major, a contiguous fp32 device array; sizes[l] = S_l, at most
// kMaxLevels (8) levels (w and sizes are host arrays). emb (B, F, D) and out
// (B, sum S_l) are contiguous fp32 device arrays. cin_blocks_per_sm must
// have run for the device first.
int cin_forward(const float* emb, const float* const* w, const int* sizes, int num_levels, float* out,
                int B, int F, int D, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || B < 1 || F < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  lv.n = num_levels;
  int smax = 1;
  int total_s = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.sizes[l] = 0;
    lv.w[l] = nullptr;
  }
  for (int l = 0; l < num_levels; ++l) {
    if (sizes[l] < 1 || w[l] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    lv.sizes[l] = sizes[l];
    lv.w[l] = w[l];
    smax = sizes[l] > smax ? sizes[l] : smax;
    total_s += sizes[l];
  }
  const size_t smem = cin_smem_bytes(F, D, smax);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  const int bt = rows_per_block(D);
  const int blocks = (B + bt - 1) / bt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores(F, D, smax)) {
    cin_kernel<<<blocks, kThreads, smem, st>>>(emb, out, lv, B, F, D, smax, total_s);
  } else {
    cin_fma_kernel<<<blocks, kThreads, smem, st>>>(emb, out, lv, B, F, D, smax, total_s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
