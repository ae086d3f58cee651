// Dense-window SpMM for wide multivectors on Hopper (sm_90a), on the
// tensor cores; plain C entry point loaded with ctypes
// (rails_tpu_torch/sparse/wide_spmm.py::wide_spmm).
//
// For every 128-row chunk b with window start c0[b] and every row
// i = 128 b + r < m and column j < s:
//
//   y[i, j] = sum_{c < w} sum_pass P_pass[b][c, r] * X_pass[c0[b] + c, j]
//
// P planes p_hi, p_lo (and p3 for six passes) are bfloat16, laid out
// (nb, w, 128): one contiguous (w, 128) block per chunk.  x (n, s) and
// y (m, s) are float32, row-major and contiguous.  x is split as it is
// staged: X_hi = bf16_rn(x), X_lo = bf16_rn(x - X_hi), X_3 = bf16_rn(x -
// X_hi - X_lo).  Three passes: xh*Ph + xh*Pl + xl*Ph; six add xl*Pl,
// xh*P3, x3*Ph.  A bf16 x bf16 product is exact in float32, so only the
// order and rounding of the float32 sums differ from the TPU kernel and
// the plain version.  Window rows c0[b] + c >= n and columns >= s read as
// zero: x is neither read past its end nor padded.
//
// Replaces: the JAX package's Pallas TPU kernel
// rails_tpu/sparse/wide_spmm.py::_wide_spmm_t_impl (wide_spmm.py:136,
// pallas_call at :199), which puts the same product on the TPU's matrix
// unit (:172-181).  Here the matrix unit is the tensor cores.
//
// Bound (the TPU CostEstimate, wide_spmm.py:203-207): the planes read
// once (planes * w * m_pad * 2 bytes), x read and y written once
// (2 * m_pad * s * 4 bytes), passes * 2 * w * 128 * s flops per chunk.
// Continuation shape (m = 16384, w = 384, s = 200): 3 passes 51 MB and
// 7.5 GFLOP, 6 passes 64 MB and 15.1 GFLOP: bound by bytes at 3.35 TB/s
// (15.3 and 19.1 us) against the 989 TFLOP/s bf16 peak.  Bench shape
// (m = 2^21, w = 384, 3 passes): 6.4 GB and 0.93 TFLOP at s = 192, bound
// by bytes (1.92 ms; 2.24 ms at s = 256).
//
// Design: each chunk is a GEMM D (128 x s) = P^T (128 x w) X (w x s), one
// per pass term.  The first version of this kernel (float32 FMAs, 64-
// column tiles) lost to one torch.sparse.mm call for three reasons, each
// addressed here:
// - Products on the CUDA cores (one float32 FMA per term): now bf16
//   mma.sync.m16n8k16 on the tensor cores, operands fetched from shared
//   memory with ldmatrix.trans (P is stored [c][r], so P^T is
//   column-major; X is [c][j]).  Shared rows are padded by 16 bytes, so
//   the eight rows of an ldmatrix phase fall in distinct banks.  A
//   16-row step of the window whose plane fragments are all zero for a
//   warp's 16 rows is skipped (a warp vote): a banded window is mostly
//   zeros, and skipping them is exact.
// - Synchronous staging through registers: now every K-tile (32 window
//   rows) goes to shared memory by cp.async in a ring of STAGES tiles,
//   the planes 16 bytes a copy, the float32 x tile 16 bytes a copy where
//   x's rows allow it (else 4), rows past n zero-filled.  While a tile
//   multiplies, the next two load.  Each thread then splits the x values
//   it copied into bf16 hi/lo(/x3) in a double-buffered shared tile;
//   split x never goes to device memory.
// - The planes read from HBM once per 64-column tile: now a block of 512
//   threads covers the whole chunk (16 warps: 8 groups of 16 rows x 2
//   halves of the columns) and a column tile of up to 256 columns at three
//   passes and 128 at six (the second accumulator below), a multiple of 8
//   chosen from s (wide_spmm.py::wide_tiling: s = 200 is one tile at three
//   passes, 104 + 96 at six).  The grid is 1-D with the column tile
//   fastest, so a chunk's tiles run side by side and the second reads its
//   planes from L2.
// - Accumulation: at six passes the leading term xh*Ph has its own
//   accumulator, apart from the correction terms.  The tensor cores sum in
//   float32 with truncation; kept apart, the small terms' truncation is
//   relative to a sum 2^8 smaller, and the two are added once, on the
//   CUDA cores, round-to-nearest: the 6-pass result stays within the JAX
//   tests' 5e-7 max|y| of the exact product.  Three passes (bound 8e-5)
//   use one accumulator and twice the column tile.
// What holds it back (PERF.md, section 6): moving the data, not the
// products.
// Without any mma it takes about as long: the planes are re-read from
// L2 once per column tile, x once per chunk whose window covers it (3x at
// w = 384), and every x value is split in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;           // output rows per block (the TPU chunk)
constexpr int BK = 32;               // window rows per K-tile
constexpr int STAGES = 3;            // K-tiles in flight
constexpr int WARPS = 16;            // 8 16-row groups x 2 column halves
constexpr int THREADS = WARPS * 32;  // 512
constexpr int PROW = CHUNK + 8;      // bf16 per padded plane row (272 B)

// The shapes of NP planes (2: three passes, 3: six).  Six passes keep
// the leading term's sum apart (two accumulators), so their column tile
// is half as wide for the same registers.
template <int NP>
struct Cfg {
  static constexpr int NACC = NP == 3 ? 2 : 1;  // accumulators
  static constexpr int NT = 256 / NACC;         // widest column tile
  static constexpr int WT = NT / 16;            // n8 tiles of a warp
  static constexpr int XROW = NT + 8;           // bf16 per padded x row
  static constexpr int XPT = BK * NT / THREADS; // x floats a thread stages
  static constexpr int TPR = NT / XPT;          // threads per x row
  // shared memory: the ring of float32 x tiles, the ring of plane
  // K-tiles, two buffers of split x
  static constexpr int XF_TILE = BK * NT;       // floats
  static constexpr int P_TILE = BK * PROW;      // bf16, one plane
  static constexpr int X_TILE = BK * XROW;      // bf16, one split
  static constexpr int BYTES = 4 * STAGES * XF_TILE +
                               2 * (STAGES * NP * P_TILE + 2 * NP * X_TILE);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 or 4 bytes, zero-filled (nothing read) unless `live`
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const int* c0;
  const __nv_bfloat16* planes[3];  // hi, lo and (six passes) p3
  int w, s, tw, nct;
  bool vec4;                       // x 16-byte aligned and s % 4 == 0
  long long n, m;
  const float* x;
  float* y;
};

// One warp's products over one 16-row step of the window: acc[.][j] +=
// P_p^T X_q (n8 tile j) for the pass terms, j < NN (the warp's live n8
// tiles; a template parameter, so that the products are one straight
// run of independent mma chains).  The leading term xh Ph goes to
// acc[0], the others to acc[NACC - 1].  A step whose plane fragments are
// all zero for the warp's 16 rows (most of a banded window) is skipped.
template <int NP, int NN>
__device__ __forceinline__ void step_products(
    float (&acc)[Cfg<NP>::NACC][Cfg<NP>::WT][4], const __nv_bfloat16* pt,
    const __nv_bfloat16* xt) {
  using C = Cfg<NP>;
  constexpr int NPAIR = (NN + 1) / 2;          // ldmatrix.x4 per split
  constexpr int GROUP = 4;                     // pairs live at a time
  unsigned a[NP][4];
  unsigned any = 0;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    ldsm_x4_trans(a[p], smem_addr(pt + p * C::P_TILE));
    any |= a[p][0] | a[p][1] | a[p][2] | a[p][3];
  }
  if (!__any_sync(0xffffffffu, any != 0)) return;

  float (&lead)[C::WT][4] = acc[0];
  float (&corr)[C::WT][4] = acc[C::NACC - 1];
  // split by split and up to 4 pairs of n8 tiles at a time, so that few
  // fragments are live at once
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int g0 = 0; g0 < NPAIR; g0 += GROUP) {
      unsigned bq[GROUP][4];
#pragma unroll
      for (int u = 0; u < GROUP; ++u)
        if (g0 + u < NPAIR)
          ldsm_x4_trans(bq[u], smem_addr(xt + q * C::X_TILE +
                                         (g0 + u) * 16));
      // acc[j] += ap * (tile j of the loaded pairs), chains that do not
      // wait on each other
      auto products = [&](float (&d)[C::WT][4], const unsigned (&ap)[4]) {
#pragma unroll
        for (int u = 0; u < 2 * GROUP; ++u) {
          const int j = 2 * g0 + u;
          if (j < NN)
            mma_bf16(d[j], ap, bq[u >> 1][2 * (u & 1)],
                     bq[u >> 1][2 * (u & 1) + 1]);
        }
      };
      if (q == 0) {
        products(lead, a[0]);                     // xh Ph
        products(corr, a[1]);                     // xh Pl
        if (NP == 3) products(corr, a[NP - 1]);   // xh P3
      } else if (q == 1) {
        products(corr, a[0]);                     // xl Ph
        if (NP == 3) products(corr, a[1]);        // xl Pl
      } else {
        products(corr, a[0]);                     // x3 Ph
      }
    }
  }
}

// a warp has at most WT live n8 tiles: no code for more
#define WIDE_CASE(k)                                              \
  case k:                                                         \
    if constexpr (k <= C::WT) step_products<NP, k>(acc, pk, xk);  \
    break;

// Block: chunk b, columns col0 .. col0 + cols - 1 of s.  Warp: 16 rows
// (warp % 8) and one half of the tile's n8 tiles (warp / 8).
template <int NP>
__global__ void __launch_bounds__(THREADS, 1) wide_spmm_kernel(Args g) {
  using C = Cfg<NP>;
  constexpr int NT = C::NT, XROW = C::XROW, XPT = C::XPT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xf = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* ps =
      reinterpret_cast<__nv_bfloat16*>(xf + STAGES * C::XF_TILE);
  __nv_bfloat16* xs = ps + STAGES * NP * C::P_TILE;

  const int b = blockIdx.x / g.nct;
  const int col0 = (blockIdx.x % g.nct) * g.tw;
  const int cols = min(g.tw, g.s - col0);      // live columns, >= 1
  const int tiles = (cols + 7) >> 3;           // live n8 tiles
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 7, cg = warp >> 3;
  const int j0 = cg * ((tiles + 1) >> 1);      // the warp's first n8 tile
  const int nn = cg == 0 ? (tiles + 1) >> 1 : tiles >> 1;
  const long long start = g.c0[b];
  const size_t pbase = (size_t)b * (size_t)g.w * CHUNK;
  const int nk = g.w / BK;
  const int s = g.s;

  // K-tile kt into ring slot `slot`, 16 bytes a copy where it can: the
  // planes' BK x 128 contiguous bf16 per plane, and the float32 x tile,
  // of which this thread copies row tid / TPR, columns (tid % TPR) * XPT
  // .. + XPT - 1: zero past n (the planes are zero there, stale values
  // could be NaN), nothing past the tile's live columns (a column only
  // reaches its own outputs, which are not stored)
  const int xr = tid / C::TPR, xc = (tid % C::TPR) * XPT;
  auto load_tile = [&](int kt, int slot) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const __nv_bfloat16* src =
          g.planes[p] + pbase + (size_t)kt * BK * CHUNK;
      __nv_bfloat16* dst = ps + (slot * NP + p) * C::P_TILE;
#pragma unroll
      for (int e = tid; e < BK * CHUNK / 8; e += THREADS) {
        const int row = e >> 4, c8 = (e & 15) * 8;
        cp_async16(dst + row * PROW + c8, src + row * CHUNK + c8);
      }
    }
    const long long row = start + (long long)kt * BK + xr;
    const bool live = row < g.n;
    const float* src = g.x + (live ? row * s + col0 + xc : 0);
    float* dst = xf + slot * C::XF_TILE + xr * NT + xc;
    if (g.vec4) {
#pragma unroll
      for (int h = 0; h < XPT; h += 4)
        if (xc + h < cols) cp_async16_zfill(dst + h, src + h, live);
    } else {
#pragma unroll
      for (int q = 0; q < XPT; ++q)
        if (xc + q < cols)
          cp_async4_zfill(dst + q, live ? src + q : g.x, live);
    }
  };

  // split this thread's live x values of ring slot `slot` into x buffer
  // `buf`: hi = bf16_rn(v), lo = bf16_rn(v - hi), x3 = bf16_rn(v - hi - lo)
  auto split_x = [&](int slot, int buf) {
    const float* xin = xf + slot * C::XF_TILE + xr * NT + xc;
    __nv_bfloat16* dst = xs + buf * NP * C::X_TILE + xr * XROW + xc;
#pragma unroll
    for (int h = 0; h < XPT; h += 8) {
      if (xc + h >= cols) break;
      float xv[8];
      *reinterpret_cast<float4*>(xv) =
          *reinterpret_cast<const float4*>(xin + h);
      *reinterpret_cast<float4*>(xv + 4) =
          *reinterpret_cast<const float4*>(xin + h + 4);
      __align__(16) __nv_bfloat162 hv[4], lv[4], tv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hv[q] = __floats2bfloat162_rn(xv[2 * q], xv[2 * q + 1]);
        const float2 hf = __bfloat1622float2(hv[q]);
        const float r0 = xv[2 * q] - hf.x, r1 = xv[2 * q + 1] - hf.y;
        lv[q] = __floats2bfloat162_rn(r0, r1);
        const float2 lf = __bfloat1622float2(lv[q]);
        tv[q] = __floats2bfloat162_rn(r0 - lf.x, r1 - lf.y);
      }
      *reinterpret_cast<uint4*>(dst + h) = *reinterpret_cast<uint4*>(hv);
      *reinterpret_cast<uint4*>(dst + C::X_TILE + h) =
          *reinterpret_cast<uint4*>(lv);
      if (NP == 3)
        *reinterpret_cast<uint4*>(dst + 2 * C::X_TILE + h) =
            *reinterpret_cast<uint4*>(tv);
    }
  };

  float acc[C::NACC][C::WT][4];
#pragma unroll
  for (int i = 0; i < C::NACC; ++i)
#pragma unroll
    for (int j = 0; j < C::WT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // ldmatrix lane roles: lane supplies row (lane & 7) of 8x8 matrix
  // lane >> 3.  A (P^T, 16 x 16): matrices (r 0-7 | 8-15) x (k 0-7 | 8-15)
  // in the order a0 a1 a2 a3; B (X, 16 x 16 = two n8 tiles): (k 0-7 |
  // 8-15) x (n 0-7 | 8-15) in the order b0 b1 of tile 0, b0 b1 of tile 1.
  const int mat = lane >> 3, lr = lane & 7;
  const int a_off = (lr + ((mat >> 1) << 3)) * PROW + rg * 16 +
                    ((mat & 1) << 3);
  const int b_off = (lr + ((mat & 1) << 3)) * XROW + ((mat >> 1) << 3) +
                    j0 * 8;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_tile(st, st);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();       // this thread's copies of tile kt
    split_x(kt % STAGES, kt & 1);      // its own x values only
    __syncthreads();                   // tile kt visible; tile kt-1 done
    {
      const int next = kt + STAGES - 1;  // into the slot tile kt-1 used
      if (next < nk) load_tile(next, next % STAGES);
      cp_async_commit();
    }

    const __nv_bfloat16* pt = ps + (kt % STAGES) * NP * C::P_TILE + a_off;
    const __nv_bfloat16* xt = xs + (kt & 1) * NP * C::X_TILE + b_off;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const __nv_bfloat16* pk = pt + kk * 16 * PROW;
      const __nv_bfloat16* xk = xt + kk * 16 * XROW;
      switch (nn) {
        WIDE_CASE(1) WIDE_CASE(2) WIDE_CASE(3) WIDE_CASE(4)
        WIDE_CASE(5) WIDE_CASE(6) WIDE_CASE(7) WIDE_CASE(8)
        WIDE_CASE(9) WIDE_CASE(10) WIDE_CASE(11) WIDE_CASE(12)
        WIDE_CASE(13) WIDE_CASE(14) WIDE_CASE(15) WIDE_CASE(16)
        default: break;
      }
    }
  }
  cp_async_wait<0>();

  // D fragment: (row lane/4, columns 2 (lane%4) + 0, 1) and row + 8
  const bool pair = (s & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row =
        (long long)b * CHUNK + rg * 16 + (lane >> 2) + half * 8;
    if (row >= g.m) continue;
    float* yr = g.y + row * s + col0 + j0 * 8;
    const int wcols = cols - j0 * 8;           // this warp's live columns
#pragma unroll
    for (int j = 0; j < C::WT; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      if (j >= nn || c >= wcols) continue;
      float v0 = acc[0][j][2 * half], v1 = acc[0][j][2 * half + 1];
      if (C::NACC == 2) {
        v0 += acc[C::NACC - 1][j][2 * half];
        v1 += acc[C::NACC - 1][j][2 * half + 1];
      }
      if (pair) {
        *reinterpret_cast<float2*>(yr + c) = make_float2(v0, v1);
      } else {
        yr[c] = v0;
        if (c + 1 < wcols) yr[c + 1] = v1;
      }
    }
  }
}

#undef WIDE_CASE

template <int NP>
int launch(const Args& g, int nb, cudaStream_t st) {
  if (g.tw > Cfg<NP>::NT) return (int)cudaErrorInvalidValue;
  const int bytes = Cfg<NP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      wide_spmm_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  wide_spmm_kernel<NP><<<(unsigned)((long long)nb * g.nct), THREADS, bytes,
                         st>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted),
// or cudaErrorInvalidValue for a window width that is not a multiple of
// the K-tile, a column tile that is not a multiple of 8 in [8, 256] (three
// passes) or [8, 128] (six), or planes that are not 16-byte aligned.  tw
// is the column tile (wide_spmm.py::wide_tiling).  p3 == nullptr selects
// three passes, else six.  Nothing is synchronised and nothing is
// allocated.
int rails_wide_spmm_f32(const int* c0, const void* p_hi, const void* p_lo,
                        const void* p3, int w, int nb, const float* x,
                        long long n, long long m, int s, int tw, float* y,
                        void* stream) {
  if (w <= 0 || w % BK != 0 || nb <= 0 || s <= 0 || tw < 8 || tw % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(p_hi) | reinterpret_cast<uintptr_t>(p_lo) |
       reinterpret_cast<uintptr_t>(p3)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args g;
  g.c0 = c0;
  g.planes[0] = static_cast<const __nv_bfloat16*>(p_hi);
  g.planes[1] = static_cast<const __nv_bfloat16*>(p_lo);
  g.planes[2] = static_cast<const __nv_bfloat16*>(p3);
  g.w = w;
  g.s = s;
  g.tw = tw;
  g.nct = (s + tw - 1) / tw;
  g.vec4 = s % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.n = n;
  g.m = m;
  g.x = x;
  g.y = y;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p3 == nullptr ? launch<2>(g, nb, st) : launch<3>(g, nb, st);
}

}  // extern "C"
