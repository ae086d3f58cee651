// Dense-window SpMM for wide multivectors on Hopper (sm_90a), plain C
// entry point loaded with ctypes (rails_tpu_torch/sparse/wide_spmm.py::
// wide_spmm).
//
// For every 128-row chunk b with window start c0[b] and every row
// i = 128 b + r < m and column j < s:
//
//   y[i, j] = sum_{c < w} sum_pass P_pass[b][c, r] * X_pass[c0[b] + c, j]
//
// P planes p_hi, p_lo (and p3 for six passes) are bfloat16, laid out
// (nb, w, 128): one contiguous (w, 128) block per chunk.  x (n, s) and
// y (m, s) are float32, row-major and contiguous.  x is split as it is
// loaded: X_hi = bf16_rn(x), X_lo = bf16_rn(x - X_hi), X_3 = bf16_rn(x -
// X_hi - X_lo).  Three passes: xh*Ph + xh*Pl + xl*Ph; six add xl*Pl,
// xh*P3, x3*Ph.  A bf16 x bf16 product is exact in float32, so only the
// order of the float32 sums differs from the TPU kernel and the plain
// version.  Window rows c0[b] + c >= n read as zero: x is neither read
// past its end nor padded.
//
// Replaces: the JAX package's Pallas TPU kernel
// rails_tpu/sparse/wide_spmm.py::_wide_spmm_t_impl (wide_spmm.py:136,
// pallas_call at :199), which puts the same product on the TPU's matrix
// unit to escape the gather issue rate of the ELL kernel there.  That
// reason does not exist on Hopper, where threads gather from global
// memory directly; this kernel computes the same function for the
// payload's opt-in callers.
//
// Bound: the TPU CostEstimate (wide_spmm.py:203-207): the planes read once
// (planes * w * m_pad * 2 bytes), x read and y written once
// (2 * m_pad * s * 4 bytes), passes * 2 * w * 128 * s flops per chunk.
// At the continuation shape (m = 16384, w = 384, s = 200, 3 passes) that
// is 51 MB and 7.5 GFLOP: bound by bytes at 3.35 TB/s (15 us) against the
// bf16 tensor-core peak, but by operations (112 us) on the CUDA cores
// this kernel uses.
//
// Design: a simple kernel that is right.  One block of 256 threads per
// (chunk, 64-column tile of s); the window is walked in tiles of 16 rows.
// Each tile stages the planes' 16 x 128 block and the x tile's hi/lo(/x3)
// splits in shared memory as float32 (36 KB at six passes, under the
// 48 KB static limit), and each thread accumulates an 8-row x 4-column
// piece of the output in float32 registers on the CUDA cores, one fused
// multiply-add per pass term.  Tensor cores (mma/wgmma on the bf16
// planes) and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;      // output rows per block (the TPU chunk)
constexpr int TS = 64;          // output columns per block
constexpr int KT = 16;          // window rows per shared-memory tile
constexpr int RM = 8;           // rows per thread
constexpr int CN = 4;           // columns per thread
constexpr int THREADS = (CHUNK / RM) * (TS / CN);  // 256

template <bool SIX>
__global__ void __launch_bounds__(THREADS)
wide_spmm_kernel(const int* __restrict__ c0,
                 const __nv_bfloat16* __restrict__ p_hi,
                 const __nv_bfloat16* __restrict__ p_lo,
                 const __nv_bfloat16* __restrict__ p3, int w,
                 const float* __restrict__ x, long long n, long long m,
                 int s, float* __restrict__ y) {
  constexpr int NP = SIX ? 3 : 2;
  __shared__ __align__(16) float ps[NP][KT][CHUNK];
  __shared__ __align__(16) float xs[NP][KT][TS];

  const int b = blockIdx.x;
  const int col0 = blockIdx.y * TS;
  const int tid = threadIdx.x;
  const int ty = tid / (TS / CN);   // row group: rows ty*RM .. +RM-1
  const int tx = tid % (TS / CN);   // column group: tx*CN .. +CN-1
  const long long start = c0[b];
  const size_t pbase = (size_t)b * (size_t)w * CHUNK;

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < w; k0 += KT) {
    // the planes' KT x 128 block: contiguous in each plane
    for (int e = tid; e < KT * CHUNK; e += THREADS) {
      const size_t g = pbase + (size_t)k0 * CHUNK + e;
      const int kk = e / CHUNK, r = e % CHUNK;
      ps[0][kk][r] = __bfloat162float(p_hi[g]);
      ps[1][kk][r] = __bfloat162float(p_lo[g]);
      if (SIX) ps[NP - 1][kk][r] = __bfloat162float(p3[g]);
    }
    // the x tile, split to bf16 hi/lo(/x3) as it is loaded; rows past n
    // and columns past s read as zero
    for (int e = tid; e < KT * TS; e += THREADS) {
      const int kk = e / TS, j = e % TS;
      const long long row = start + k0 + kk;
      const int col = col0 + j;
      const float v = (row < n && col < s) ? __ldg(x + row * s + col) : 0.f;
      const float h = __bfloat162float(__float2bfloat16_rn(v));
      const float rr = v - h;
      const float l = __bfloat162float(__float2bfloat16_rn(rr));
      xs[0][kk][j] = h;
      xs[1][kk][j] = l;
      if (SIX) xs[NP - 1][kk][j] = __bfloat162float(__float2bfloat16_rn(rr - l));
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float ph[RM], pl[RM], pt[RM], xh[CN], xl[CN], xt[CN];
#pragma unroll
      for (int i = 0; i < RM; i += 4) {
        *reinterpret_cast<float4*>(ph + i) =
            *reinterpret_cast<const float4*>(&ps[0][kk][ty * RM + i]);
        *reinterpret_cast<float4*>(pl + i) =
            *reinterpret_cast<const float4*>(&ps[1][kk][ty * RM + i]);
        if (SIX)
          *reinterpret_cast<float4*>(pt + i) =
              *reinterpret_cast<const float4*>(&ps[NP - 1][kk][ty * RM + i]);
      }
      *reinterpret_cast<float4*>(xh) =
          *reinterpret_cast<const float4*>(&xs[0][kk][tx * CN]);
      *reinterpret_cast<float4*>(xl) =
          *reinterpret_cast<const float4*>(&xs[1][kk][tx * CN]);
      if (SIX)
        *reinterpret_cast<float4*>(xt) =
            *reinterpret_cast<const float4*>(&xs[NP - 1][kk][tx * CN]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float a = acc[i][j];
          a = fmaf(ph[i], xh[j], a);
          a = fmaf(pl[i], xh[j], a);
          a = fmaf(ph[i], xl[j], a);
          if (SIX) {
            a = fmaf(pl[i], xl[j], a);
            a = fmaf(pt[i], xh[j], a);
            a = fmaf(ph[i], xt[j], a);
          }
          acc[i][j] = a;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long row = (long long)b * CHUNK + ty * RM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int col = col0 + tx * CN + j;
      if (col < s) y[row * s + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted),
// or cudaErrorInvalidValue for a window width that is not a multiple of
// the tile.  p3 == nullptr selects three passes, else six.  Nothing is
// synchronised and nothing is allocated.
int rails_wide_spmm_f32(const int* c0, const void* p_hi, const void* p_lo,
                        const void* p3, int w, int nb, const float* x,
                        long long n, long long m, int s, float* y,
                        void* stream) {
  if (w <= 0 || w % KT != 0 || nb <= 0 || s <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb, (unsigned)((s + TS - 1) / TS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* hi = static_cast<const __nv_bfloat16*>(p_hi);
  const auto* lo = static_cast<const __nv_bfloat16*>(p_lo);
  const auto* p3b = static_cast<const __nv_bfloat16*>(p3);
  if (p3 == nullptr)
    wide_spmm_kernel<false><<<grid, THREADS, 0, st>>>(c0, hi, lo, nullptr, w,
                                                      x, n, m, s, y);
  else
    wide_spmm_kernel<true><<<grid, THREADS, 0, st>>>(c0, hi, lo, p3b, w, x,
                                                     n, m, s, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
