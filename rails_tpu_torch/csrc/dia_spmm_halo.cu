// Shard-local DIA sparse-times-multivector product with explicit halo rows,
// for Hopper (sm_90a); plain C entry points loaded with ctypes
// (rails_tpu_torch/sparse/spmm.py::dia_spmm_halo).
//
//   y[i, c] = sum_k data[k, i] * xe(i + offsets[k], c)   for 0 <= i < m,
//
//   xe(j) = x[j]               for 0 <= j < m
//         = hl[span_lo + j]    for -span_lo <= j < 0
//         = hh[j - m]          for m <= j < m + span_hi
//
// and terms with j outside [-span_lo, m + span_hi) are dropped.  data is
// (d, m), x is the shard's own rows (m, s), hl the span_lo rows below the
// shard (span_lo, s), hh the span_hi rows above it (span_hi, s) and y is
// (m, s), all row-major and contiguous.  An empty halo (span 0) is a null
// pointer.  A boundary shard passes a zero-filled halo: the Dirichlet
// padding of the unsharded product.  The offsets come by value (an
// OffsetPack of up to kCap diagonals, with their extremes, built on the
// host from the tuple the caller holds) or, for more diagonals or a
// caller that holds only the device copy, as a (d,) int32 device array
// that each block reads once into shared memory.
//
// Replaces: the JAX package's Pallas TPU kernel
// rails_tpu/sparse/spmm.py::_dia_spmm_t_halo_impl (spmm.py:414,
// pallas_call at :501).  That kernel works in a transposed (s, m) layout
// with s padded to 8, rounds both halos up to 128 columns, and
// double-buffers 128-aligned row-block windows of x in VMEM, DMAing the
// halos into the first and last block's windows; its block size must
// divide the shard and fit a VMEM budget (spmm.py:525-542).  All of that
// suits the TPU's vector layout and none of it is needed here: this
// kernel reads the solver's (m, s) layout, the unpadded halos and the
// plain DiaMatrix payload, at any m and s, in float32 and float64.
//
// Bound: bytes.  The product must read data once (d*m), x once (m*s), the
// halos once ((span_lo + span_hi)*s) and write y once (m*s), against
// 2*d*m*s flops: at most d/4 flop per byte at f64 (d = 5: 1.25), far
// below the H100's ~10 (f64) and ~20 (f32) flop per byte ridge.  At the
// mesh solve's shard (m = 16,384, s = 8, f64) that is under a
// microsecond, so the launch and one round trip to memory set its time.
//
// Design:
// - The offsets are kernel arguments, so the first loads a thread issues
//   are its data and x loads: no round trip for the offsets (or for their
//   extremes) ahead of them.
// - 2-D indexing: thread t owns lane t % lanes (V adjacent columns:
//   float4/double2/float2 where s and every pointer allow, else one) of
//   row blockIdx.x * (threads / lanes) + t / lanes, in column tile
//   blockIdx.y.  Those are the only divisions, once per thread.
// - All of a chunk of 8 terms' data and x loads are issued before their
//   multiply-adds.
// - A row whose every term lies in the shard's own rows (all rows but the
//   first -min(offsets) and the last max(offsets)) reads x alone, with no
//   test per term; an edge row picks each term's source - the lower halo,
//   the shard's rows or the upper halo - by the row it needs.  The choice
//   is per row, so it is uniform across a warp but for the few warps at a
//   shard edge.
// - Sum order: per element, the terms in offset order as
//   acc = fma(data, x, acc) from 0, which is what nvcc makes of kernel
//   #1's acc += data * x (csrc/dia_spmm.cu).  An apply over shards thus
//   gives the unsharded apply's sums term by term (a boundary halo's zeros
//   add exact zeros): bit-equal to kernel #1.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kCap = 16;       // diagonals passed by value

// Outside the anonymous namespace: the C entry points take a pointer to
// it, and a type with internal linkage would hide them from the library's
// exports.  Mirrored by sparse/spmm.py::_OffsetPack.
struct RailsHaloOffsets {
  int d;
  int omin;                    // min(0, offsets)
  int omax;                    // max(0, offsets)
  int off[kCap];
};

namespace {

using OffsetPack = RailsHaloOffsets;

constexpr int THREADS = 256;   // at most; lanes * (THREADS / lanes) used
constexpr int CHUNK = 8;       // terms whose loads are issued together

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// y row i, one lane (x, hl, hh, y already offset to the lane's column).
// BYVAL: the offsets are pk.off (the loop is unrolled to kCap, so every
// index into the argument is a constant); else offs (shared memory).
// INTERIOR: every term lies in x.
template <typename T, int V, bool BYVAL, bool INTERIOR>
__device__ __forceinline__ void row(const T* __restrict__ data,
                                    const OffsetPack& pk, const int* offs,
                                    int d, const T* __restrict__ x,
                                    const T* __restrict__ hl,
                                    const T* __restrict__ hh,
                                    T* __restrict__ y, int m, int span_lo,
                                    int span_hi, int s, int i) {
  using P = Pack<T, V>;
  P acc;
#pragma unroll
  for (int e = 0; e < V; ++e) acc.v[e] = T(0);
  const int dloop = BYVAL ? kCap : d;
#pragma unroll
  for (int k0 = 0; k0 < dloop; k0 += CHUNK) {
    T dv[CHUNK];
    P xv[CHUNK];
    bool ok[CHUNK];
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      const int k = k0 + q;
      ok[q] = k < d;
      if (ok[q]) {
        int o;
        if constexpr (BYVAL) {
          o = pk.off[k];
        } else {
          o = offs[k];
        }
        const int j = i + o;
        const T* src;
        if (INTERIOR) {
          src = x + (size_t)j * s;
        } else if (j < 0) {
          ok[q] = j >= -span_lo;
          src = hl + (ptrdiff_t)(span_lo + j) * s;
        } else if (j < m) {
          src = x + (size_t)j * s;
        } else {
          ok[q] = j < m + span_hi;
          src = hh + (ptrdiff_t)(j - m) * s;
        }
        if (ok[q]) {
          dv[q] = __ldg(data + (size_t)k * m + i);
          xv[q] = load_pack<T, V>(src);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      if (ok[q]) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc.v[e] = fma_rn(dv[q], xv[q].v[e], acc.v[e]);
      }
    }
  }
  *reinterpret_cast<P*>(y + (size_t)i * s) = acc;
}

// Float32 blocks are held to 64 registers so that four share an SM: at
// the bench shard (s = 16) that took 53.3 -> 39.7 us, while float64 at
// the mesh solve's shard (one wave of blocks) went 3.17 -> 3.40 us under
// the same cap (an H100 at 700 W), so float64 keeps the compiler's
// choice.
template <typename T, int V, bool BYVAL>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 4 : 1)
dia_spmm_halo_kernel(const T* __restrict__ data, OffsetPack pk,
                     const int* __restrict__ offsets, int d,
                     const T* __restrict__ x, const T* __restrict__ hl,
                     const T* __restrict__ hh, T* __restrict__ y, int m,
                     int span_lo, int span_hi, int s, int lanes) {
  extern __shared__ int offs[];
  int omin = pk.omin, omax = pk.omax;
  if (!BYVAL) {
    for (int k = threadIdx.x; k < d; k += blockDim.x) offs[k] = offsets[k];
    __syncthreads();
    omin = 0;
    omax = 0;
    for (int k = 0; k < d; ++k) {
      omin = min(omin, offs[k]);
      omax = max(omax, offs[k]);
    }
  }
  const int lane = threadIdx.x % lanes;
  const int rows_per_block = blockDim.x / lanes;
  const int i = blockIdx.x * rows_per_block + threadIdx.x / lanes;
  const int c = (blockIdx.y * lanes + lane) * V;
  if (i >= m || c >= s) return;   // s % V == 0: a lane is whole or out
  const T* xl = x + c;
  const T* hll = hl == nullptr ? hl : hl + c;
  const T* hhl = hh == nullptr ? hh : hh + c;
  T* yl = y + c;
  if (i + omin >= 0 && i + omax < m) {
    row<T, V, BYVAL, true>(data, pk, offs, d, xl, hll, hhl, yl, m, span_lo,
                           span_hi, s, i);
  } else {
    row<T, V, BYVAL, false>(data, pk, offs, d, xl, hll, hhl, yl, m, span_lo,
                            span_hi, s, i);
  }
}

template <typename T, int V, bool BYVAL>
int launch_v(const T* data, const OffsetPack& pk, const int* offsets, int d,
             const T* x, const T* hl, const T* hh, T* y, int m, int span_lo,
             int span_hi, int s, int lanes, cudaStream_t stream) {
  const int rows_per_block = THREADS / lanes;
  const int threads = lanes * rows_per_block;
  const int col_tile = lanes * V;
  const dim3 grid((unsigned)((m + rows_per_block - 1) / rows_per_block),
                  (unsigned)((s + col_tile - 1) / col_tile));
  const size_t smem = BYVAL ? 0 : (size_t)d * sizeof(int);
  dia_spmm_halo_kernel<T, V, BYVAL><<<grid, threads, smem, stream>>>(
      data, pk, offsets, d, x, hl, hh, y, m, span_lo, span_hi, s, lanes);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_pack(const T* data, const OffsetPack* pk, const int* offsets,
                int d, const T* x, const T* hl, const T* hh, T* y, int m,
                int span_lo, int span_hi, int s, int lanes,
                cudaStream_t stream) {
  if (pk != nullptr)
    return launch_v<T, V, true>(data, *pk, offsets, d, x, hl, hh, y, m,
                                span_lo, span_hi, s, lanes, stream);
  const OffsetPack none{};
  return launch_v<T, V, false>(data, none, offsets, d, x, hl, hh, y, m,
                               span_lo, span_hi, s, lanes, stream);
}

template <typename T>
int launch(const T* data, const OffsetPack* pk, const int* offsets, int d,
           const T* x, const T* hl, const T* hh, T* y, long long m,
           long long span_lo, long long span_hi, int s, int vec, int lanes,
           void* stream) {
  if (m <= 0 || s <= 0) return 0;
  if (m > 0x3fffffffLL || span_lo < 0 || span_lo > 0x3fffffffLL ||
      span_hi < 0 || span_hi > 0x3fffffffLL || vec <= 0 ||
      s % vec || lanes < 1 || lanes > THREADS ||
      (pk != nullptr && (pk->d != d || d > kCap)) ||
      (pk == nullptr && offsets == nullptr && d > 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mi = (int)m, lo = (int)span_lo, hi = (int)span_hi;
  if (vec == 1)
    return launch_pack<T, 1>(data, pk, offsets, d, x, hl, hh, y, mi, lo, hi,
                             s, lanes, st);
  if (vec == 2)
    return launch_pack<T, 2>(data, pk, offsets, d, x, hl, hh, y, mi, lo, hi,
                             s, lanes, st);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4)
      return launch_pack<T, 4>(data, pk, offsets, d, x, hl, hh, y, mi, lo,
                               hi, s, lanes, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when the launch was
// accepted (cudaErrorInvalidValue for arguments it cannot run).  pk: the
// offsets by value, or null to read the (d,) device array ``offsets``.
// vec: columns per lane (s % vec == 0, every pointer vec-aligned); lanes:
// lanes per column tile.  Nothing is synchronised and nothing is
// allocated.
int rails_dia_spmm_halo_f32(const float* data, const RailsHaloOffsets* pk,
                            const int* offsets, int d, const float* x,
                            const float* hl, const float* hh, float* y,
                            long long m, long long span_lo,
                            long long span_hi, int s, int vec, int lanes,
                            void* stream) {
  return launch<float>(data, pk, offsets, d, x, hl, hh, y, m, span_lo,
                       span_hi, s, vec, lanes, stream);
}

int rails_dia_spmm_halo_f64(const double* data,
                            const RailsHaloOffsets* pk,
                            const int* offsets, int d, const double* x,
                            const double* hl, const double* hh, double* y,
                            long long m, long long span_lo,
                            long long span_hi, int s, int vec, int lanes,
                            void* stream) {
  return launch<double>(data, pk, offsets, d, x, hl, hh, y, m, span_lo,
                        span_hi, s, vec, lanes, stream);
}

}  // extern "C"
