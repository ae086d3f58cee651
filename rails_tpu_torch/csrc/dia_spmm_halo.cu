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
// (m, s), all row-major and contiguous; offsets is (d,) int32 on the
// device.  An empty halo (span 0) is a null pointer.  A boundary shard
// passes a zero-filled halo: the Dirichlet padding of the unsharded
// product.
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
// below the H100's ~10 (f64) and ~20 (f32) flop per byte ridge.
//
// Design: kernel #1's (csrc/dia_spmm.cu): one thread per output element
// (i, c), neighbouring threads on neighbouring c and then i, so that a
// warp's loads of x and its store of y are coalesced and the threads of
// one row share their data[k, i] load.  A row whose every term lies in
// the shard's own rows (all rows but the first -min(offsets) and the last
// max(offsets)) reads x alone, with no test per term; an edge row picks
// each term's source - the lower halo, the shard's rows or the upper
// halo - by the row it needs.  The choice is per row, so it is uniform
// across a warp but for the few warps at a shard edge (without it the
// per-term three-way choice ran 34% slower than kernel #1 on the bench
// geometry, an H100 at 700 W).  The diagonals are summed in
// offset order with the same acc += data * x as kernel #1, so an apply
// over shards gives the unsharded apply's sums term by term (a boundary
// halo's zeros add exact zeros).  A grid-stride loop covers any m * s.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
dia_spmm_halo_kernel(const T* __restrict__ data,
                     const int* __restrict__ offsets, int d,
                     const T* __restrict__ x, const T* __restrict__ hl,
                     const T* __restrict__ hh, T* __restrict__ y,
                     long long m, long long span_lo, long long span_hi,
                     int s) {
  const long long total = m * (long long)s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the rows [-omin, m - omax) need no halo; computed from the offsets
  // themselves, so the fast path never reads outside x
  long long omin = 0, omax = 0;
  for (int k = 0; k < d; ++k) {
    const long long o = (long long)__ldg(offsets + k);
    omin = o < omin ? o : omin;
    omax = o > omax ? o : omax;
  }
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / s;
    const long long c = idx - i * s;
    T acc = T(0);
    if (i + omin >= 0 && i + omax < m) {
      for (int k = 0; k < d; ++k) {
        const long long j = i + (long long)__ldg(offsets + k);
        acc += __ldg(data + (long long)k * m + i) * __ldg(x + j * s + c);
      }
      y[idx] = acc;
      continue;
    }
    for (int k = 0; k < d; ++k) {
      const long long j = i + (long long)__ldg(offsets + k);
      const T* src;
      if (j < 0) {
        if (j < -span_lo) continue;
        src = hl + (span_lo + j) * s;
      } else if (j < m) {
        src = x + j * s;
      } else {
        if (j >= m + span_hi) continue;
        src = hh + (j - m) * s;
      }
      acc += __ldg(data + (long long)k * m + i) * __ldg(src + c);
    }
    y[idx] = acc;
  }
}

template <typename T>
int launch(const T* data, const int* offsets, int d, const T* x, const T* hl,
           const T* hh, T* y, long long m, long long span_lo,
           long long span_hi, int s, void* stream) {
  const long long total = m * (long long)s;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest
  const long long max_blocks = 132LL * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  dia_spmm_halo_kernel<T><<<(unsigned)blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      data, offsets, d, x, hl, hh, y, m, span_lo, span_hi, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when the launch was
// accepted.  Nothing is synchronised and nothing is allocated.
int rails_dia_spmm_halo_f32(const float* data, const int* offsets, int d,
                            const float* x, const float* hl, const float* hh,
                            float* y, long long m, long long span_lo,
                            long long span_hi, int s, void* stream) {
  return launch<float>(data, offsets, d, x, hl, hh, y, m, span_lo, span_hi,
                       s, stream);
}

int rails_dia_spmm_halo_f64(const double* data, const int* offsets, int d,
                            const double* x, const double* hl,
                            const double* hh, double* y, long long m,
                            long long span_lo, long long span_hi, int s,
                            void* stream) {
  return launch<double>(data, offsets, d, x, hl, hh, y, m, span_lo, span_hi,
                        s, stream);
}

}  // extern "C"
