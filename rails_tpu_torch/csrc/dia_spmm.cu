// DIA sparse-times-multivector product for Hopper (sm_90a), plain C entry
// points loaded with ctypes (rails_tpu_torch/sparse/spmm.py::dia_spmm).
//
//   y[i, c] = sum_k data[k, i] * x[i + offsets[k], c]   for 0 <= i < m,
//
// terms with i + offsets[k] outside [0, n) are dropped.  data is (d, m),
// x is (n, s) and y is (m, s), all row-major and contiguous; offsets is
// (d,) int32 on the device.
//
// Replaces: the JAX package's Pallas TPU kernel
// rails_tpu/sparse/spmm.py::_dia_spmm_t_impl (spmm.py:75, pallas_call at
// :202).  That kernel works in a transposed (s, m) layout with s padded
// to 8, double-buffers 128-aligned row-block windows of x in VMEM and
// patches a remainder strip in XLA - all of it to suit the TPU's vector
// layout.  None of it is needed here: this kernel reads the solver's own
// (m, s) layout and the plain DiaMatrix payload.
//
// Bound: bytes.  The product must read data once (d*m), x once (n*s) and
// write y once (m*s): (d*m + n*s + m*s) * itemsize bytes - the TPU
// kernel's own CostEstimate (spmm.py:200-201) - against 2*d*m*s flops,
// i.e. at most d/4 flop per byte at f64 (d = 5: 1.25), far below the
// H100's ~10 (f64) and ~20 (f32) flop per byte ridge.
//
// Design: one thread per output element (i, c), with neighbouring threads
// on neighbouring c and then i, so that a warp's loads of x and its store
// of y touch consecutive addresses (coalesced), and the threads of one row
// share their data[k, i] load (a broadcast).  Each thread loops over the
// d diagonals with a bounds test.  A stencil's diagonals touch x rows
// i + offsets[k] that neighbouring blocks also read, and that reuse is
// left to the 50 MB L2 cache rather than staged in shared memory: x is
// read from device memory about once when the rows one block touches fit
// in L2 (they do for any solver shape: a row of x is s * itemsize bytes).
// The accumulator has the input's type: float for float, double for
// double.  A grid-stride loop covers any m * s.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
dia_spmm_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
                int d, const T* __restrict__ x, T* __restrict__ y,
                long long m, long long n, int s) {
  const long long total = m * (long long)s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / s;
    const long long c = idx - i * s;
    T acc = T(0);
    for (int k = 0; k < d; ++k) {
      const long long j = i + (long long)__ldg(offsets + k);
      if (j >= 0 && j < n) {
        acc += __ldg(data + (long long)k * m + i) * __ldg(x + j * s + c);
      }
    }
    y[idx] = acc;
  }
}

template <typename T>
int launch(const T* data, const int* offsets, int d, const T* x, T* y,
           long long m, long long n, int s, void* stream) {
  const long long total = m * (long long)s;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest
  const long long max_blocks = 132LL * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  dia_spmm_kernel<T><<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      data, offsets, d, x, y, m, n, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when the launch was
// accepted.  Nothing is synchronised and nothing is allocated.
int rails_dia_spmm_f32(const float* data, const int* offsets, int d,
                       const float* x, float* y, long long m, long long n,
                       int s, void* stream) {
  return launch<float>(data, offsets, d, x, y, m, n, s, stream);
}

int rails_dia_spmm_f64(const double* data, const int* offsets, int d,
                       const double* x, double* y, long long m, long long n,
                       int s, void* stream) {
  return launch<double>(data, offsets, d, x, y, m, n, s, stream);
}

}  // extern "C"
