// ELL sparse-times-multivector product for Hopper (sm_90a), plain C entry
// points loaded with ctypes (rails_tpu_torch/sparse/ell_spmm.py::ell_spmm).
//
//   y[i, c] = sum_l values[i, l] * x[indices[i, l], c]   for 0 <= i < m.
//
// indices (m, L) int32 and values (m, L) are the plain EllMatrix payload,
// row-major; x is (n, s) and y is (m, s), row-major and contiguous; m and n
// may differ.  Padding slots carry value 0 and an index inside [0, n), and
// every index was checked to lie in [0, n) on the host when the payload
// was built, so the gather needs no bounds test.
//
// Replaces: the JAX package's Pallas TPU kernels
// rails_tpu/sparse/ell_spmm.py::_ell_spmm_t_impl (ell_spmm.py:344,
// pallas_call at :408), its grouped schedule _ell_spmm_t_nc_impl (:423,
// :503) and its sliced schedule _ell_spmm_t_sliced_impl (:517, :576).
// All three compute this product in a transposed (s, m) layout with s
// padded to 8: 128-row chunks, 128-aligned column windows of x DMA'd into
// VMEM, window-local indices and masked 128-lane sub-block gathers - the
// only gather shape the TPU compiles.  None of that is needed on a card
// whose threads gather from global memory directly: this kernel reads the
// solver's (m, s) layout and the plain indices/values.
//
// Bound: bytes.  The product must read indices and values once
// (L*m*(4 + itemsize)), x once (n*s*itemsize) and write y once
// (m*s*itemsize) - the TPU kernel's own CostEstimate (ell_spmm.py:412-416)
// with the int32 indices counted at 4 bytes - against 2*L*m*s flops: at
// most 2*L*s/(L*(4 + itemsize) + 2*s*itemsize) flop per byte (L = 8,
// s = 16, f32: 1.6), far below the H100's ~20 (f32) and ~10 (f64) flop
// per byte ridge.
//
// Design: one thread per output element (i, c), neighbouring threads on
// neighbouring c and then i - the DIA kernel's layout.  A warp's gathers
// from one x row x[indices[i, l], :] and its store of y are then
// coalesced, and the threads of one row share their index and value loads
// (a broadcast).  Reuse of x rows between the rows of one block is left
// to the L1 and 50 MB L2 caches rather than staged in shared memory.  The
// accumulator has the input's type and sums the slots in order, as the
// plain version does.  A grid-stride loop covers any m * s.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
ell_spmm_kernel(const int* __restrict__ indices,
                const T* __restrict__ values, int L,
                const T* __restrict__ x, T* __restrict__ y, long long m,
                int s) {
  const long long total = m * (long long)s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long i = idx / s;
    const long long c = idx - i * s;
    const int* row_idx = indices + i * L;
    const T* row_val = values + i * L;
    T acc = T(0);
    for (int l = 0; l < L; ++l) {
      const long long j = (long long)__ldg(row_idx + l);
      acc += __ldg(row_val + l) * __ldg(x + j * s + c);
    }
    y[idx] = acc;
  }
}

template <typename T>
int launch(const int* indices, const T* values, int L, const T* x, T* y,
           long long m, int s, void* stream) {
  const long long total = m * (long long)s;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the grid-stride loop
  // covers the rest
  const long long max_blocks = 132LL * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  ell_spmm_kernel<T><<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      indices, values, L, x, y, m, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when the launch was
// accepted.  Nothing is synchronised and nothing is allocated.
int rails_ell_spmm_f32(const int* indices, const float* values, int L,
                       const float* x, float* y, long long m, int s,
                       void* stream) {
  return launch<float>(indices, values, L, x, y, m, s, stream);
}

int rails_ell_spmm_f64(const int* indices, const double* values, int L,
                       const double* x, double* y, long long m, int s,
                       void* stream) {
  return launch<double>(indices, values, L, x, y, m, s, stream);
}

}  // extern "C"
