// ELL sparse-times-multivector product for Hopper (sm_90a), plain C entry
// points loaded with ctypes (rails_tpu_torch/sparse/ell_spmm.py::ell_spmm).
//
//   y[i, c] = sum_l values[i, l] * x[indices[i, l], c]   for 0 <= i < m.
//
// indices (m, L) int32 and values (m, L) are the plain EllMatrix payload,
// row-major; x is (n, s) and y is (m, s), row-major with unit column
// stride; m and n may differ.  Padding slots carry value 0 and an index
// inside [0, n), and every index was checked to lie in [0, n) on the host
// when the payload was built, so the gather needs no bounds test.
// tiles (T, 2) int32 holds, for each tile of tile_rows rows, the smallest
// and largest index of its slots (EllMatrix.tiles, computed with that
// check): the rows of x the tile reads.
//
// Replaces: the JAX package's Pallas TPU kernels
// rails_tpu/sparse/ell_spmm.py::_ell_spmm_t_impl (ell_spmm.py:344,
// pallas_call at :408), its grouped schedule _ell_spmm_t_nc_impl (:423,
// :503) and its sliced schedule _ell_spmm_t_sliced_impl (:517, :576).
// All three compute this product in a transposed (s, m) layout with s
// padded to 8: 128-row chunks, 128-aligned column windows of x DMA'd into
// VMEM, window-local indices and masked 128-lane sub-block gathers.  The
// idea that carries over is the window: a 128-row tile of a banded matrix
// reads a few hundred rows of x, and those can sit in fast memory.
//
// Bound: bytes.  The product must read indices and values once
// (L*m*(4 + itemsize)), x once (n*s*itemsize) and write y once
// (m*s*itemsize) - the TPU kernel's own CostEstimate (ell_spmm.py:412-416)
// with the int32 indices counted at 4 bytes - against 2*L*m*s flops: at
// most 2*L*s/(L*(4 + itemsize) + 2*s*itemsize) flop per byte (L = 8,
// s = 16, f32: 1.6), far below the H100's ~20 (f32) and ~10 (f64) flop
// per byte ridge.  What costs time beyond the bound is the gather: every
// x row is read once per slot that names it (L times on average), and
// from L2 that is several times the HBM traffic.
//
// Design (the plan - vector width, column tile, shared bytes for the
// window and for the slots - is chosen on the host by
// sparse/ell_spmm.py::ell_plan):
// - A 2-D grid: blockIdx.x a tile of tile_rows rows, blockIdx.y a column
//   tile of col_tile columns.  Thread t owns lane t % lanes of the column
//   tile (V adjacent columns: float4/double2/float2 where s and the
//   pointers allow, else one) and the rows t / lanes + k * (threads /
//   lanes) of the row tile.  The only divisions are those two, once per
//   thread.
// - Staged windows: when the tile's window (its rows of x) times the
//   column tile fits the window bytes the launch was given, the block
//   copies x[window, column tile] into shared memory with cp.async (V *
//   itemsize bytes a copy) and gathers from there; x then crosses L2
//   about (window / tile_rows) times instead of L times.  A tile whose
//   window does not fit (scattered couplings, HYB remainders) gathers
//   from global memory.  The choice is per block and uniform inside it.
// - Slots in shared memory: the block first copies its tile's indices
//   and values there by cp.async (16 bytes a copy where aligned), before
//   it even reads the tile's window, so that one round trip to memory
//   brings the slots and the window together.  Loaded row by row from
//   global memory instead, each of a thread's rows waited on its own
//   round trip (the slot loads were the largest part of the first
//   design's time, PERF.md section 6).  A payload whose tile slots pass
//   ell_spmm.py::SLOT_BUDGET bytes (L above 16 at f64, 24 at f32) reads
//   them from global memory.
// - Each thread issues all of a chunk of 4 slots' gathers before the
//   multiply-adds (4 rather than 8: fewer registers, and 175 -> 142 us at
//   the bench geometry, s = 16, on an H100 at 700 W; the gathers come
//   from shared memory, so a short chunk loses little to latency).
// - Sum order: one accumulator per element, acc = fma(value, x, acc) from
//   0 in slot order - what nvcc made of the first version's acc += v * x -
//   so both branches and every tile give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads per block, at most: lanes * min(THREADS / lanes, tile_rows)
constexpr int THREADS = 256;
constexpr int CHUNK = 4;       // slots whose loads are issued together

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// Copy count elements src -> dst (16-byte aligned) by cp.async: 16 bytes
// a copy where src is 16-byte aligned, the rest one element a copy.
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int PER = 16 / sizeof(E);
    const int n16 = count / PER;
    for (int q = threadIdx.x; q < n16; q += blockDim.x)
      cp_async<16>(dst + q * PER, src + q * PER);
    done = n16 * PER;
  }
  for (int q = done + threadIdx.x; q < count; q += blockDim.x)
    cp_async<sizeof(E)>(dst + q, src + q);
}

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// The products of the rows r = r_first, r_first + rstep, ... < r_end for
// one lane.  Slots from ri0/rv0 (row r's at (r - r_base) * L: the staged
// slots, or the payload with r_base = 0); x rows from the staged window
// (STAGED: xs, window starting at row w0, pitch col_tile) or from global
// memory (xg = x + column).
template <typename T, int V, bool STAGED>
__device__ __forceinline__ void rows(const int* ri0, const T* rv0,
                                     int r_base, int L,
                                     const T* __restrict__ xg,
                                     const T* xs, int w0, int col_tile,
                                     T* __restrict__ yg, int s, int r_first,
                                     int r_end, int rstep) {
  using P = Pack<T, V>;
  for (int r = r_first; r < r_end; r += rstep) {
    const int* ri = ri0 + (size_t)(r - r_base) * L;
    const T* rv = rv0 + (size_t)(r - r_base) * L;
    P acc;
#pragma unroll
    for (int e = 0; e < V; ++e) acc.v[e] = T(0);
    for (int l0 = 0; l0 < L; l0 += CHUNK) {
      int j[CHUNK];
      T v[CHUNK];
      P xv[CHUNK];
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        if (l0 + q < L) {
          j[q] = ri[l0 + q];
          v[q] = rv[l0 + q];
        }
      }
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        if (l0 + q < L) {
          if constexpr (STAGED) {
            xv[q] = load_pack<T, V>(xs + (size_t)(j[q] - w0) * col_tile);
          } else {
            xv[q] = load_pack<T, V>(xg + (size_t)j[q] * s);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        if (l0 + q < L) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc.v[e] = fma_rn(v[q], xv[q].v[e], acc.v[e]);
        }
      }
    }
    *reinterpret_cast<P*>(yg + (size_t)r * s) = acc;
  }
}

// Shared memory, in this order: the tile's indices and values (when
// slot_bytes > 0; each region 16-byte aligned), then the x window (at
// most window_bytes).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
ell_spmm_kernel(const int* __restrict__ indices,
                const T* __restrict__ values, int L,
                const T* __restrict__ x, T* __restrict__ y, int m, int s,
                const int2* __restrict__ tiles, int tile_rows, int col_tile,
                int window_bytes, int slot_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* idx_s = reinterpret_cast<int*>(smem_raw);
  T* val_s = reinterpret_cast<T*>(smem_raw + align16(tile_rows * L * 4));
  T* xs = reinterpret_cast<T*>(smem_raw + slot_bytes);
  const int lanes = col_tile / V;
  const int lane = threadIdx.x % lanes;
  const int rsub = threadIdx.x / lanes;
  const int rstep = blockDim.x / lanes;
  const int c0 = blockIdx.y * col_tile;
  const int c = c0 + lane * V;
  // s % V == 0, so a lane's V columns are all inside s or all outside
  const bool live = c < s;
  const int r0 = blockIdx.x * tile_rows;
  const int r_end = min(r0 + tile_rows, m);
  // the slots first: their copies need nothing from the tile's window
  const bool slots = slot_bytes > 0;
  if (slots) {
    stage(idx_s, indices + (size_t)r0 * L, (r_end - r0) * L);
    stage(val_s, values + (size_t)r0 * L, (r_end - r0) * L);
  }
  const int2 win = tiles[blockIdx.x];
  const int wrows = win.y - win.x + 1;
  const bool staged =
      window_bytes > 0 &&
      (long long)wrows * col_tile * (long long)sizeof(T) <= window_bytes;
  if (staged && live) {
    const T* src = x + (size_t)win.x * s + c;
    for (int rr = rsub; rr < wrows; rr += rstep) {
      cp_async<sizeof(T) * V>(xs + (size_t)rr * col_tile + lane * V,
                              src + (size_t)rr * s);
    }
  }
  if (slots || staged) {
    cp_async_wait_all();
    __syncthreads();
  }
  if (!live) return;
  const int* ri0 = slots ? idx_s : indices;
  const T* rv0 = slots ? val_s : values;
  const int r_base = slots ? r0 : 0;
  if (staged) {
    rows<T, V, true>(ri0, rv0, r_base, L, x, xs + lane * V, win.x, col_tile,
                     y + c, s, r0 + rsub, r_end, rstep);
  } else {
    rows<T, V, false>(ri0, rv0, r_base, L, x + c, xs, 0, col_tile, y + c, s,
                      r0 + rsub, r_end, rstep);
  }
}

template <typename T, int V>
int launch_v(const int* indices, const T* values, int L, const T* x, T* y,
             int m, int s, const int* tiles, int tile_rows, int col_tile,
             int window_bytes, int slot_bytes, cudaStream_t stream) {
  static int smem_set = 48 * 1024;   // the default limit needs no attribute
  const int smem = slot_bytes + window_bytes;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ell_spmm_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int lanes = col_tile / V;
  const int threads = lanes * min(THREADS / lanes, tile_rows);
  const dim3 grid((unsigned)((m + tile_rows - 1) / tile_rows),
                  (unsigned)((s + col_tile - 1) / col_tile));
  ell_spmm_kernel<T, V><<<grid, threads, smem, stream>>>(
      indices, values, L, x, y, m, s, reinterpret_cast<const int2*>(tiles),
      tile_rows, col_tile, window_bytes, slot_bytes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const int* indices, const T* values, int L, const T* x, T* y,
           long long m, int s, const int* tiles, int tile_rows, int vec,
           int col_tile, int window_bytes, int slot_bytes, void* stream) {
  if (m <= 0 || s <= 0) return 0;
  // the host plan must give a column tile of 1 to THREADS whole vectors,
  // and slot_bytes 0 or the two slot regions of a tile
  if (m > 0x7fffffffLL || tile_rows <= 0 || vec <= 0 || col_tile % vec ||
      col_tile / vec < 1 || col_tile / vec > THREADS || s % vec ||
      window_bytes < 0 ||
      (slot_bytes != 0 &&
       slot_bytes != align16(tile_rows * L * 4) +
                         align16(tile_rows * L * (int)sizeof(T))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mi = (int)m;
  if (vec == 1)
    return launch_v<T, 1>(indices, values, L, x, y, mi, s, tiles, tile_rows,
                          col_tile, window_bytes, slot_bytes, st);
  if (vec == 2)
    return launch_v<T, 2>(indices, values, L, x, y, mi, s, tiles, tile_rows,
                          col_tile, window_bytes, slot_bytes, st);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4)
      return launch_v<T, 4>(indices, values, L, x, y, mi, s, tiles,
                            tile_rows, col_tile, window_bytes, slot_bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when the launch was
// accepted (cudaErrorInvalidValue for a plan it cannot run).  Nothing is
// synchronised and nothing is allocated.
int rails_ell_spmm_f32(const int* indices, const float* values, int L,
                       const float* x, float* y, long long m, int s,
                       const int* tiles, int tile_rows, int vec,
                       int col_tile, int window_bytes, int slot_bytes,
                       void* stream) {
  return launch<float>(indices, values, L, x, y, m, s, tiles, tile_rows, vec,
                       col_tile, window_bytes, slot_bytes, stream);
}

int rails_ell_spmm_f64(const int* indices, const double* values, int L,
                       const double* x, double* y, long long m, int s,
                       const int* tiles, int tile_rows, int vec,
                       int col_tile, int window_bytes, int slot_bytes,
                       void* stream) {
  return launch<double>(indices, values, L, x, y, m, s, tiles, tile_rows,
                        vec, col_tile, window_bytes, slot_bytes, stream);
}

}  // extern "C"
