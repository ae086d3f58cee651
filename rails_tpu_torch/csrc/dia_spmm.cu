// DIA sparse-times-multivector product for Hopper (sm_90a), plain C entry
// points loaded with ctypes (rails_tpu_torch/sparse/spmm.py::dia_spmm).
//
//   y[i, c] = sum_k data[k, i] * x[i + offsets[k], c]   for 0 <= i < m,
//
// terms with i + offsets[k] outside [0, n) are dropped.  data is (d, m),
// x is (n, s) and y is (m, s), all row-major and contiguous; m and n may
// differ.  The launch's plan (RailsDiaPlan) is made on the host by
// sparse/spmm.py::dia_plan from the offsets tuple the payload holds: it
// carries up to kCap offsets by value, the branch, the tile and the
// shared-memory layout.  More than kCap diagonals come as a (d,) int32
// device array, read once per block.
//
// Replaces: the JAX package's Pallas TPU kernel
// rails_tpu/sparse/spmm.py::_dia_spmm_t_impl (spmm.py:75, pallas_call at
// :202), and with it the same product's other TPU schedule
// _dia_spmm_t_impl_v3 (:229, :332).  The TPU kernel works in a transposed
// (s, m) layout with s padded to 8 and double-buffers 128-aligned
// row-block windows of x in VMEM by async copies.  The idea that carries
// over is the staged window; the layout does not: this kernel reads the
// solver's (m, s) layout and the plain DiaMatrix payload.
//
// Bound: bytes.  The product must read data once (d*m), x once (n*s) and
// write y once (m*s), against 2*d*m*s flops: at most d/4 flop per byte
// at f64 (d = 5: 1.25), far below the H100's ~10 (f64) and ~20 (f32)
// flop per byte ridge.  At the solve's shape (m = 65,536, s = 8, f64:
// 11 MB, 3.3 us) the launch and one round trip to memory weigh as much
// as the bytes.
//
// Two branches, chosen by the plan (never by a failure):
//
// Staged (the plan's ``staged``):
// - Persistent blocks: block b walks the tiles b, b + grid, ... of R rows.
// - Warp 0 produces, the other warps consume.  Per tile, warp 0 copies
//   into one stage of a ring in shared memory, one piece per lane (each
//   lane's piece is set up once per block), with TMA bulk copies
//   (cp.async.bulk ... mbarrier::complete_tx::bytes) that signal the
//   stage's mbarrier: each data row data[k, i0:i0+R] and each x segment
//   - the rows [i0 + lo, i0 + hi) of one group of offsets whose windows
//   overlap, one contiguous range of x since rows of x are contiguous -
//   clamped to [0, n).
// - The 16-byte rule: each piece's start is rounded down and its end up
//   to 16 bytes (the slot has room for it), the end never past the last
//   16-byte boundary inside the array; the ragged tail under 16 bytes is
//   copied with ordinary loads by the same lane before it arrives on the
//   mbarrier, whose release publishes it with the copies.  Each term's
//   position in the stage (a per-stage table the lanes write) indexes
//   from the rounded start.
// - Every copy of the block's first two tiles is issued before any wait;
//   after that, warp 0 refills a stage as soon as each consumer warp has
//   arrived on the stage's "empty" mbarrier, so the copies of the next
//   tiles fly while the consumers compute and store y.  No
//   __syncthreads in the tile loop.
// - Arithmetic from shared memory: consumer thread t owns lane t % lanes (V
//   adjacent columns: float4/double2/float2 where s and the pointers
//   allow, else one) of rows t / lanes + k * (threads / lanes) of the
//   tile; y is stored with vector stores.  A tile whose rows and x rows
//   all lie inside [0, m) and [0, n) takes no test per term; an edge tile
//   tests each term, as kernel #3 does per row.
//
// Direct (more than kCap diagonals, a pointer not 16-byte aligned, a row
// wider than a block, a stage too large for shared memory, or too few
// tiles per persistent block for the ring to overlap anything): kernel
// #3's design without halos - offsets by value, 2-D (row, lane)
// indexing, all of a chunk of terms' loads issued before their
// multiply-adds, and interior rows without tests.
//
// Where the staged branch's time goes at a launch of few tiles per block
// (kernel_ablation --dia's clock64 stamps in one block, the solve's
// shape, 2 tiles per block, an H100 at 700 W): warp 0's first tile is
// issued ~2,800 cycles after the barriers are set up (cold constant and
// instruction caches on the plan's arrays), its data lands ~3,000
// cycles later, and the first tile's arithmetic takes ~5,600 cycles
// against ~2,000 for the second.  That chain is serial; the direct
// branch overlaps the same latencies across its many blocks.  With many
// tiles per block (the JAX bench's shape: 70) the ring hides them and
// the staged branch is the faster.
//
// Sum order, both branches: per element, acc = fma(data, x, acc) from 0
// over the terms in offset order, dropped terms skipped, with explicit
// __fma_rn/__fmaf_rn.  Both branches give the same bits, and kernel #3
// (csrc/dia_spmm_halo.cu) gives them too on a row shard.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kCap = 16;       // diagonals passed by value

// Outside the anonymous namespace: the C entry points take a pointer to
// it.  Mirrored by sparse/spmm.py::_PlanPack.
struct RailsDiaPlan {
  int staged;        // 1: the staged branch, 0: the direct one
  int byval;         // the offsets are off[0:d]
  int d;
  int omin, omax;    // min and max of the offsets (0 for d = 0)
  int vec;           // columns per lane
  int lanes;         // lanes per column tile (staged: s / vec)
  int rows;          // staged: R, rows per tile
  int stages;        // staged: 1 or 2
  int grid;          // staged: persistent blocks
  int stage_bytes;   // staged: bytes of one stage (a multiple of 16)
  int plane_bytes;   // staged: slot of one data row
  int nseg;          // staged: x segments per tile
  int off[kCap];
  int seg_lo[kCap], seg_hi[kCap];   // segment g: rows [i0 + lo, i0 + hi)
  int seg_slot[kCap];               // its byte offset in the stage
  int term_lo[kCap], term_slot[kCap];  // term k: its segment's lo, slot
};

namespace {

using Plan = RailsDiaPlan;

constexpr int THREADS = 256;   // at most; lanes * (THREADS / lanes) used
constexpr int CHUNK = 8;       // terms whose loads are issued together

// The direct branch's load chunk: 4 terms at float64, so that its blocks
// fit 64 registers and four share an SM (the solve's shape, m = 65,536,
// s = 8: 8.75 us with 8, 7.16 with 4), 8 at float32 (4.49 us with 8, 4.96
// with 4 at the same shape); kernel_ablation --dia on an H100 at 700 W.
template <typename T>
constexpr int kDirectChunk = sizeof(T) == 8 ? 4 : 8;

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

// ---------------------------------------------------------------- direct

// y row i, one lane (x and y already offset to the lane's column).
// BYVAL: the offsets are p.off (the loop is unrolled to kCap, so every
// index into it is a constant); else offs (shared memory).  INTERIOR:
// every term's row lies in [0, n).
template <typename T, int V, bool BYVAL, bool INTERIOR>
__device__ __forceinline__ void direct_row(const T* __restrict__ data,
                                           const Plan& p, const int* offs,
                                           int d, const T* __restrict__ x,
                                           T* __restrict__ y, int m, int n,
                                           int s, int i) {
  using P = Pack<T, V>;
  P acc;
#pragma unroll
  for (int e = 0; e < V; ++e) acc.v[e] = T(0);
  constexpr int C = kDirectChunk<T>;
  const int dloop = BYVAL ? kCap : d;
#pragma unroll
  for (int k0 = 0; k0 < dloop; k0 += C) {
    T dv[C];
    P xv[C];
    bool ok[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int k = k0 + q;
      ok[q] = k < d;
      if (ok[q]) {
        int o;
        if constexpr (BYVAL) {
          o = p.off[k];
        } else {
          o = offs[k];
        }
        const int j = i + o;
        if (!INTERIOR) ok[q] = j >= 0 && j < n;
        if (ok[q]) {
          dv[q] = __ldg(data + (size_t)k * m + i);
          xv[q] = load_pack<T, V>(x + (size_t)j * s);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (ok[q]) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc.v[e] = fma_rn(dv[q], xv[q].v[e], acc.v[e]);
      }
    }
  }
  *reinterpret_cast<P*>(y + (size_t)i * s) = acc;
}

// Blocks are held to 64 registers so that four share an SM.
template <typename T, int V, bool BYVAL>
__global__ void __launch_bounds__(THREADS, 4)
dia_direct_kernel(const T* __restrict__ data, const Plan p,
                  const int* __restrict__ offsets, const T* __restrict__ x,
                  T* __restrict__ y, int m, int n, int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* offs = reinterpret_cast<int*>(smem);
  const int d = p.d;
  int omin = p.omin, omax = p.omax;
  if (!BYVAL) {
    for (int k = threadIdx.x; k < d; k += blockDim.x) offs[k] = offsets[k];
    __syncthreads();
    omin = offs[0];
    omax = offs[0];
    for (int k = 1; k < d; ++k) {
      omin = min(omin, offs[k]);
      omax = max(omax, offs[k]);
    }
  }
  const int lanes = p.lanes;
  const int lane = threadIdx.x % lanes;
  const int rows_per_block = blockDim.x / lanes;
  const int i = blockIdx.x * rows_per_block + threadIdx.x / lanes;
  const int c = (blockIdx.y * lanes + lane) * V;
  if (i >= m || c >= s) return;   // s % V == 0: a lane is whole or out
  if (i + omin >= 0 && i + omax < n) {
    direct_row<T, V, BYVAL, true>(data, p, offs, d, x + c, y + c, m, n, s,
                                  i);
  } else {
    direct_row<T, V, BYVAL, false>(data, p, offs, d, x + c, y + c, m, n,
                                   s, i);
  }
}

// ---------------------------------------------------------------- staged

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also expects ``bytes`` of copies; its release
// publishes the thread's earlier shared-memory writes with the stage.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Entry i of a by-value array, i from a lane: a select over the unrolled
// entries keeps the plan in parameter space (no local copy for an index
// only known at run time).
__device__ __forceinline__ int pick(const int (&a)[kCap], int i) {
  int v = 0;
#pragma unroll
  for (int k = 0; k < kCap; ++k) v = k == i ? a[k] : v;
  return v;
}

// One lane of the producer warp: the piece it copies for every tile, set
// up once.  Lane k < d: data row k (and the table entries of term k);
// lane d + g: x segment g; other lanes copy nothing.
struct Piece {
  int kind;      // 0: nothing, 1: a data row, 2: an x segment
  int k;         // term (kind 1)
  int lo, hi;    // kind 1: its segment's lo; kind 2: the segment's rows
  int off;       // kind 1: the term's offset
  int slot;      // byte offset of the piece's slot in a stage
  int tslot;     // kind 1: the term's segment's slot
};

__device__ __forceinline__ Piece piece_of(const Plan& p, int lane) {
  Piece pc{0, 0, 0, 0, 0, 0, 0};
  if (lane < p.d) {
    pc.kind = 1;
    pc.k = lane;
    pc.lo = pick(p.term_lo, lane);
    pc.off = pick(p.off, lane);
    pc.slot = lane * p.plane_bytes;
    pc.tslot = pick(p.term_slot, lane);
  } else if (lane < p.d + p.nseg) {
    pc.kind = 2;
    pc.lo = pick(p.seg_lo, lane - p.d);
    pc.hi = pick(p.seg_hi, lane - p.d);
    pc.slot = pick(p.seg_slot, lane - p.d);
  }
  return pc;
}

// The producer lane's share of the tile at row i0, into stage ``st``: its
// piece [a, b) of an array of ``total`` bytes at ``base`` (16-byte
// aligned) goes into its slot from a16 = a & ~15; the bulk part
// [a16, b16) ends at b rounded up to 16 but not past the array's last
// 16-byte boundary, and the ragged tail [b16, b) is copied with ordinary
// loads.  A data-row lane also writes term k's entries of the tile's
// table ``tb``: the stage index of x row i0 + off[k] at column 0 (tb[k])
// and of data[k, i0] (tb[kCap + k]).  The lane then arrives on ``bar``
// (initialised for 32 arrivals) expecting its bulk bytes - the arrival's
// release publishes its tail and table writes - and issues its copy.
template <typename T>
__device__ __forceinline__ void issue_piece(const T* __restrict__ data,
                                            const T* __restrict__ x,
                                            const Piece& pc, int rows,
                                            unsigned char* st, int* tb,
                                            uint64_t* bar, int i0, int m,
                                            int n, int s, int d) {
  const size_t xrow = (size_t)s * sizeof(T);
  const unsigned char* base = nullptr;
  size_t total = 0, a = 0, b = 0;
  if (pc.kind == 1) {
    int r0 = i0 + pc.lo;
    r0 = r0 < 0 ? 0 : (r0 > n ? n : r0);
    const int mis = (int)(((size_t)r0 * xrow) & 15);
    tb[pc.k] = (int)((pc.tslot + mis) / (int)sizeof(T) +
                     (long long)(i0 + pc.off - r0) * s);
    a = ((size_t)pc.k * m + i0) * sizeof(T);
    b = a + (size_t)min(rows, m - i0) * sizeof(T);
    tb[kCap + pc.k] = (pc.slot + (int)(a & 15)) / (int)sizeof(T);
    base = reinterpret_cast<const unsigned char*>(data);
    total = (size_t)d * m * sizeof(T);
  } else if (pc.kind == 2) {
    const int r0 = max(0, i0 + pc.lo);
    const int r1 = min(n, i0 + pc.hi);
    if (r1 > r0) {
      a = (size_t)r0 * xrow;
      b = (size_t)r1 * xrow;
      base = reinterpret_cast<const unsigned char*>(x);
      total = (size_t)n * xrow;
    }
  }
  uint32_t len = 0;
  if (base != nullptr) {
    const size_t a16 = a & ~size_t(15);
    size_t b16 = (b + 15) & ~size_t(15);
    const size_t lim = total & ~size_t(15);
    if (b16 > lim) b16 = lim;
    if (b16 < a16) b16 = a16;
    len = (uint32_t)(b16 - a16);
    if (b16 < b) {
      for (size_t e = b16; e < b; e += sizeof(T))
        *reinterpret_cast<T*>(st + pc.slot + (e - a16)) =
            *reinterpret_cast<const T*>(base + e);
      // the tail's ordinary stores, before the async proxy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    base += a16;
  }
  mbar_arrive_expect(bar, len);
  if (len) bulk_copy(st + pc.slot, base, len, bar);
}

// The tile's rows [0, nrows) for one lane from stage ``st`` (y already
// offset to the lane's column c).  EDGE: test each term's x row.
template <typename T, int V, bool EDGE>
__device__ __forceinline__ void tile_rows(const T* st, const int* tb,
                                          const Plan& p, T* __restrict__ y,
                                          int i0, int nrows, int n, int s,
                                          int c, int r_first, int r_step) {
  using P = Pack<T, V>;
  int xb[kCap], db[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    if (k < p.d) {
      xb[k] = tb[k] + c;
      db[k] = tb[kCap + k];
    }
  }
  for (int r = r_first; r < nrows; r += r_step) {
    P acc;
#pragma unroll
    for (int e = 0; e < V; ++e) acc.v[e] = T(0);
#pragma unroll
    for (int k0 = 0; k0 < kCap; k0 += CHUNK) {
      T dv[CHUNK];
      P xv[CHUNK];
      bool ok[CHUNK];
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        const int k = k0 + q;
        ok[q] = k < p.d;
        if (EDGE && ok[q]) {
          const int j = i0 + r + p.off[k];
          ok[q] = j >= 0 && j < n;
        }
        if (ok[q]) {
          dv[q] = st[db[k] + r];
          xv[q] = load_pack<T, V>(st + xb[k] + r * s);
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
    *reinterpret_cast<P*>(y + (size_t)(i0 + r) * s) = acc;
  }
}

// Warp 0 produces, the other warps (lanes * (THREADS / lanes) threads)
// consume.  full[q]: stage q holds its tile (32 producer arrivals plus
// the copies' bytes); empty[q]: every consumer warp is done with it.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS + 32, 2)
dia_staged_kernel(const T* __restrict__ data, const Plan p,
                  const T* __restrict__ x, T* __restrict__ y, int m, int n,
                  int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ __align__(8) uint64_t empty[2];
  __shared__ int tab[2][2 * kCap];
  const int R = p.rows;
  const int S = p.stages;
  const int tiles = (m + R - 1) / R;
  const int consumers = blockDim.x - 32;
  const int consumer_warps = (consumers + 31) / 32;
  if (threadIdx.x == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(&full[q], 32);
      mbar_init(&empty[q], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int q = 0;
  uint32_t phase = 0;
  if (threadIdx.x < 32) {
    // producer: a stage's next tile goes out once its consumers are done
    const Piece pc = piece_of(p, threadIdx.x);
    int use = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++use) {
      if (use >= S) mbar_wait(&empty[q], phase ^ 1);
      issue_piece<T>(data, x, pc, R, smem + q * p.stage_bytes, tab[q],
                     &full[q], t * R, m, n, s, p.d);
      if (++q == S) {
        q = 0;
        phase ^= 1;
      }
    }
    return;
  }
  const int ct = threadIdx.x - 32;
  const int lanes = p.lanes;
  const int lane = ct % lanes;
  const int r_first = ct / lanes;
  const int r_step = consumers / lanes;
  const int c = lane * V;
  const bool warp_leader = (ct & 31) == 0;
  const int in_warp = blockDim.x - (threadIdx.x & ~31);   // the last may
  const unsigned wmask = in_warp >= 32 ? 0xffffffffu      // be partial
                                       : (1u << in_warp) - 1;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    mbar_wait(&full[q], phase);
    const T* st = reinterpret_cast<const T*>(smem + q * p.stage_bytes);
    const int i0 = t * R;
    if (i0 + p.omin >= 0 && i0 + R + p.omax <= n && i0 + R <= m) {
      tile_rows<T, V, false>(st, tab[q], p, y + c, i0, R, n, s, c, r_first,
                             r_step);
    } else {
      tile_rows<T, V, true>(st, tab[q], p, y + c, i0, min(R, m - i0), n, s,
                            c, r_first, r_step);
    }
    __syncwarp(wmask);   // the warp is done with stage q
    if (warp_leader) mbar_arrive(&empty[q]);
    if (++q == S) {
      q = 0;
      phase ^= 1;
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int V>
int launch_v(const T* data, const Plan& p, const int* offsets, const T* x,
             T* y, int m, int n, int s, cudaStream_t stream) {
  if (p.staged) {
    static int smem_set = 48 * 1024;   // the default needs no attribute
    const int smem = p.stages * p.stage_bytes;
    if (smem > smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          dia_staged_kernel<T, V>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      smem_set = smem;
    }
    const int threads = p.lanes * (THREADS / p.lanes) + 32;
    dia_staged_kernel<T, V><<<p.grid, threads, smem, stream>>>(data, p, x, y,
                                                             m, n, s);
    return (int)cudaGetLastError();
  }
  const int rows_per_block = THREADS / p.lanes;
  const int threads = p.lanes * rows_per_block;
  const int col_tile = p.lanes * V;
  const dim3 grid((unsigned)((m + rows_per_block - 1) / rows_per_block),
                  (unsigned)((s + col_tile - 1) / col_tile));
  if (p.byval) {
    dia_direct_kernel<T, V, true><<<grid, threads, 0, stream>>>(
        data, p, offsets, x, y, m, n, s);
  } else {
    dia_direct_kernel<T, V, false>
        <<<grid, threads, (size_t)p.d * sizeof(int), stream>>>(
            data, p, offsets, x, y, m, n, s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* data, const Plan* p, const int* offsets, const T* x,
           T* y, long long m, long long n, int s, void* stream) {
  if (m <= 0 || s <= 0) return 0;
  if (p == nullptr || m > 0x7fffffffLL || n < 0 || n > 0x7fffffffLL ||
      p->d < 0 || p->vec <= 0 || s % p->vec || p->lanes < 1 ||
      p->lanes > THREADS || (p->byval && p->d > kCap) ||
      (!p->byval && offsets == nullptr) || (!p->byval && p->d < 1))
    return (int)cudaErrorInvalidValue;
  if (p->staged &&
      (!p->byval || p->d < 1 || p->rows <= 0 ||
       (p->stages != 1 && p->stages != 2) || p->lanes * p->vec != s ||
       p->grid < 1 || p->stage_bytes <= 0 || p->stage_bytes % 16 ||
       p->plane_bytes % 16 || p->nseg < 1 || p->nseg > kCap ||
       (((uintptr_t)data | (uintptr_t)x) & 15)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mi = (int)m, ni = (int)n;
  if (p->vec == 1)
    return launch_v<T, 1>(data, *p, offsets, x, y, mi, ni, s, st);
  if (p->vec == 2)
    return launch_v<T, 2>(data, *p, offsets, x, y, mi, ni, s, st);
  if constexpr (sizeof(T) == 4) {
    if (p->vec == 4)
      return launch_v<T, 4>(data, *p, offsets, x, y, mi, ni, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when the launch was
// accepted (cudaErrorInvalidValue for a plan it cannot run).  plan: from
// sparse/spmm.py::dia_plan; offsets: the (d,) int32 device array, read
// where the plan does not carry the offsets by value.  Nothing is
// synchronised and nothing is allocated.
int rails_dia_spmm_f32(const float* data, const RailsDiaPlan* plan,
                       const int* offsets, const float* x, float* y,
                       long long m, long long n, int s, void* stream) {
  return launch<float>(data, plan, offsets, x, y, m, n, s, stream);
}

int rails_dia_spmm_f64(const double* data, const RailsDiaPlan* plan,
                       const int* offsets, const double* x, double* y,
                       long long m, long long n, int s, void* stream) {
  return launch<double>(data, plan, offsets, x, y, m, n, s, stream);
}

}  // extern "C"
