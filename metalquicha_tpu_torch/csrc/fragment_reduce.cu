// Per-fragment sums whose bits do not depend on the batch.
//
// Replaces no Pallas kernel: the JAX package leaves these contractions and
// sums to XLA, which on the CPU reduces each fragment the same way whatever
// the batch. On a card the port's torch ops did not:
// - GFN2's moment contractions (torch.einsum "bkd,bdkl->bkl", a batched
//   cuBLAS product whose routine, and with it the order of each sum,
//   follows the batch count; metalquicha_tpu/methods/xtb/engine.py:567);
// - torch's reductions, which split a row across more threads where the
//   tensor has fewer rows (e_band over 96 AOs: 32 lanes a row at 16
//   fragments, 64 at 8), and across blocks where a row is long;
// - scatter_add, which sums a segment with atomics in whatever order the
//   threads arrive (ROADMAP C17).
// Here every output is summed in one order fixed by the sizes alone.
//
// Entries (f32 and f64; each operand one fragment after the other,
// contiguous; indices int64):
// - moment_fock: g[b,k,l] = sum_d v1[b,k,d] m1[b,d,k,l]
//                         + sum_d v2[b,k,d] m2[b,d,k,l]
//   (each sum over d ascending from 0, then the two added), and out =
//   f - 0.5 (g + g^T) with `sym` (GFN2's Fock matrix, F + (G + G^T) / 2
//   with G = -g, in one launch), out = g without;
// - moment_rows: c[b,k,e] = sum_l a[b,k,l] m[b,e,k,l], l ascending from 0;
//   with an index, out[b,s,e] = sum over k ascending with idx[b,k] == s of
//   w[b,k] c[b,k,e] (w optional), in the same launch;
// - segment_sum: out[b,s,e] = sum over k ascending with idx[b,k] == s of
//   w[b,k] v[b,k,e] (w optional): scatter_add in a fixed order;
// - fragment_sum: out[r] = the sum of row r of x (rows, len) by `lanes(len)`
//   lanes: lane j sums elements j, j + lanes, ... in ascending order from
//   0, then the lanes' partial sums are halved pairwise, x[t] + x[t + h]
//   for h = lanes / 2, ..., 1.
// Every product and sum is rounded on its own (__dmul_rn / __dadd_rn, no
// FMA contraction), so the plain versions in elementwise torch ops
// (`ops/fragment_reduce.py`, *_reference) reproduce the kernel's bits.
//
// moment_fock, redesigned for the H100 with the same bits (GFN2's Fock
// matrix once an SCC iteration and in the functional). What bounds it:
// the bytes, the 9 planes of D and Q read once (553 MB at (5985, 32),
// 0.165 ms at the memory rate); its (2 d + 3) n^2 operations are far
// under the vector rate. The first version ran a thread an output that
// computed both g[k, l] and g[l, k]: every element of D and Q was read
// twice, the second read (row l, column k) transposed, so a warp's loads
// touched 32 rows n elements apart, and every g was computed twice (36%
// of the bound at (64, 48)). Now:
// - a unit is (fragment, tile pair I <= J) of TS x TS tiles (TS = 16, 8
//   where n fits one such tile: four fragments a block), a thread an
//   element of tile (I, J) and its mirror in tile (J, I): each element of
//   D and Q is loaded once, by one thread, consecutive threads on
//   consecutive l in both tiles (coalesced), and each g is one chain;
// - every load a thread makes (its elements of all nine planes, and f)
//   is issued before it waits on any, so a block makes one round trip to
//   memory (a first design that staged v and synchronized before the
//   planes' loads and read f after the chains made three, and ran slower
//   than the first version where the batch fills the card); into
//   registers, not a shared-memory ring: no element is read twice, so
//   staging would buy no reuse;
// - v's rows of the tiles I and J are staged in shared memory while the
//   loads are in flight;
// - the nine planes' values take a thread's registers (about 100 in f64:
//   two 256-thread blocks an SM); where a cap of three blocks an SM, and
//   only that, holds the grid in one wave (GFN2 hexamers (64, 48) and
//   dodecamers (16, 96): 384 and 336 blocks), the registers are capped
//   (the occupancy of both forms queried once per device); where the
//   batch fills the card the cap ran slower;
// - the g of both tiles are exchanged through shared memory (rows padded
//   by one element), and out[I, J] and out[J, I] are stored coalesced; a
//   diagonal tile exchanges within itself.
// The chains are the first version's: g = sum_d v1[k, d] m1[d, k, l] from
// +0 in ascending d, the same for v2, m2, then added; out = f - 0.5 (g[k,
// l] + g[l, k]); an addition commutes, so out[l, k] takes the same pair.
// Without `sym` (moment_contract, the contraction of moment_rows'
// backward) there is no transpose to share: it keeps the first version's
// thread an output, coalesced, which measured faster than the tiles.

// fragment_sum, redesigned for the H100 with the same bits (every sum of
// the energy on a card, and the backward of `broadcast`). Its first
// version ran a warp a row up to kWarpRowMax elements and a block a row
// above. What bounds it: the bytes (every element read once) where the
// rows fill the card; where they do not, a long row's 256 lane chains
// (each len / 256 dependent adds) and how fast one SM streams the row:
// at (16, 96) GFN2's (6, n, n) sums ran 16 blocks, each streaming 442 KB
// through one SM; at (1, 241) one SM streamed 2.8 MB. Now:
// - long rows where the rows leave SMs idle (fewer than two blocks an SM)
//   and a row is long (kSumClusterLen64 / 32 elements: below, a block a
//   row was measured faster, its chains short against a cluster's fixed
//   cost): a row's 256 chains spread over a thread block cluster of K
//   blocks (K up to kMaxSumCluster where the card holds such a cluster,
//   queried once per device, else 8; each block at least kSumMinBytes of
//   the row), each chain keeping its elements and their order. A block's
//   lanes (its first warps) add from shared memory while its other warps
//   stage the block's slice of the next tiles (kSumStages tiles of
//   kSumTile elements, 16-byte cp.async.cg where the row's base allows
//   it), one barrier a tile; the lanes read kSumBatch elements into
//   registers ahead of their adds. Block 0 of the cluster gathers the 256
//   partial sums through distributed shared memory after cluster.sync()
//   and halves them in the same pairs. The floor that stays: a chain's
//   len / 256 dependent adds (1361 at (1, 241)); a shorter one needs
//   another lane count, which would change the bits.
// - other long rows: a block a row, as the first version.
// - short rows (up to kGroupRowMax elements): a row of up to 16 elements
//   takes a group of W lanes (the next power of two, at least 4), so a
//   warp sums 32 / W rows; the tree's levels that pair a lane with one
//   past the row add their +0 as the 32-lane tree does. Where the rows
//   fill the card, a group takes four rows, their loads issued together.
//   Rows of kGroupRowMax to kWarpRowMax elements: a warp a row, as the
//   first version.

// moment_rows and segment_sum, redesigned for the H100 with the same
// bits. What bounds them: a fragment's chains are few and serial (at
// (16, 96) with d = 3, 16 x 96 x 3 chains of 96 dependent adds) and the
// bytes small (a, m read once: 4.7 MB at (16, 96), 1.4 us at the memory
// rate), so the time is how soon the operands reach the chains and how
// many chains run at once; at (5985, 32) the bytes (196 MB) bound it. The
// first version ran a thread per output, each walking its rows of a and m
// in global memory one dependent load after the other, uncoalesced (16.6x
// torch's time at (16, 96)). Now:
// - moment_rows: a unit is (fragments, band of rows, group of planes):
//   a fragment's rows cut into bands where the batch alone would leave
//   the card idle, several fragments to a block where a fragment is
//   small (`rows_plan`). The band's rows of a and of each plane of m are
//   staged into shared memory in tiles of L columns of l by 16-byte
//   cp.async.cg (element by element where the operand's base or rows are
//   not 16-byte aligned), up to four tiles in flight, so any n fits; a
//   row is padded by one 16-byte chunk, so the chains' 16-byte reads
//   (rows of one plane in consecutive threads) are free of bank
//   conflicts. A thread a chain (k, e) carries c[k, e] across the tiles
//   in ascending l: every chain of the unit runs at once, from shared
//   memory. Without an index, c is stored coalesced. With one, c stays in
//   shared memory; where a small batch spreads a fragment's bands over
//   several blocks, those blocks are one thread block cluster (up to
//   kMaxCluster), and the segment sums read each member's c through
//   distributed shared memory after cluster.sync(). Where a fragment's c
//   would not fit (thousands of AOs), a block holds a run of its bands
//   at a time and adds each run's sums on to the outputs, the entries
//   still in ascending k.
// - segment_sum: a block stages its fragments' (n, c) values (or a band
//   of columns, where c is large: the gathers' backward over (n, n)
//   tables), index and weights coalesced; a fragment too long for shared
//   memory in runs of entries, summed on in the same way.
// In both, a group of 8 to 32 lanes sums a segment (`segment_walk`): a
// ballot over as many entries of the staged index at a time finds its
// members, which a lane a column adds in ascending k; where a batch that
// fills the card gives segment_sum few columns, a thread an output scans
// the staged index instead (measured faster there, slower elsewhere).
// Whatever the index: segments need not be sorted runs, and an entry
// outside [0, size) adds to none. The launches
// allocate nothing and never synchronize; the card's SM count and
// shared-memory limit are queried once per device; a cluster launch
// (cudaLaunchKernelEx) is captured into CUDA graphs like any other. Each
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
// fragment_sum: rows up to this length are summed by 32 lanes (a warp,
// or a group of lanes of one), longer by 256 (a block, or a cluster of up
// to kMaxSumCluster blocks); the long rows' staged tiles: elements a tile,
// tiles in flight
constexpr long long kWarpRowMax = 4096;
// rows up to this length: lane groups, several rows a group (a warp a row
// above)
constexpr long long kGroupRowMax = 4 * kWarp;
constexpr int kSumTile = 2048;
constexpr int kSumStages = 4;
constexpr int kMaxSumCluster = 16;
// the shortest row a cluster takes (f64, f32: 128 and 512 elements a
// lane; below, a block a row was measured faster, its chains shorter than
// a cluster's fixed cost, the sooner so in f32, whose adds are quicker),
// and the fewest bytes of a row a block of a cluster streams
constexpr long long kSumClusterLen64 = 128 * 256;
constexpr long long kSumClusterLen32 = 512 * 256;
constexpr long long kSumMinBytes = 48 * 1024;
// a lane's staged elements read into registers at a time
constexpr int kSumBatch = 16;
// moment_fock: threads a block, the side of a tile (kFockSmallTile where
// n fits one tile of it: several fragments a block), the planes whose
// loads a thread issues at once (D's 3 and Q's 6)
constexpr int kFockThreads = 256;
constexpr int kFockTile = 16;
constexpr int kFockSmallTile = 8;
constexpr int kFockBatch = 9;
// moment_fock: the blocks an SM holds where the registers are capped to
// hold a grid in one wave (`launch_fock`)
constexpr int kFockWaveBlocks = 3;
// threads a block of moment_rows and of segment_sum
constexpr int kRowThreads = 256;
constexpr int kSegThreads = 256;
// segment_sum over a batch that fills the card, of up to this many
// columns: a thread an output scanning the index; else a lane group a
// segment (`walk_sums`)
constexpr int kScanCols = 16;
// shared memory by which the plans cut: two of moment_rows' staged tiles
// (more in flight where they fit), segment_sum's staged values
constexpr long long kStageBytes = 48 * 1024;
// shared memory a block gets without opting in
constexpr long long kDefaultSmem = 48 * 1024;
// the fewest rows of a band where a small batch is cut into bands
constexpr int kMinBand = 8;
// without an index (no cluster to feed), bands of at least 16 rows
// (measured faster at (64, 48), slower at 96-241 AOs but still well under
// the first version's time there)
constexpr int kMinBandPlain = 16;
// the most tiles of moment_rows in flight in a block
constexpr int kMaxStages = 4;
// the most blocks of a cluster (the portable limit): one fragment's bands
// with an index
constexpr int kMaxCluster = 8;

__device__ __forceinline__ double add_(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_(float a, float b) {
  return __fmul_rn(a, b);
}

// One launch of moment_fock: a unit is (fragment, tile pair I <= J) of TS
// x TS tiles of the (n, n) output, nt tiles a side, `pairs` = nt (nt + 1)
// / 2 units a fragment; kFockThreads / TS^2 units a block.
template <typename T>
struct Fock {
  const T* f;
  const T* v1;
  const T* m1;
  const T* v2;
  const T* m2;
  T* out;
  long long units;
  int n, d1, d2, nt, pairs;
};

// Shared memory of a block of moment_fock_kernel<T, TS>: for each of its
// units, v's rows of the tiles I and J (2 TS (d1 + d2)), then the g of
// tiles (I, J) and (J, I), rows padded by one element (2 TS (TS + 1))
template <typename T, int TS>
size_t fock_smem(const Fock<T>& p) {
  constexpr int U = kFockThreads / (TS * TS);
  return static_cast<size_t>(U) * 2 * TS * (p.d1 + p.d2 + TS + 1) *
         sizeof(T);
}

// A thread holds element (k, l) = (I TS + ty, J TS + tx) of tile (I, J)
// and, off the diagonal, (k2, l2) = (J TS + ty, I TS + tx) of tile (J, I):
// g = sum_d v1[k, d] m1[d, k, l] (+ sum_d v2[k, d] m2[d, k, l]), each sum
// from +0 in ascending d, then the two added. Every load the thread makes
// is issued before it waits on any (the planes of m1 then m2, up to
// kFockBatch of them, of both its elements, and f): every element of m1
// and m2 is read once, consecutive threads on consecutive l. Then v's
// rows are staged, the chains run, the g of both tiles are exchanged
// through shared memory and out[k, l] = f[k, l] - 0.5 (g[k, l] + g[l,
// k]) is stored for both elements.
template <typename T, int TS>
__device__ __forceinline__ void fock_tiles(const Fock<T>& p) {
  constexpr int TT = TS * TS, U = kFockThreads / TT, LD = TS + 1;
  constexpr int B = kFockBatch;
  extern __shared__ __align__(16) unsigned char fock_smem_[];
  const int n = p.n, d1 = p.d1, ds = p.d1 + p.d2;
  const int slot = threadIdx.x / TT, r = threadIdx.x % TT;
  const int ty = r / TS, tx = r % TS;
  const long long u = static_cast<long long>(blockIdx.x) * U + slot;
  const bool unit = u < p.units;
  const long long b = unit ? u / p.pairs : 0;
  int q = unit ? static_cast<int>(u - b * p.pairs) : 0, I = 0;
  while (q >= p.nt - I) {
    q -= p.nt - I;
    ++I;
  }
  const int J = I + q;
  const bool diag = I == J;
  const long long nn = static_cast<long long>(n) * n;
  const int k = I * TS + ty, l = J * TS + tx;
  const int k2 = J * TS + ty, l2 = I * TS + tx;
  const bool live = unit && k < n && l < n;
  const bool live2 = unit && !diag && k2 < n && l2 < n;
  // offsets in a fragment's (n, n) plane, and of the fragment's planes
  const long long ok = static_cast<long long>(k) * n + l;
  const long long ok2 = static_cast<long long>(k2) * n + l2;
  const T* m1 = p.m1 + b * d1 * nn;
  const T* m2 = p.d2 > 0 ? p.m2 + b * p.d2 * nn : m1;
  T x[B], y[B];
  // planes d0 .. d0 + B - 1 of both elements (m1's planes, then m2's)
  auto load = [&](int d0) {
#pragma unroll
    for (int e = 0; e < B; ++e) {
      const int dd = d0 + e;
      const T* plane = dd < d1 ? m1 + dd * nn : m2 + (dd - d1) * nn;
      x[e] = live && dd < ds ? __ldg(plane + ok) : T(0);
      y[e] = live2 && dd < ds ? __ldg(plane + ok2) : T(0);
    }
  };
  load(0);
  const T fk = live ? __ldg(p.f + b * nn + ok) : T(0);
  const T fk2 = live2 ? __ldg(p.f + b * nn + ok2) : T(0);

  // v's rows of tiles I and J: sv[h][row][d], d over v1's then v2's
  T* sv = reinterpret_cast<T*>(fock_smem_) +
          static_cast<long long>(slot) * 2 * TS * (ds + LD);
  for (int e = r; e < 2 * TS * ds; e += TT) {
    const int row = e / ds, dd = e - row * ds;
    const int kk = row < TS ? I * TS + row : J * TS + row - TS;
    T vv = T(0);
    if (unit && kk < n)
      vv = dd < d1 ? p.v1[(b * n + kk) * d1 + dd]
                   : p.v2[(b * n + kk) * p.d2 + dd - d1];
    sv[e] = vv;
  }
  __syncthreads();

  const T* vk = sv + ty * ds;
  const T* vk2 = sv + (TS + ty) * ds;
  T a1 = T(0), a2 = T(0), c1 = T(0), c2 = T(0);
  for (int d0 = 0;;) {
#pragma unroll
    for (int e = 0; e < B; ++e) {
      const int dd = d0 + e;
      if (dd < d1) {
        a1 = add_(a1, mul_(vk[dd], x[e]));
        c1 = add_(c1, mul_(vk2[dd], y[e]));
      } else if (dd < ds) {
        a2 = add_(a2, mul_(vk[dd], x[e]));
        c2 = add_(c2, mul_(vk2[dd], y[e]));
      }
    }
    d0 += B;
    if (d0 >= ds) break;
    load(d0);
  }
  const T g = p.d2 > 0 ? add_(a1, a2) : a1;
  const T g2 = p.d2 > 0 ? add_(c1, c2) : c1;
  // g of tile (I, J) at sx[ty][tx], of tile (J, I) at sx[TS + ty][tx]
  T* sx = sv + 2 * TS * ds;
  sx[ty * LD + tx] = g;
  sx[(TS + ty) * LD + tx] = g2;
  __syncthreads();
  if (live) {
    // g[l, k]: tile (I, I) at (tx, ty) on the diagonal, else tile (J, I)
    const T gt = sx[((diag ? 0 : TS) + tx) * LD + ty];
    p.out[b * nn + ok] = sub_(fk, mul_(T(0.5), add_(g, gt)));
  }
  if (live2) {
    // g[l2, k2]: tile (I, J) at (tx, ty)
    const T gt2 = sx[tx * LD + ty];
    p.out[b * nn + ok2] = sub_(fk2, mul_(T(0.5), add_(g2, gt2)));
  }
}

// `fock_tiles`, its registers left to the compiler, and capped so that
// an SM holds kFockWaveBlocks blocks (`launch_fock`)
template <typename T, int TS>
__global__ void __launch_bounds__(kFockThreads)
    moment_fock_kernel(const Fock<T> p) {
  fock_tiles<T, TS>(p);
}

template <typename T, int TS>
__global__ void __launch_bounds__(kFockThreads, kFockWaveBlocks)
    moment_fock_wave_kernel(const Fock<T> p) {
  fock_tiles<T, TS>(p);
}

// moment_fock without `sym` (moment_contract): a thread an output, g =
// sum_d v1[k, d] m1[d, k, l] (+ the same of v2, m2) as above, consecutive
// threads on consecutive l (coalesced; no transpose to share, so the
// first version's schedule, measured faster than the tiles here)
template <typename T>
__device__ __forceinline__ T contract(const T* __restrict__ v,
                                      const T* __restrict__ m, int dv,
                                      int n, int k, int l) {
  const long long nn = static_cast<long long>(n) * n;
  T acc = T(0);
  for (int d = 0; d < dv; ++d)
    acc = add_(acc, mul_(v[k * dv + d], m[d * nn + k * n + l]));
  return acc;
}

template <typename T>
__global__ void moment_contract_kernel(const T* __restrict__ v1,
                                       const T* __restrict__ m1, int d1,
                                       const T* __restrict__ v2,
                                       const T* __restrict__ m2, int d2,
                                       T* __restrict__ out, long long total,
                                       int n) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long nn = static_cast<long long>(n) * n;
  const long long b = idx / nn;
  const int r = static_cast<int>(idx - b * nn);
  const int k = r / n, l = r - (r / n) * n;
  T g = contract(v1 + b * n * d1, m1 + b * d1 * nn, d1, n, k, l);
  if (d2 > 0)
    g = add_(g, contract(v2 + b * n * d2, m2 + b * d2 * nn, d2, n, k, l));
  out[idx] = g;
}

__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest `Pending` has landed
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// 16 bytes of a staged row
template <typename T>
struct Chunk;
template <>
struct Chunk<double> {
  using V = double2;
};
template <>
struct Chunk<float> {
  using V = float4;
};

// acc + a[0] m[0] + a[1] m[1] (+ ...) in ascending order, each product
// and sum rounded apart
__device__ __forceinline__ double chunk_dot(double acc, double2 a,
                                            double2 m) {
  acc = add_(acc, mul_(a.x, m.x));
  return add_(acc, mul_(a.y, m.y));
}
__device__ __forceinline__ float chunk_dot(float acc, float4 a, float4 m) {
  acc = add_(acc, mul_(a.x, m.x));
  acc = add_(acc, mul_(a.y, m.y));
  acc = add_(acc, mul_(a.z, m.z));
  return add_(acc, mul_(a.w, m.w));
}

// every cp.async group but the newest `pending` (0-3) has landed
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0:
      cp_async_wait<0>();
      break;
    case 1:
      cp_async_wait<1>();
      break;
    case 2:
      cp_async_wait<2>();
      break;
    default:
      cp_async_wait<3>();
  }
}

// `count` entries of a (batch, n) index (and weights) from flat entry
// `from` into shared memory: sseg the index (-1 outside [0, size)), sw the
// weights (several whole fragments, or a run of one fragment's entries)
template <typename T>
__device__ __forceinline__ void stage_index(const long long* __restrict__ seg,
                                            const T* __restrict__ w,
                                            long long from, int count,
                                            int size, int* sseg, T* sw) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const long long x = seg[from + i];
    sseg[i] = x >= 0 && x < size ? static_cast<int>(x) : -1;
    if (w) sw[i] = w[from + i];
  }
}

// lanes a segment's sum takes (`segment_walk`): at least its columns and
// 8, more (up to a warp: fewer ballots over a long index) where `lanes`
// lanes share `pairs` segments
__host__ __device__ __forceinline__ int walk_lanes(int cols, int lanes = 0,
                                                   int pairs = 1) {
  int gs = cols <= 8 ? 8 : cols <= 16 ? 16 : kWarp;
  while (gs < kWarp && 2 * gs * pairs <= lanes) gs *= 2;
  return gs;
}

// The sum of segment s of one fragment's staged index `row` (n entries)
// by a group of gs lanes (a power of two) of a warp, the warp's groups
// each on its own segment (`valid`: the group has one): the group finds
// the members gs entries at a time by a ballot, then each lane that
// holds a column (`active`) adds w[k] x(k), or x(k) without weights, for
// the members k in ascending order, from acc (+0, or the sum over the
// entries before `row`: the plain version's order; an entry outside [0,
// size) matches no s). Every lane of the warp calls it the same number of
// times.
template <typename T, typename Get>
__device__ __forceinline__ T segment_walk(const int* __restrict__ row, int n,
                                          int s, const T* __restrict__ w,
                                          int gs, bool valid, bool active,
                                          T acc, Get x) {
  const int lane = threadIdx.x % kWarp, g0 = lane & ~(gs - 1);
  const unsigned mine = gs == kWarp ? 0xffffffffu : (1u << gs) - 1u;
  for (int k0 = 0; k0 < n; k0 += gs) {
    const int k = k0 + (lane - g0);
    unsigned hits =
        (__ballot_sync(0xffffffffu, valid && k < n && row[k] == s) >> g0) &
        mine;
    while (hits) {
      const int q = k0 + __ffs(hits) - 1;
      hits &= hits - 1;
      if (active) {
        const T v = x(q);
        acc = add_(acc, w ? mul_(w[q], v) : v);
      }
    }
  }
  return acc;
}

// out[f, s, e] of a unit, for fragments f < frags, segments s0 .. s0 +
// sn - 1 and columns e < cols, over n staged entries a fragment, by
// threads tid of `threads` (warps whole; a cluster's blocks together): a
// group of lanes an (f, s), a lane a column (`segment_walk`); x(f, q, e)
// the value of entry q, out(f, s, e) the output; with `more`, the sums go
// on from the outputs (the entries are a run after the runs summed
// before, by the same threads)
template <typename T, typename Get, typename Out>
__device__ __forceinline__ void walk_sums(const int* __restrict__ sseg,
                                          const T* __restrict__ sw, int n,
                                          int frags, int s0, int sn,
                                          int cols, int tid, int threads,
                                          bool more, Get x, Out out) {
  const int pairs = frags * sn;
  const int gs = walk_lanes(cols, threads, pairs), groups = threads / gs;
  const int g = tid / gs, li = tid % gs;
  for (int base = 0; base < pairs; base += groups) {
    const int pair = base + g;
    const bool valid = pair < pairs;
    const int f = valid ? pair / sn : 0, s = s0 + pair - f * sn;
    for (int el = 0; el < cols; el += gs) {
      const int e = el + li;
      const bool active = valid && e < cols;
      const T sum = segment_walk(sseg + f * n, n, s,
                                 sw ? sw + f * n : nullptr, gs, valid,
                                 active, more && active ? out(f, s, e) : T(0),
                                 [&](int q) { return x(f, q, e); });
      if (active) out(f, s, e) = sum;
    }
  }
}

// Where moment_rows' segment sums run: none (no index: c stored); Block,
// in the block that computed c, after each run of its bands; Cluster,
// across a cluster's blocks after all of them have their c
enum class Sums { None, Block, Cluster };

// One launch of moment_rows: the schedule the C entry chose (`rows_plan`)
// and the operands. A unit is F fragments x a band of R rows x a group of
// De planes of m; with an index, a fragment's nb bands are computed by
// the C blocks of a cluster (block `rank` bands rank, rank + C, ...; C = 1
// where the batch fills the card), else every (band, group, fragments)
// is its own block. A block holds the c of nbl of its bands at a time: in
// a cluster all of them; with C = 1 a run of nbl bands, whose segment sums
// it adds on to the outputs of the runs before (where a fragment's c would
// not fit its shared memory).
template <typename T>
struct Rows {
  const T* a;
  const T* m;
  const long long* seg;
  const T* w;
  T* out;
  long long batch;
  int n, d, size;
  int F, R, De, groups, nb, C, nbl, stages;
  int vec_a, vec_m;
};

// Shared memory of a block: `stages` tiles of F (1 + De) R staged rows of
// LD elements (per fragment a's band, then each plane's), then c of the
// bands it holds (F x nbl x R x De), then with an index the weights and
// the index of the entries whose c the block or its cluster holds (F x
// `span`).
template <typename T, int L>
struct RowsSmem {
  static constexpr int E = 16 / sizeof(T);
  // a row padded by one chunk: LD / E chunks is odd, so the 8 rows a
  // quarter-warp's 16-byte reads touch fall on distinct banks
  static constexpr int LD = L + E;
  static size_t tile(const Rows<T>& p) {
    return static_cast<size_t>(p.F) * (1 + p.De) * p.R * LD * sizeof(T);
  }
  // the entries whose index a block stages at once
  __host__ __device__ static int span(const Rows<T>& p) {
    const long long held = static_cast<long long>(p.nbl) * p.R * p.C;
    return held < p.n ? static_cast<int>(held) : p.n;
  }
  static size_t bytes(const Rows<T>& p) {
    const size_t c = static_cast<size_t>(p.F) * p.nbl * p.R * p.De *
                     sizeof(T);
    const size_t fn = p.seg ? static_cast<size_t>(p.F) * span(p) : 0;
    return p.stages * tile(p) + c + fn * (sizeof(T) + sizeof(int));
  }
};

// c[k, e] = sum_l a[k, l] m[e, k, l] a thread a chain (k, e) of the
// unit, l ascending through tiles of L staged by cp.async (16 bytes where
// the operand allows), up to `stages` tiles in flight; then, without an
// index (W = None), c stored coalesced; with one, out[s, e] a lane
// group an (f, s) (`walk_sums`): Block after each run of nbl bands, on
// from the runs before; Cluster at the end, reading each member's c from
// the shared memory of the cluster's block that computed it. Each way
// its own instantiation, with only its own code in the loop.
template <typename T, int L, Sums W>
__global__ void __launch_bounds__(kRowThreads, 4)
    moment_rows_kernel(const Rows<T> p) {
  using S = RowsSmem<T, L>;
  using V = typename Chunk<T>::V;
  constexpr int E = S::E, LD = S::LD, CH = L / E;
  constexpr bool segd = W != Sums::None;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int n = p.n, R = p.R, De = p.De, F = p.F;
  const int rows = F * (1 + De) * R, span = S::span(p);
  T* stage = reinterpret_cast<T*>(smem);
  T* sc = stage + static_cast<long long>(p.stages) * rows * LD;
  T* sw = sc + F * p.nbl * R * De;
  int* sseg = reinterpret_cast<int*>(sw + (segd ? F * span : 0));

  // the unit, and the bands of it this block computes
  long long u = blockIdx.x;
  int rank = 0, first, step, end;
  if constexpr (W == Sums::Block) {
    first = 0;
    step = 1;
    end = p.nb;
  } else if constexpr (W == Sums::Cluster) {
    rank = static_cast<int>(u % p.C);
    u /= p.C;
    first = rank;
    step = p.C;
    end = p.nb;
  } else {
    first = static_cast<int>(u % p.nb);
    u /= p.nb;
    step = 1;
    end = first + 1;
  }
  const int e0 = static_cast<int>(u % p.groups) * De;
  const long long b0 = (u / p.groups) * F;
  const int dv = min(De, p.d - e0);
  const int fv = static_cast<int>(min(static_cast<long long>(F),
                                      p.batch - b0));
  const int nt = (n + L - 1) / L;
  const int mine = (end - first + step - 1) / step;
  const int items = mine * nt;

  // item = (the block's band j, tile of l): a's and the planes' rows of
  // the band, columns l0 .. l0 + L - 1, zeros past n (each adds an exact
  // +0: a chain starts at +0 and so never holds -0)
  // a thread copies chunk j of rows r0, r0 + kRowStep, ...: (f, plane,
  // k) of its first row divided out once, then advanced by kRowStep
  constexpr int kRowStep = kRowThreads / CH;
  const int jc = (t % CH) * E, r0 = t / CH;
  const int k_0 = r0 % R, pl_0 = (r0 / R) % (1 + De),
            f_0 = r0 / (R * (1 + De));
  auto issue = [&](int item, T* buf) {
    const int k0 = (first + (item / nt) * step) * R;
    const int l0 = (item % nt) * L, cols = min(L, n - l0);
    int k = k_0, pl = pl_0, f = f_0;
    for (int r = r0; r < rows; r += kRowStep) {
      T* dst = buf + r * LD + jc;
      const bool live = f < fv && pl <= dv && k0 + k < n;
      const bool vec = pl == 0 ? p.vec_a : p.vec_m;
      const long long b = b0 + f;
      const T* src = pl == 0 ? p.a + (b * n + k0 + k) * n + l0
                             : p.m + ((b * p.d + e0 + pl - 1) * n + k0 + k) *
                                         n + l0;
      for (k += kRowStep; k >= R; k -= R) {
        if (++pl > De) {
          pl = 0;
          ++f;
        }
      }
      if (!live) continue;
      if (vec) {
        if (jc < cols) {
          cp_async16(dst, src + jc);
        } else {
          *reinterpret_cast<V*>(dst) = V{};
        }
      } else {
#pragma unroll
        for (int q = 0; q < E; ++q) {
          if (jc + q < cols) {
            cp_async(dst + q, src + jc + q);
          } else {
            dst[q] = T(0);
          }
        }
      }
    }
  };

  // the chain (k, e) of fragment f: consecutive threads take consecutive
  // rows of one plane
  const int k = t % R, e = (t / R) % De, f = t / (R * De);
  const bool chain = f < fv && e < dv;
  const int ns = p.stages;
  for (int s = 0; s < ns - 1; ++s) {
    if (s < items) issue(s, stage + s * rows * LD);
    cp_async_commit();
  }
  T acc = T(0);
  for (int it = 0; it < items; ++it) {
    const int ahead = it + ns - 1;
    if (ahead < items) issue(ahead, stage + (ahead % ns) * rows * LD);
    cp_async_commit();
    const int j = it / nt, tile = it - j * nt;
    // the entries whose c the block holds from band j on (Block: a run of
    // bands; Cluster: the fragment's): their index staged at the run's
    // first item, the loads overlapping the tiles' copies
    const int run0 = W == Sums::Block ? (j - j % p.nbl) * R : 0;
    const int kn = min(span, n - run0);
    if (segd && (W == Sums::Block ? tile == 0 && j % p.nbl == 0 : it == 0))
      stage_index(p.seg, p.w, b0 * n + run0, fv * kn, p.size, sseg, sw);
    cp_async_wait_pending(ns - 1);
    __syncthreads();
    const T* buf = stage + (it % ns) * rows * LD;
    if (tile == 0) acc = T(0);
    if (chain && (first + j * step) * R + k < n) {
      const V* ra =
          reinterpret_cast<const V*>(buf + (f * (1 + De) * R + k) * LD);
      const V* rm = reinterpret_cast<const V*>(
          buf + ((f * (1 + De) + 1 + e) * R + k) * LD);
#pragma unroll
      for (int c = 0; c < CH; ++c) acc = chunk_dot(acc, ra[c], rm[c]);
      if (tile == nt - 1)
        sc[((f * p.nbl + (W == Sums::Block ? j % p.nbl : j)) * R + k) * De +
           e] = acc;
    }
    __syncthreads();
    if constexpr (W == Sums::Block) {
      if (tile == nt - 1 && (j % p.nbl == p.nbl - 1 || j == mine - 1)) {
        // the run's sums (entries run0 .. run0 + kn - 1), on from the
        // runs before: every (f, s, e) by the same threads each time
        walk_sums(
            sseg, p.w ? sw : nullptr, kn, fv, 0, p.size, dv, t,
            kRowThreads, run0 > 0,
            [&](int ff, int q, int ee) {
              return sc[(ff * p.nbl * R + q) * De + ee];
            },
            [&](int ff, int s, int ee) -> T& {
              return p.out[((b0 + ff) * p.size + s) * p.d + e0 + ee];
            });
        if (j != mine - 1) __syncthreads();
      }
    }
  }

  if constexpr (W == Sums::None) {
    // c of the band, coalesced: consecutive threads, consecutive (k, e)
    const int k0 = first * R, nr = min(R, n - k0);
    for (int i = t; i < fv * nr * dv; i += kRowThreads) {
      const int ee = i % dv, kk = (i / dv) % nr, ff = i / (dv * nr);
      p.out[((b0 + ff) * n + k0 + kk) * p.d + e0 + ee] =
          sc[(ff * R + kk) * De + ee];
    }
  } else if constexpr (W == Sums::Cluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // out[s, e]; a member q's c lies with the block of rank (q / R) % C,
    // at its band (q / R) / C
    walk_sums(
        sseg, p.w ? sw : nullptr, n, fv, 0, p.size, dv,
        rank * kRowThreads + t, p.C * kRowThreads, false,
        [&](int ff, int q, int ee) {
          const int band = q / R;
          return *cluster.map_shared_rank(
              sc + ((ff * p.nbl + band / p.C) * R + q - band * R) * De + ee,
              band % p.C);
        },
        [&](int ff, int s, int ee) -> T& {
          return p.out[((b0 + ff) * p.size + s) * p.d + e0 + ee];
        });
    // no block leaves while another may still read its c
    cluster.sync();
  }
}

// One launch of segment_sum: a unit is F fragments x a band of Ce
// columns x a band of Sb segments; a block stages Kc entries a fragment
// at a time (all n, unless they would not fit its shared memory: then F
// = 1 and the sums go on run by run).
template <typename T>
struct Segments {
  const T* v;
  const long long* seg;
  const T* w;
  T* out;
  long long batch;
  int n, c, size;
  int F, Ce, bands_c, Sb, bands_s, scan, Kc;
  static size_t bytes_of(const Segments& p) {
    const size_t fn = static_cast<size_t>(p.F) * p.Kc;
    return fn * p.Ce * sizeof(T) + (p.w ? fn * sizeof(T) : 0) +
           fn * sizeof(int);
  }
};

// The unit's values (Kc x Ce a fragment, coalesced by element cp.async),
// index and weights staged; then the unit's sums: with Scan a thread an
// output scanning the staged index, else `walk_sums`; with Runs (Kc < n,
// not with Scan) again for each further run of Kc entries, on from the
// sums so far. Each way its own instantiation.
template <typename T, bool Scan, bool Runs>
__global__ void __launch_bounds__(kSegThreads)
    segment_sum_kernel(const Segments<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, n = p.n, Ce = p.Ce, F = p.F, Kc = p.Kc;
  T* sv = reinterpret_cast<T*>(smem);
  T* sw = sv + F * Kc * Ce;
  int* sseg = reinterpret_cast<int*>(sw + (p.w ? F * Kc : 0));

  long long u = blockIdx.x;
  const int s0 = static_cast<int>(u % p.bands_s) * p.Sb;
  u /= p.bands_s;
  const int e0 = static_cast<int>(u % p.bands_c) * Ce;
  const long long b0 = (u / p.bands_c) * F;
  const int cv = min(Ce, p.c - e0), sn = min(p.Sb, p.size - s0);
  const int fv = static_cast<int>(min(static_cast<long long>(F),
                                      p.batch - b0));
  auto out = [&](int f, int s, int e) -> T& {
    return p.out[((b0 + f) * p.size + s) * p.c + e0 + e];
  };

  const int runs = Runs ? (n + Kc - 1) / Kc : 1;
  for (int run = 0; run < runs; ++run) {
    // entries k0 .. k0 + kn - 1 of each fragment (F = 1 with Runs)
    const int k0 = Runs ? run * Kc : 0, kn = Runs ? min(Kc, n - k0) : n;
    // consecutive threads, consecutive columns of a row
    for (int i = t; i < fv * kn * cv; i += kSegThreads) {
      const int e = i % cv, r = i / cv;
      cp_async(sv + r * Ce + e, p.v + (b0 * n + k0 + r) * p.c + e0 + e);
    }
    cp_async_commit();
    stage_index(p.seg, p.w, b0 * n + k0, fv * kn, p.size, sseg, sw);
    cp_async_wait<0>();
    __syncthreads();

    if (Scan) {
      // a thread an output scans its fragment's staged index in
      // ascending k
      for (int i = t; i < fv * sn * cv; i += kSegThreads) {
        const int e = i % cv, s = s0 + (i / cv) % sn, f = i / (cv * sn);
        const int* row = sseg + f * kn;
        const T* w = p.w ? sw + f * kn : nullptr;
        T acc = Runs && run > 0 ? out(f, s, e) : T(0);
        for (int q = 0; q < kn; ++q) {
          if (row[q] != s) continue;
          const T x = sv[(f * kn + q) * Ce + e];
          acc = add_(acc, w ? mul_(w[q], x) : x);
        }
        out(f, s, e) = acc;
      }
    } else {
      walk_sums(
          sseg, p.w ? sw : nullptr, kn, fv, s0, sn, cv, t, kSegThreads,
          Runs && run > 0,
          [&](int f, int q, int e) { return sv[(f * kn + q) * Ce + e]; },
          out);
    }
    if (Runs && run + 1 < runs) __syncthreads();
  }
}

// lane j of a row: elements j, j + lanes, ... ascending from 0
template <typename T>
__device__ __forceinline__ T strided_sum(const T* __restrict__ x,
                                         long long len, int lane,
                                         int lanes) {
  T acc = T(0);
  for (long long i = lane; i < len; i += lanes) acc = add_(acc, x[i]);
  return acc;
}

// fragment_sum over rows up to kGroupRowMax long: the 32 lanes of a row
// are a group of W lanes (W = 32 above 16 elements; else the next power of
// two of the length, at least 4, so a warp sums 32 / W rows), each group
// RPG rows (RPG = 4 where the rows fill the card, for more bytes in
// flight), their loads issued together; lane j sums elements j, j + 32,
// ... ascending from +0 (for len <= W one element, lanes past the row
// +0).
// The tree's levels h = 16 .. W pair a lane with one past the row, which
// holds +0: each is the add of +0 it is; then the levels below W by
// shuffles of width W, lane t + h into lane t.
template <typename T, int W, int RPG>
__global__ void __launch_bounds__(kThreads)
    row_sum_group_kernel(const T* __restrict__ x, T* __restrict__ out,
                        long long rows, long long len) {
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / W *
      RPG;
  const int j = threadIdx.x % W;
  bool live[RPG];
  const T* xr[RPG];
  T v[RPG];
#pragma unroll
  for (int r = 0; r < RPG; ++r) {
    live[r] = row0 + r < rows;
    xr[r] = x + (live[r] ? row0 + r : 0) * len;
    v[r] = T(0);
  }
  if (W < kWarp) {
    // len <= W: at most one element a lane
    if (j < len) {
#pragma unroll
      for (int r = 0; r < RPG; ++r)
        if (live[r]) v[r] = add_(v[r], xr[r][j]);
    }
  } else {
    // up to four elements a lane (len <= kGroupRowMax): each step's loads
    // of every row together
    for (int i = j; i < len; i += kWarp) {
      T e[RPG];
#pragma unroll
      for (int r = 0; r < RPG; ++r) e[r] = live[r] ? xr[r][i] : T(0);
#pragma unroll
      for (int r = 0; r < RPG; ++r)
        if (live[r]) v[r] = add_(v[r], e[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPG; ++r) {
#pragma unroll
    for (int h = kWarp / 2; h >= W; h /= 2) v[r] = add_(v[r], T(0));
#pragma unroll
    for (int h = W / 2; h > 0; h /= 2)
      v[r] = add_(v[r], __shfl_down_sync(0xffffffffu, v[r], h, W));
  }
  if (j == 0) {
#pragma unroll
    for (int r = 0; r < RPG; ++r)
      if (live[r]) out[row0 + r] = v[r];
  }
}

// fragment_sum over rows of kGroupRowMax to kWarpRowMax elements: a warp
// a row, 32 lanes, then halved with shuffles, lane t + h into lane t (the
// first version's kernel; the lane groups above measured slower here)
template <typename T>
__global__ void row_sum_warp_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, long long rows,
                                    long long len) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;
  T v = strided_sum(x + row * len, len, lane, kWarp);
  for (int h = kWarp / 2; h > 0; h /= 2)
    v = add_(v, __shfl_down_sync(0xffffffffu, v, h));
  if (lane == 0) out[row] = v;
}

// the 256 lanes' sums of a row in part[] (kThreads of them) halved
// pairwise, t + h into t, through shared memory down to a warp, then
// with shuffles; the row's sum to *out
template <typename T>
__device__ __forceinline__ void halve_lanes(T* part, T* out) {
  const int t = threadIdx.x;
  for (int h = kThreads / 2; h >= kWarp; h /= 2) {
    if (t < h) part[t] = add_(part[t], part[t + h]);
    __syncthreads();
  }
  if (t < kWarp) {
    T v = part[t];
    for (int h = kWarp / 2; h > 0; h /= 2)
      v = add_(v, __shfl_down_sync(0xffffffffu, v, h));
    if (t == 0) *out = v;
  }
}

// fragment_sum over rows longer than kWarpRowMax where the rows fill the
// card: a block of kThreads lanes a row, each lane's elements read from
// global memory as they come (the first version's kernel)
template <typename T>
__global__ void row_sum_block_kernel(const T* __restrict__ x,
                                     T* __restrict__ out, long long len) {
  __shared__ T part[kThreads];
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  part[t] = strided_sum(x + row * len, len, t, kThreads);
  __syncthreads();
  halve_lanes(part, out + row);
}

// fragment_sum over rows longer than kWarpRowMax where the rows leave SMs
// idle: a row's 256 lanes (kThreads) spread over a cluster of K blocks,
// block k holding lanes k cb .. k cb + cb - 1 (cb = 256 / K). Lane c sums
// elements c, c + 256, ... ascending from +0: the block's slice of every
// 256-element stripe is staged into shared memory by all of its threads
// (16-byte cp.async.cg where the row's base allows it), kSumStages tiles
// of kSumTile elements in flight, and a thread a lane adds its elements
// from the staged tiles in order (a whole tile unrolled, so the reads run
// ahead of the adds). Then block 0 of the cluster gathers the 256 lanes'
// sums through distributed shared memory and halves them as one block
// does.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    row_sum_cluster_kernel(const T* __restrict__ x, T* __restrict__ out,
                           long long len, int vec) {
  extern __shared__ __align__(16) unsigned char sum_smem[];
  constexpr int E = 16 / sizeof(T);
  constexpr int cb = kThreads / K;  // lanes a block
  constexpr int S = kSumTile / cb;  // stripes a tile
  constexpr int per = cb / E;       // 16-byte chunks a stripe's slice
  T* ring = reinterpret_cast<T*>(sum_smem);  // kSumStages tiles
  T* part = ring + kSumStages * kSumTile;    // the block's lane sums
  const long long row = blockIdx.x / K;
  const int k = static_cast<int>(blockIdx.x % K);
  const int c0 = k * cb;
  const long long tiles = (len + S * kThreads - 1) / (S * kThreads);
  const T* xr = x + row * len;
  const int tid = threadIdx.x;
  // the lanes' threads (whole warps) add; the others stage
  constexpr int cw = cb < kWarp ? kWarp : cb;
  constexpr int np = kThreads - cw;
  const int pt = tid - cw;
  // the copies of tile t into its stage: chunks of E elements (one
  // element a copy at the row's end, or everywhere without vec)
  auto issue = [&](long long t) {
    T* dst = ring + (t % kSumStages) * kSumTile;
    const long long first = t * S * kThreads + c0;
    if (vec) {
      for (int i = pt; i < S * per; i += np) {
        const int sl = i / per, cc = (i % per) * E;
        const long long e = first + static_cast<long long>(sl) * kThreads +
                            cc;
        T* d = dst + sl * cb + cc;
        if (e + E <= len) {
          cp_async16(d, xr + e);
        } else {
          for (int u = 0; u < E && e + u < len; ++u)
            cp_async(d + u, xr + e + u);
        }
      }
    } else {
      for (int i = pt; i < S * cb; i += np) {
        const int sl = i / cb, cc = i % cb;
        const long long e = first + static_cast<long long>(sl) * kThreads +
                            cc;
        if (e < len) cp_async(dst + sl * cb + cc, xr + e);
      }
    }
  };
  if (pt >= 0) {
    for (int t = 0; t < kSumStages - 1; ++t) {
      if (t < tiles) issue(t);
      cp_async_commit();
    }
    cp_async_wait<kSumStages - 2>();  // tile 0 has landed
  }
  __syncthreads();
  T acc = T(0);
  // each step: the lanes add tile t while the stagers issue tile t +
  // kSumStages - 1 (into the stage tile t - 1 held) and wait for tile t + 1
  for (long long t = 0; t < tiles; ++t) {
    if (pt >= 0) {
      if (t + kSumStages - 1 < tiles) issue(t + kSumStages - 1);
      cp_async_commit();
      cp_async_wait<kSumStages - 2>();
    } else if (tid < cb) {
      const T* tile = ring + (t % kSumStages) * kSumTile + tid;
      // this lane's elements in the tile: stripes while the element is in
      // the row (all S but in the last tile)
      const long long e0 = t * S * kThreads + c0 + tid;
      const long long left = (len - e0 + kThreads - 1) / kThreads;
      const int ns = left < S ? static_cast<int>(left) : S;
      // in batches of kSumBatch, each read into registers before the
      // previous batch's adds, so the reads run ahead of the chain
      T v0[kSumBatch], v1[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (u < ns) v0[u] = tile[u * cb];
#pragma unroll
      for (int b = 0; b < S; b += 2 * kSumBatch) {
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (b + kSumBatch + u < ns) v1[u] = tile[(b + kSumBatch + u) * cb];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (b + u < ns) acc = add_(acc, v0[u]);
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (b + 2 * kSumBatch + u < ns)
            v0[u] = tile[(b + 2 * kSumBatch + u) * cb];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (b + kSumBatch + u < ns) acc = add_(acc, v1[u]);
      }
    }
    // tile t + 1 is in place, and tile t's stage read before it refills
    __syncthreads();
  }
  if (tid < cb) part[tid] = acc;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  T* all = ring;  // free now: block 0 gathers the 256 lanes into it
  if (k == 0) all[tid] = *cluster.map_shared_rank(part + tid % cb, tid / cb);
  cluster.sync();  // every member's part is read before it exits
  if (k != 0) return;
  halve_lanes(all, out + row);
}

// Runs launch() on `device` and leaves the calling thread's current device
// as it found it.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch();
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

inline bool too_many(long long threads) {
  return (threads + kThreads - 1) / kThreads > 0x7fffffffll;
}

inline unsigned blocks_of(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// whether 16-byte copies reach every row of n elements from p: p 16-byte
// aligned and the rows whole chunks
template <typename T>
bool vec_ok(const T* p, long long n) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (n * static_cast<long long>(sizeof(T))) % 16 == 0;
}

// The card's SMs and its largest shared memory a block may opt into,
// queried once per device
cudaError_t card_of(int device, int* sms, int* smem_max) {
  static int sms_of[64] = {}, smem_of[64] = {};
  const int slot = device & 63;
  int v = __atomic_load_n(&sms_of[slot], __ATOMIC_ACQUIRE);
  if (v == 0) {
    int s = 0, m = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    __atomic_store_n(&smem_of[slot], m, __ATOMIC_RELEASE);
    __atomic_store_n(&sms_of[slot], s, __ATOMIC_RELEASE);
    v = s;
  }
  *sms = v;
  *smem_max = __atomic_load_n(&smem_of[slot], __ATOMIC_ACQUIRE);
  return cudaSuccess;
}

// A kernel's dynamic shared memory raised to the card's opt-in limit,
// once per device (the attribute is the context's), where a launch needs
// more than the default 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device,
                       unsigned long long* done) {
  int sms = 0, smem_max = 0;
  cudaError_t err = card_of(device, &sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  if (bytes > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  const unsigned long long bit = 1ull << (device & 63);
  if (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_max);
  if (err == cudaSuccess) __atomic_fetch_or(done, bit, __ATOMIC_RELEASE);
  return err;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// moment_fock_kernel<T, TS>, or with Wave moment_fock_wave_kernel<T, TS>
template <typename T, int TS, bool Wave>
auto fock_kernel() {
  if constexpr (Wave) {
    return moment_fock_wave_kernel<T, TS>;
  } else {
    return moment_fock_kernel<T, TS>;
  }
}

// blocks of fock_kernel<T, TS, Wave> an SM holds (its registers bind it),
// queried once per device; its shared memory allowed first where it needs
// more than the default
template <typename T, int TS, bool Wave>
cudaError_t fock_resident(size_t smem, int device, int* per_sm) {
  static unsigned long long done = 0;
  static int held[64] = {};
  cudaError_t err =
      allow_smem(fock_kernel<T, TS, Wave>(), smem, device, &done);
  if (err != cudaSuccess) return err;
  int* h = held + (device & 63);
  int v = __atomic_load_n(h, __ATOMIC_ACQUIRE);
  if (v == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, fock_kernel<T, TS, Wave>(), kFockThreads, smem);
    if (err != cudaSuccess) return err;
    v = v < 1 ? 1 : v;
    __atomic_store_n(h, v, __ATOMIC_RELEASE);
  }
  *per_sm = v;
  return cudaSuccess;
}

template <typename T, int TS, bool Wave>
cudaError_t launch_fock_as(const Fock<T>& p, long long blocks, size_t smem,
                           cudaStream_t stream) {
  const auto kernel = fock_kernel<T, TS, Wave>();
  kernel<<<static_cast<unsigned>(blocks), kFockThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// moment_fock's schedule (the bits do not depend on it): with `sym`, tiles
// of kFockSmallTile where n fits one (several fragments a block), else of
// kFockTile, the registers a thread may take capped (kFockWaveBlocks
// blocks an SM) where that and only that holds the grid in one wave (GFN2
// hexamers and dodecamers; where the batch fills the card the cap was
// measured slower); without `sym`, a thread an output
template <typename T>
cudaError_t launch_fock(Fock<T> p, int sym, int device,
                        cudaStream_t stream) {
  if (!sym) {
    const long long total = p.units * p.n * p.n;
    if (too_many(total)) return cudaErrorInvalidValue;
    moment_contract_kernel<T><<<blocks_of(total), kThreads, 0, stream>>>(
        p.v1, p.m1, p.d1, p.v2, p.m2, p.d2, p.out, total, p.n);
    return cudaGetLastError();
  }
  const int ts = p.n <= kFockSmallTile ? kFockSmallTile : kFockTile;
  p.nt = static_cast<int>(ceil_div(p.n, ts));
  p.pairs = p.nt * (p.nt + 1) / 2;
  p.units *= p.pairs;
  const long long blocks = ceil_div(p.units, kFockThreads / (ts * ts));
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0, smem_max = 0;
  if (ts == kFockSmallTile) {
    const size_t smem = fock_smem<T, kFockSmallTile>(p);
    cudaError_t err =
        fock_resident<T, kFockSmallTile, false>(smem, device, &per_sm);
    if (err != cudaSuccess) return err;
    return launch_fock_as<T, kFockSmallTile, false>(p, blocks, smem, stream);
  }
  const size_t smem = fock_smem<T, kFockTile>(p);
  cudaError_t err = card_of(device, &sms, &smem_max);
  if (err != cudaSuccess) return err;
  err = fock_resident<T, kFockTile, false>(smem, device, &per_sm);
  if (err != cudaSuccess) return err;
  if (blocks > static_cast<long long>(per_sm) * sms) {
    int capped = 0;
    err = fock_resident<T, kFockTile, true>(smem, device, &capped);
    if (err != cudaSuccess) return err;
    if (blocks <= static_cast<long long>(capped) * sms)
      return launch_fock_as<T, kFockTile, true>(p, blocks, smem, stream);
  }
  return launch_fock_as<T, kFockTile, false>(p, blocks, smem, stream);
}

template <typename T>
int moment_fock(const T* f, const T* v1, const T* m1, int d1, const T* v2,
                const T* m2, int d2, T* out, int batch, int n, int sym,
                int device, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (d1 < 1 || d2 < 0 || (d2 > 0 && (!v2 || !m2)) || (sym && !f))
    return static_cast<int>(cudaErrorInvalidValue);
  Fock<T> p = {};
  p.f = f;
  p.v1 = v1;
  p.m1 = m1;
  p.v2 = d2 > 0 ? v2 : nullptr;
  p.m2 = d2 > 0 ? m2 : nullptr;
  p.out = out;
  p.units = batch;
  p.n = n;
  p.d1 = d1;
  p.d2 = d2;
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device,
                   [&] { return launch_fock<T>(p, sym, device, st); });
}

// moment_rows' schedule at (batch, n, d) (the bits do not depend on it):
// - tiles of l: L = 16 up to 16 AOs, else 32;
// - bands: as many rows as a block's chains (kRowThreads / De) and two
//   staged tiles (kStageBytes) allow; where the batch gives fewer than two
//   blocks an SM, cut further, down to bands of kMinBand rows, and (with
//   an index) to at most kMaxCluster bands, a fragment's bands one
//   cluster; where the batch fills the card, a block takes all of its
//   fragment's bands in turn (no cluster);
// - a fragment in one band and a large batch: as many fragments a block
//   as give two blocks an SM, within the same limits;
// - stages: as many tiles in flight as kStageBytes holds, 2 to kMaxStages
//   where a block has more than one tile;
// - with an index, where a fragment's c and index would not fit the
//   card's shared memory (smem_max; many thousand AOs): no cluster, and
//   a block holds as many bands at a time as fit.
template <typename T, int L>
void rows_plan(Rows<T>& p, int sms, int smem_max) {
  using S = RowsSmem<T, L>;
  const int n = p.n;
  const long long target = 2ll * sms;
  p.De = p.d < kRowThreads ? p.d : kRowThreads;
  p.groups = static_cast<int>(ceil_div(p.d, p.De));
  const int nt = static_cast<int>(ceil_div(n, L));
  const long long per_row =
      static_cast<long long>(nt > 1 ? 2 : 1) * S::LD * sizeof(T) *
      (1 + p.De);
  long long rcap = kStageBytes / per_row;
  if (rcap > kRowThreads / p.De) rcap = kRowThreads / p.De;
  if (rcap < 1) rcap = 1;
  long long nb = ceil_div(n, rcap);
  const bool idle = p.batch * nb < target;
  if (idle) {
    long long spread = ceil_div(target, p.batch);
    const long long thin = ceil_div(n, p.seg ? kMinBand : kMinBandPlain);
    if (spread > thin) spread = thin;
    if (p.seg && spread > kMaxCluster) spread = kMaxCluster;
    if (spread > nb) nb = spread;
  }
  p.R = static_cast<int>(ceil_div(n, nb));
  p.nb = static_cast<int>(ceil_div(n, p.R));
  p.F = 1;
  if (p.nb == 1) {
    long long fit = rcap / n, want = ceil_div(p.batch, target);
    p.F = static_cast<int>(fit < want ? (fit < 1 ? 1 : fit) : want);
  }
  long long stages = kStageBytes / static_cast<long long>(S::tile(p));
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) stages = 2;
  // the tiles a block stages: its bands' (nbl of them in a cluster)
  auto set_stages = [&] {
    const long long items = static_cast<long long>(p.nbl) * nt;
    p.stages = static_cast<int>(items < stages ? items : stages);
  };
  p.C = p.seg && idle ? (p.nb < kMaxCluster ? p.nb : kMaxCluster) : 1;
  p.nbl = p.seg ? static_cast<int>(ceil_div(p.nb, p.C)) : 1;
  set_stages();
  if (!p.seg || S::bytes(p) <= static_cast<size_t>(smem_max)) return;
  p.C = 1;
  p.nbl = p.nb;
  set_stages();
  // a band's c, weights and index
  const long long band = static_cast<long long>(p.F) * p.R *
                         (p.De * sizeof(T) + sizeof(T) + sizeof(int));
  const long long room =
      smem_max - p.stages * static_cast<long long>(S::tile(p));
  const long long fit = room / band;
  p.nbl = static_cast<int>(fit < 1 ? 1 : fit < p.nb ? fit : p.nb);
}

// one launch of moment_rows_kernel<T, L, W> (a cluster of p.C blocks
// with W = Cluster), its shared memory allowed once per device
template <typename T, int L, Sums W>
cudaError_t launch_rows_as(const Rows<T>& p, long long blocks, int device,
                           cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = RowsSmem<T, L>::bytes(p);
  cudaError_t err =
      allow_smem(moment_rows_kernel<T, L, W>, smem, device, &done);
  if (err != cudaSuccess) return err;
  if constexpr (W != Sums::Cluster) {
    moment_rows_kernel<T, L, W><<<static_cast<unsigned>(blocks),
                                  kRowThreads, smem, stream>>>(p);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kRowThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, moment_rows_kernel<T, L, W>, p);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
}

template <typename T, int L>
cudaError_t launch_rows(Rows<T> p, int device, cudaStream_t stream) {
  int sms = 0, smem_max = 0;
  cudaError_t err = card_of(device, &sms, &smem_max);
  if (err != cudaSuccess) return err;
  rows_plan<T, L>(p, sms, smem_max);
  p.vec_a = vec_ok(p.a, p.n);
  p.vec_m = vec_ok(p.m, p.n);
  const long long blocks = ceil_div(p.batch, p.F) * p.groups *
                           (p.seg ? p.C : p.nb);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  if (!p.seg) return launch_rows_as<T, L, Sums::None>(p, blocks, device,
                                                      stream);
  if (p.C == 1) return launch_rows_as<T, L, Sums::Block>(p, blocks, device,
                                                         stream);
  return launch_rows_as<T, L, Sums::Cluster>(p, blocks, device, stream);
}

template <typename T>
int moment_rows(const T* a, const T* m, int d, const long long* seg,
                const T* w, int size, T* out, int batch, int n, int device,
                void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (d < 1 || (seg && size < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (seg && size == 0) return 0;
  Rows<T> p = {};
  p.a = a;
  p.m = m;
  p.seg = seg;
  p.w = seg ? w : nullptr;
  p.out = out;
  p.batch = batch;
  p.n = n;
  p.d = d;
  p.size = seg ? size : 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return n <= 16 ? launch_rows<T, 16>(p, device, st)
                   : launch_rows<T, 32>(p, device, st);
  });
}

// segment_sum's schedule (the bits do not depend on it): column bands of
// at most 64 whose staged values fit kStageBytes; segment bands where a
// fragment would give a lane group more than two segments; as many
// fragments a block as give two blocks an SM where a fragment gives its
// groups fewer than two segments each; a fragment's entries in runs of
// as many as fit the card's shared memory (smem_max) where all would not
// (then one fragment a block, lane groups)
template <typename T>
void segments_plan(Segments<T>& p, int sms, int smem_max) {
  const long long target = 2ll * sms;
  long long ce = kStageBytes / (static_cast<long long>(p.n > 0 ? p.n : 1) *
                                sizeof(T));
  if (ce > 64) ce = 64;
  if (ce < 1) ce = 1;
  p.bands_c = static_cast<int>(ceil_div(p.c, ce));
  p.Ce = static_cast<int>(ceil_div(p.c, p.bands_c));
  // an entry's staged value band, weight and index
  const long long entry =
      p.Ce * sizeof(T) + (p.w ? sizeof(T) : 0) + sizeof(int);
  const long long held = smem_max / entry;
  p.Kc = p.n <= held ? (p.n > 1 ? p.n : 1) : static_cast<int>(held);
  const bool runs = p.Kc < p.n;
  // segments a block sums at once: Ce threads or a group of
  // walk_lanes(Ce) lanes each
  p.scan = !runs && p.Ce <= kScanCols && p.batch >= target;
  const int at_once = kSegThreads / (p.scan ? p.Ce : walk_lanes(p.Ce));
  p.Sb = p.size < 2 * at_once ? p.size : 2 * at_once;
  p.bands_s = static_cast<int>(ceil_div(p.size, p.Sb));
  p.F = 1;
  if (!runs && p.bands_c == 1 && p.bands_s == 1) {
    long long fit = 2 * at_once / p.size;
    const long long by_smem =
        kStageBytes / (static_cast<long long>(p.n) * (p.Ce + 1) * sizeof(T) +
                       p.n * static_cast<long long>(sizeof(int)) + 1);
    if (fit > by_smem) fit = by_smem;
    const long long want = ceil_div(p.batch, target);
    p.F = static_cast<int>(fit < want ? (fit < 1 ? 1 : fit) : want);
  }
}

template <typename T>
int segment_sum(const T* v, const long long* seg, const T* w, int size,
                T* out, int batch, int n, int c, int device, void* stream) {
  if (batch <= 0 || size <= 0 || c <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long done[3] = {};
  Segments<T> p = {};
  p.v = v;
  p.seg = seg;
  p.w = w;
  p.out = out;
  p.batch = batch;
  p.n = n;
  p.c = c;
  p.size = size;
  return on_device(device, [&] {
    int sms = 0, smem_max = 0;
    cudaError_t err = card_of(device, &sms, &smem_max);
    if (err != cudaSuccess) return err;
    segments_plan(p, sms, smem_max);
    const long long blocks =
        ceil_div(p.batch, p.F) * p.bands_c * p.bands_s;
    if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
    const size_t smem = Segments<T>::bytes_of(p);
    // the ways apart, each with its own registers
    const int way = p.Kc < p.n ? 2 : p.scan ? 1 : 0;
    auto kernel = way == 2   ? segment_sum_kernel<T, false, true>
                  : way == 1 ? segment_sum_kernel<T, true, false>
                             : segment_sum_kernel<T, false, false>;
    err = allow_smem(kernel, smem, device, &done[way]);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), kSegThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
  });
}

// one launch of row_sum_group_kernel<T, W, RPG> over `rows` rows
template <typename T, int W, int RPG>
cudaError_t launch_row_group(const T* x, T* out, long long rows,
                             long long len, cudaStream_t stream) {
  const long long rows_a_block = kThreads / W * RPG;
  const long long blocks = ceil_div(rows, rows_a_block);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  row_sum_group_kernel<T, W, RPG><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(x, out, rows, len);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_row_group(const T* x, T* out, long long rows,
                             long long len, int sms, cudaStream_t stream) {
  // four rows a group where there are at least four warps' worth of
  // groups for each of 32 warps an SM
  if (rows * W >= 4ll * kWarp * kWarp * sms)
    return launch_row_group<T, W, 4>(x, out, rows, len, stream);
  return launch_row_group<T, W, 1>(x, out, rows, len, stream);
}

// the launch configuration of row_sum_cluster_kernel<T, K> over `rows`
// rows: a cluster of K blocks a row
template <typename T, int K>
cudaLaunchConfig_t row_cluster_cfg(long long rows, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * K));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (kSumStages * kSumTile + kThreads) * sizeof(T);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// row_sum_cluster_kernel<T, K>'s shared memory raised and, above the
// portable cluster size, clusters of K allowed, once per device
template <typename T, int K>
cudaError_t allow_row_cluster(int device) {
  static unsigned long long done = 0, wide = 0;
  const size_t smem = (kSumStages * kSumTile + kThreads) * sizeof(T);
  cudaError_t err =
      allow_smem(row_sum_cluster_kernel<T, K>, smem, device, &done);
  if (err != cudaSuccess || K <= 8) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (__atomic_load_n(&wide, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(row_sum_cluster_kernel<T, K>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess) __atomic_fetch_or(&wide, bit, __ATOMIC_RELEASE);
  return err;
}

// the largest cluster a row takes on this card: kMaxSumCluster where the
// card can hold one such cluster of row_sum_cluster_kernel<T, K>, else
// the portable 8; queried once per device
template <typename T>
cudaError_t row_cluster_cap(int device, int* cap) {
  static int cap_of[64] = {};
  int* held = cap_of + (device & 63);
  int v = __atomic_load_n(held, __ATOMIC_ACQUIRE);
  if (v == 0) {
    cudaError_t err = allow_row_cluster<T, kMaxSumCluster>(device);
    int clusters = 0;
    if (err == cudaSuccess) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg =
          row_cluster_cfg<T, kMaxSumCluster>(1, nullptr, attr);
      err = cudaOccupancyMaxActiveClusters(
          &clusters, row_sum_cluster_kernel<T, kMaxSumCluster>, &cfg);
    }
    if (err != cudaSuccess) cudaGetLastError();  // a refusal: keep 8
    v = err == cudaSuccess && clusters > 0 ? kMaxSumCluster : 8;
    __atomic_store_n(held, v, __ATOMIC_RELEASE);
  }
  *cap = v;
  return cudaSuccess;
}

// one launch of row_sum_cluster_kernel<T, K>: a cluster of K blocks a row
template <typename T, int K>
cudaError_t launch_row_cluster(const T* x, T* out, long long rows,
                               long long len, int vec, int device,
                               cudaStream_t stream) {
  cudaError_t err = allow_row_cluster<T, K>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = row_cluster_cfg<T, K>(rows, stream, attr);
  err = cudaLaunchKernelEx(&cfg, row_sum_cluster_kernel<T, K>, x, out, len,
                           vec);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
int fragment_sum(const T* x, T* out, long long rows, long long len,
                 int device, void* stream) {
  if (rows <= 0) return 0;
  if (len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    int sms = 0, smem_max = 0;
    cudaError_t err = card_of(device, &sms, &smem_max);
    if (err != cudaSuccess) return err;
    if (len <= kWarpRowMax) {
      if (len > kGroupRowMax) {
        const long long threads = rows * kWarp;
        if (too_many(threads)) return cudaErrorInvalidValue;
        row_sum_warp_kernel<T><<<blocks_of(threads), kThreads, 0, st>>>(
            x, out, rows, len);
        return cudaGetLastError();
      }
      if (len > 16) return launch_row_group<T, 32>(x, out, rows, len, sms, st);
      if (len > 8) return launch_row_group<T, 16>(x, out, rows, len, sms, st);
      if (len > 4) return launch_row_group<T, 8>(x, out, rows, len, sms, st);
      return launch_row_group<T, 4>(x, out, rows, len, sms, st);
    }
    // a cluster of K blocks a row where the rows leave SMs idle (fewer
    // than two blocks an SM) and the row is long enough (kSumMinBytes a
    // block), K a power of two up to kMaxSumCluster; else a block a row
    int cap = 0;
    err = row_cluster_cap<T>(device, &cap);
    if (err != cudaSuccess) return err;
    const long long bytes = len * static_cast<long long>(sizeof(T));
    const long long least =
        sizeof(T) == 8 ? kSumClusterLen64 : kSumClusterLen32;
    int K = 1;
    while (len >= least && K < cap && rows * K * 2 <= 2ll * sms &&
           bytes >= 2ll * K * kSumMinBytes)
      K *= 2;
    if (rows * K > 0x7fffffffll) return cudaErrorInvalidValue;
    if (K == 1) {
      row_sum_block_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0,
                                st>>>(x, out, len);
      return cudaGetLastError();
    }
    const int vec = vec_ok(x, len) ? 1 : 0;
    if (K == 2) return launch_row_cluster<T, 2>(x, out, rows, len, vec,
                                                device, st);
    if (K == 4) return launch_row_cluster<T, 4>(x, out, rows, len, vec,
                                                device, st);
    if (K == 8) return launch_row_cluster<T, 8>(x, out, rows, len, vec,
                                                device, st);
    return launch_row_cluster<T, 16>(x, out, rows, len, vec, device, st);
  });
}

}  // namespace

extern "C" {

// f, out: (batch, n, n); v1: (batch, n, d1), m1: (batch, d1, n, n); v2, m2
// likewise with d2 (d2 = 0: none, v2 and m2 may be null); sym = 0: out =
// g and f may be null
int mqc_moment_fock_f32(const float* f, const float* v1, const float* m1,
                        int d1, const float* v2, const float* m2, int d2,
                        float* out, int batch, int n, int sym, int device,
                        void* stream) {
  return moment_fock<float>(f, v1, m1, d1, v2, m2, d2, out, batch, n, sym,
                            device, stream);
}

int mqc_moment_fock_f64(const double* f, const double* v1, const double* m1,
                        int d1, const double* v2, const double* m2, int d2,
                        double* out, int batch, int n, int sym, int device,
                        void* stream) {
  return moment_fock<double>(f, v1, m1, d1, v2, m2, d2, out, batch, n, sym,
                             device, stream);
}

// a: (batch, n, n), m: (batch, d, n, n); seg null: out (batch, n, d); else
// seg (batch, n), w (batch, n) or null, out (batch, size, d)
int mqc_moment_rows_f32(const float* a, const float* m, int d,
                        const long long* seg, const float* w, int size,
                        float* out, int batch, int n, int device,
                        void* stream) {
  return moment_rows<float>(a, m, d, seg, w, size, out, batch, n, device,
                            stream);
}

int mqc_moment_rows_f64(const double* a, const double* m, int d,
                        const long long* seg, const double* w, int size,
                        double* out, int batch, int n, int device,
                        void* stream) {
  return moment_rows<double>(a, m, d, seg, w, size, out, batch, n, device,
                             stream);
}

// v: (batch, n, c), seg: (batch, n), w: (batch, n) or null; out: (batch,
// size, c)
int mqc_segment_sum_f32(const float* v, const long long* seg, const float* w,
                        int size, float* out, int batch, int n, int c,
                        int device, void* stream) {
  return segment_sum<float>(v, seg, w, size, out, batch, n, c, device,
                            stream);
}

int mqc_segment_sum_f64(const double* v, const long long* seg,
                        const double* w, int size, double* out, int batch,
                        int n, int c, int device, void* stream) {
  return segment_sum<double>(v, seg, w, size, out, batch, n, c, device,
                             stream);
}

// x: (rows, len), out: (rows)
int mqc_fragment_sum_f32(const float* x, float* out, long long rows,
                         long long len, int device, void* stream) {
  return fragment_sum<float>(x, out, rows, len, device, stream);
}

int mqc_fragment_sum_f64(const double* x, double* out, long long rows,
                         long long len, int device, void* stream) {
  return fragment_sum<double>(x, out, rows, len, device, stream);
}

const char* mqc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
