// Batched products of small per-fragment matrices whose bits do not depend
// on the batch.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// (metalquicha_tpu/methods/xtb/engine.py:443-453, the orthogonalizer and
// the Fock transforms; :758-760 and :780-781 on the fast in-loop route).
// The port's torch.matmul sends a batch of (n, n) products to cuBLAS,
// which picks its batched kernel, and with it the order of each dot
// product's sum, by the batch count: the same fragment gave other bits in
// a batch of 95 than of 190, and the eigh amplified the last bit into the
// gradient (ROADMAP C17). Here each output element is reduced over k in
// one fixed order that depends on the operands' sizes only, so a
// fragment's bits are the same whatever the batch count and whatever its
// place in the batch.
//
// Entries (f32 and f64; each operand one fragment after the other, a
// fragment's matrix contiguous):
// - bmm: C = op(A) op(B), op(A) (m, k), op(B) (k, n), where op
//   transposes a matrix stored the other way round; any sizes (the
//   wrapper takes m and n up to 256 and k of any length; the backward
//   pass of such a product has the long k as its m or n);
// - sandwich: C = (X F) X + S for (n, n) X, F, S, n <= 64, in one launch,
//   X F kept in shared memory (above 64 the wrapper runs two products and
//   an add, with the same roundings);
// - matvec: y = op(M) x for op(M) (rows, cols), rows, cols <= 256.
//
// Arithmetic (the same bits as the first version of this kernel, which
// took sizes up to 64):
// - f64 on the FP64 tensor cores (mma.sync m8n8k4): each 8 x 8 output
//   tile accumulates over k in ascending blocks of 4, the operands padded
//   with zeros to a multiple of 8 in shared memory (a zero block adds
//   exact zeros);
// - f32 by FFMA, one chain per element in ascending k from 0 (no TF32,
//   which would keep 10 bits of the mantissa);
// - S is added to the rounded product, as torch's `a @ b + s` rounds; the
//   sandwich's X F is rounded to T in shared memory first.
// - the matvec: each output by FMA in ascending k from 0 (`__fma_rn`,
//   `__fmaf_rn`), in both forms.
// Where every size is 8 or less (the products of D3's C6 backward), a
// thread per output element by FMA in ascending k from global memory (the
// direct kernel).
// - pair_bilinear: c[b, i, j] = sum_c (sum_a w[b, i, a] G[b, i, j, a, c])
//   w[b, j, c], D3's C6 from each pair's (5, 5) reference grid, on a
//   kernel of its own (`pair_bilinear_kernel`, design below).
//
// What bounds it. At the main path's shapes ((512, 16) to (5985, 32) and
// (128, 64)) a product is 2 n^3 operations over 3 n^2 elements moved:
// 10.7 operations a byte at n = 64 in f64, under the card's ridge (20 at
// 67 TFLOP/s and 3.35 TB/s), so the bound is the bytes. Every launch is
// short (a few microseconds), so what counts is how soon the loads start
// on every SM and how few instructions bring an operand to the
// arithmetic. The design, against the first version's five limits (each
// choice measured on the card against its alternatives, `Cfg`):
// 1. Persistent blocks: the grid is min(work units, SMs x resident
//    blocks), the resident count from the occupancy query once per device
//    and size class; a block walks its units with the grid's stride, so
//    no last wave runs partly filled (a grid of one block a unit lost
//    6-16% at 32). f32 runs a two-stage ring: a block issues the next
//    unit's copies (cp.async, one group a unit) into the other stage
//    before it computes the current one (wait_group 1), so loads and
//    arithmetic overlap inside a block (three or four stages gained
//    nothing). f64 stages one unit at a time: its operands are twice the
//    bytes, and more resident blocks (its registers capped at 64 a thread
//    at 32, eight blocks an SM) kept more bytes in flight than a second
//    stage did (the sandwich 4-9% faster at 32 and 64, the product level).
// 2. Work units: a fragment at classes 16 and 32 (f64: a warp a tile at
//    16, a warp a 2 x 2 group of tiles at 32; f32: 64 threads at 16),
//    (fragment, band of 32 rows) at 64: (128, 64) is 256 units for 132
//    SMs instead of 128 blocks, op(B) read again from L2 (bands of 16
//    rows made the f64 product L2-bound). A band reduces each element
//    exactly as the whole tile does. The sandwich's unit stays a whole
//    fragment (a band of (X F) X needs all of X F). Above 64: the tiled
//    class below.
// 3. Staging by 16-byte cp.async.cg wherever the operand's base address
//    and stored row length allow it (checked in the C entry, per
//    operand), a power-of-two count of lanes a row (no index division).
//    f32 rows are not padded but their 16-byte chunks XOR-swizzled
//    (`sidx`), so the copies and the float4 reads are free of bank
//    conflicts; f64 rows keep their padding of 4 (32 bytes, so still
//    16-byte aligned), which leaves the fragment loads' addresses a base
//    plus k (an XOR a load cost the f64 product 1-13% of its time, the
//    sandwich at 64 a third). An operand that
//    is not aligned (f64 rows of odd length, a view with a storage offset)
//    is copied element by element by the same kernel into the same
//    layout: the same bits.
// 4. f32 reads 16 bytes at a time: a thread holds a 4 x 4 tile of
//    contiguous rows and columns (1 x 4 at class 16) and takes k in blocks
//    of 4, reading op(A) and op(B) as float4 (LDS.128) along whichever
//    axis the stored layout makes contiguous: 8 loads feed 64 FFMAs, where
//    6 fed 8 before. f64 keeps its scalar fragment loads (loading the next
//    k block's fragments ahead in registers gained nothing).
// 5. Stores of 16 bytes (double2, float4) where n and the output's base
//    allow them, scalar otherwise.
//
// The tiled class (any size above 64: fragments above 64 AOs, up to 256,
// SP2's products, CPCM's (nat, points) by (points, nat) and its backward's
// (points, nat) by (nat, nat)). What bounds it: the wide squares ((41,
// 241), (64, 256)) are 2 n^3 operations over 3 n^2 elements, 30 a byte in
// f64, above the ridge: the FP64 tensor rate (0.017 ms at (41, 241)); a
// small batch ((3, 128): 48 units of 32 x 32 at most) fills a third of the
// SMs, and a unit's k tiles are a chain; CPCM's (6, 660) by (660, 6) is 12
// MB across the batch, but a fragment's 165 blocks of 4 are one chain of
// dependent mmas behind its staging, so its time is the same at 19
// fragments as at 190; its backward's (660, 6) by (6, 6) is bytes. The
// first version's schedule (a unit of 32 rows by 128 columns whatever the
// shape, two barriers a k tile, a warp's 2 x 2 groups of tiles one after
// the other through a runtime transpose branch, f64 odd rows copied an
// element a copy) ran 2.4-5.2x cuBLAS's time in f64; this one 0.8-2.3x
// (0.0865 ms at (41, 241), 20% of the bound; 0.0981 at (64, 256), 33%;
// CPCM's product 0.013, its backward 0.010, cuBLAS's 0.012-0.013). The
// design (each choice measured on the card against its alternatives in
// one process tree; the times below `tools/tiled_variants_torch.py`'s, the
// alternative a constant of this source set otherwise; H100 80GB HBM3 at
// 700 W):
// 1. A plan by shape and batch (`tiled_shape`, units below), so that a
//    small batch still spreads over the card and a narrow operand stages
//    no padding: CPCM's backward in 64 x 8 units, 3.0x faster than the
//    first version's 32 x 128; 16 x 16 small units (kSmallBand = 16) were
//    faster at (3, 128) (0.0078 ms against 0.0089) and slower at (16, 96)
//    (0.0090 against 0.0079).
// 2. A ring of stages (two for wide units, three otherwise) with one
//    barrier a k tile: the copies of the tile S - 1 ahead issued right
//    after the barrier that frees its stage (three stages for f64 wide
//    units leave two blocks an SM where two leave three: (41, 241) 0.108
//    ms against 0.087).
// 3. f64: a warp's 4 x 4 (wide) or 2 x 2 (small) tiles with every
//    accumulator live, pairs of 8 x 8 tiles one m16n8k4 (the same sums as
//    m8n8k4: every fingerprint equal; faster at 241-256 than m8n8k4 in an
//    edited copy of this source; m16n8k8 kept the bits too on the timed
//    cases and was no faster), the fragments' addresses compile-time
//    offsets of one base a lane (one instantiation a layout, no transpose
//    branch).
// 4. f64 rows that are not 16-byte aligned (odd n: the peptide's 241; a
//    view with a storage offset) staged in 16-byte pieces all the same,
//    each stored row shifted by the parity of its address, which the
//    fragment loads add back (an element a copy, as the first version
//    did, was slower at 241 than at 240): staged rows of kBulkRow elements
//    or more by the tensor memory accelerator's bulk copies, a row's
//    aligned pairs a copy on the stage's mbarrier and an odd end element
//    by cp.async (`stage_bulk`; none, kBulkRow = 1024: (41, 241) with
//    op(A) stored (k, m) 0.095 ms against 0.076), shorter ones by 16-byte
//    cp.async (`stage_pairs`; bulk copies of short rows, kBulkRow = 8,
//    were slower: CPCM's (7, 660) 0.051 against 0.018, (16, 97) 0.0137
//    against 0.0119).
// 5. More threads than the tiles need where the unit is narrow
//    (kTiledMinThreads): staging, not the chain, set CPCM's time (one warp
//    staging, kTiledMinThreads = 32: 0.024 ms at (190, 6, 660, 6) against
//    0.013 with four).
// f32 keeps a thread's TM x 4 tile (8 x 8 tiles, in an edited copy of this
// source, lost at 256); its odd rows are still copied an element a copy (a
// shifted row cannot be read by float4).
//
// The matvec (the Coulomb potential v = gamma q at the shell count, once
// or twice an SCC iteration; its transposed form in every gradient). Its
// first version ran on the direct kernel: a thread an output row reading
// its row of M from global memory (32 rows k elements apart a warp's
// load, uncoalesced), B x rows threads (384 at (3, 128), on 2 of 132 SMs),
// each a chain of k FMAs behind its loads: 5.0x torch.matmul's time at
// (3, 128). What bounds it: the bytes of M (B n^2 elements, 2 operations
// each) where the batch fills the card; where it does not, the chain
// itself, k dependent FMAs each waiting on the last (the floor at (3,
// 128) and (16, 96) that no schedule with these bits cuts), after one
// round trip for the operands. It has a kernel of its own
// (`matvec_kernel`, 128 threads a block, a thread a chain):
// - units (`mv_plan`): whole fragments, as many a unit as leave two units
//   an SM (several a block at n <= 32); where the batch leaves SMs idle
//   (fewer fragments than two an SM: (3, 128), (16, 96), (128, 64), (64,
//   36)), a fragment's rows in bands of at least kMvMinBand, so a small
//   batch spreads over the card;
// - staged units: the unit's rows of op(M) (plain: rows of M, contiguous
//   across whole fragments; transposed: a band of columns of each stored
//   row) and its fragments' x are copied into shared memory by 16-byte
//   cp.async.cg where the base and the stored row length allow it (an
//   element a copy otherwise: odd n, offset views), a power-of-two count
//   of lanes a row; blocks walk the units with the grid's stride (the
//   grid what the card holds at once), the next unit's copies issued
//   into the other of two stages before this unit's chains run. Plain
//   rows are padded to an odd number of 16-byte chunks, so a thread's
//   16-byte reads of its row and its neighbours' fall on distinct banks;
//   the transposed band is read by column, consecutive threads on
//   consecutive columns;
// - in place: whole fragments in the transposed form, and in the plain
//   form where a row is short (kMvInPlaceRow32 / 64 bytes), read M and x
//   where they lie, a thread an output of the batch: consecutive threads
//   read consecutive columns of M's row q in the transposed form
//   (coalesced; staging them was measured slower where the batch fills
//   the card), a plain row of up to 96 (f32) or 64 (f64) bytes is a few
//   sectors a thread, read 16 bytes at a time where aligned;
// - the chain reads its operands into registers kMvBatch columns at a
//   time, the next batch before this batch's FMAs, so the reads run
//   ahead of the dependent FMAs.
// A fragment's outputs are the same chains whatever the unit, so its bits
// do not depend on the batch.
//
// The pair contraction (`pair_bilinear`, D3's C6 twice a functional; its
// backward runs on the direct kernel and the fragment sums). Its first
// form was four launches: w expanded and copied to (B, nat, nat, 1, R),
// the direct kernel (a thread an output reading its (R, R) grid 25
// elements apart from its neighbours', uncoalesced) writing v (B, nat,
// nat, R) to memory, torch's multiply by w[j] and torch's sum over R
// (29% of the bound at (41, 73)). What bounds it: the grids' bytes, read
// once (43.7 MB at (41, 73), 0.013 ms); where the batch is small, one
// launch. Now one launch: a block takes 128 consecutive pairs of the
// flattened batch (measured against 64 and 32), whose grids are one
// contiguous run,
// staged by 16-byte cp.async.cg (an element a copy where the base is not
// 16-byte aligned, and at the array's end); a thread a pair reads its
// rows w[i] and w[j] through the read-only cache while the grids land (a
// run of pairs crosses fragments, so w is not staged: its few KB stay in
// L1), then forms v[c] by FMA over a ascending from +0, the products v[c]
// w[j, c] rounded, and their sum in the association of torch's sum over
// a short row (`pair_sum`), and stores c coalesced. Nothing of size (B,
// nat, nat, R) reaches memory. The bits are those of the four launches
// (the fingerprints of their card output).
// The kernel launches on the caller's stream, allocates nothing, never
// synchronizes, and the C entry points return cudaGetLastError() after
// the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
// the largest rows and columns the matvec takes (a product takes any
// size in its tiled class; the sandwich up to kStagedN)
constexpr int kMaxN = 256;
// the largest size whose operands are staged whole (size classes 16, 32,
// 64); above, the tiled kernel streams k
constexpr int kStagedN = 64;
// products with every size up to this take the direct kernel
constexpr int kTiny = 8;
// the reference grids of a pair of the pair contraction (D3's MAX_REFS),
// and the pairs (threads) a block of its kernel takes
constexpr int kPairR = 5;
constexpr int kPairThreads = 128;
// rows of op(A) a unit computes at class 64 (`Cfg`)
constexpr int kBand64 = 32;
constexpr int kStaticSmem = 48 * 1024;
// the most units a launch takes: a block's walk stays in int range
constexpr long long kMaxUnits = (1ll << 31) / 8;
// the bits of a launch's flags
constexpr int kTransA = 1, kTransB = 2, kVecA = 4, kVecB = 8, kVecC = 16;
// the matvec: a block's most chains (threads), fewest threads, the
// columns of op(M) a group of copies stages, the fewest rows of a band
// where a small batch is cut into bands, and the most shared memory a
// block stages (no opt-in)
constexpr int kMvThreads = 128;
constexpr int kMvTileK = 32;
constexpr int kMvMinBand = 8;
// columns of op(M) a thread reads into registers at a time
constexpr int kMvBatch = 8;
constexpr int kMvStage = 24 * 1024;
// whole fragments in the plain form are read in place where a row of M
// is at most this many bytes (f32, f64), staged above (measured on the
// card: in place won at 96 bytes a row in f32, staging at 128 bytes in
// both)
constexpr int kMvInPlaceRow32 = 96;
constexpr int kMvInPlaceRow64 = 64;

// The work of one unit, by element type and size class N (the bits do
// not depend on these; the values are the fastest of those measured on
// the card):
// - kBand: rows of op(A) a unit computes, the whole tile at 16 and 32, a
//   band of kBand64 rows at 64 (16 made the f64 product L2-bound);
// - f32: TM x 4 outputs a thread (TM = 1 at 16, where a thread of two
//   rows lost, else 4), a thread per TM x 4 outputs of the unit;
// - f64: a warp per G x G group of 8 x 8 tiles (G = 1 at 16: four warps a
//   fragment beat one), 128 threads at 16 and 32, 256 at 64;
// - stages of the ring: 2 in f32, 1 in f64, whose registers are capped
//   for eight blocks an SM at 32 (more resident blocks kept more bytes in
//   flight than a second stage did).
template <typename T, int N>
struct Cfg {
  static constexpr bool kF64 = sizeof(T) == 8;
  static constexpr int kBand = N == 64 ? kBand64 : N;
  static constexpr int TM = N == 16 ? 1 : 4;
  static constexpr int G = N == 16 ? 1 : 2;
  static constexpr int kThreads =
      kF64 ? (N == 64 ? 256 : 128) : (kBand / TM) * (N / 4);
  static constexpr int kSandwichThreads =
      kF64 ? kThreads : (N / TM) * (N / 4);
  static constexpr int kStages = kF64 ? 1 : 2;
  static constexpr int kMinBlocks = kF64 && N == 32 ? 8 : 1;
  // staged rows: f64 padded by 4 (32 bytes: rows stay 16-byte aligned, and
  // an m8n8k4 operand's 8 rows x 4 columns fall on distinct banks in each
  // half-warp); f32 unpadded, its 16-byte chunks swizzled (`sidx`)
  static constexpr int kPad = kF64 ? 4 : 0;
  static constexpr int kLd = N + kPad, kLdBand = kBand + kPad;
  // elements a stage holds: op(A)'s band, stored either way, then op(B)
  static constexpr int kA =
      kBand * kLd > N * kLdBand ? kBand * kLd : N * kLdBand;
  static constexpr int kStage = kA + N * kLd;
  // the sandwich's X, F and X F
  static constexpr int kMat = N * kLd;
};

// Element index of (r, c) in a staged matrix with rows of ld elements.
// f64: rows padded (Cfg::kPad), no swizzle, so a fragment load's address
// is a base plus k (design point 3). f32: the 16-byte chunks of row r
// XOR-swizzled so that the warp's copies and its float4 loads (rows 4
// apart, or 8 chunks of one row) fall on distinct banks.
template <typename T>
__device__ __forceinline__ int sidx(int r, int c, int ld) {
  if (sizeof(T) == 8) return r * ld + c;
  const int s = ld >= 32 ? (r >> 2) & 7 : ((r >> 1) ^ (r >> 3)) & 3;
  return r * ld + (c ^ (s << 2));
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

__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
// a product and a sum rounded each on its own (no FMA contraction)
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// lanes a row of `n` items: the next power of two, 2 to 32 (shifts and
// masks, no index division)
__device__ __forceinline__ int row_shift(int n) {
  return n <= 2 ? 1 : n <= 4 ? 2 : n <= 8 ? 3 : n <= 16 ? 4 : 5;
}

// Issue the copies of a stored (rows, cols) block at g (row stride gs)
// into s (rows of ld elements, swizzled) and zero its padding up to the
// next multiples of 8, lanes a padded row as it is long: 16-byte copies
// (and zeros) where vec (g 16-byte aligned, gs a whole number of chunks)
// and the rows are whole chunks, else a copy an element.
template <typename T>
__device__ __forceinline__ void stage(T* s, int ld, const T* g, long long gs,
                                      int rows, int cols, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int pr = (rows + 7) & ~7, pc = (cols + 7) & ~7;
  if (vec && cols % E == 0) {
    const int cpr = pc / E;
    const int shift = row_shift(cpr);
    const int lane = threadIdx.x & ((1 << shift) - 1);
    for (int i = threadIdx.x >> shift; i < pr; i += blockDim.x >> shift) {
      const T* gi = g + i * gs;
      for (int j = lane * E; j < pc; j += E << shift) {
        T* dst = s + sidx<T>(i, j, ld);
        if (i < rows && j < cols) {
          cp_async16(dst, gi + j);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    return;
  }
  const int shift = row_shift(pc);
  const int lane = threadIdx.x & ((1 << shift) - 1);
  for (int i = threadIdx.x >> shift; i < pr; i += blockDim.x >> shift) {
    const T* gi = g + i * gs;
    for (int j = lane; j < pc; j += 1 << shift) {
      if (i < rows && j < cols) {
        cp_async(s + sidx<T>(i, j, ld), gi + j);
      } else {
        s[sidx<T>(i, j, ld)] = T(0);
      }
    }
  }
}

// op(X)[r][c] of a matrix staged as it is stored
template <typename T>
struct Op {
  const T* s;
  int ld;
  bool trans;
  __device__ __forceinline__ T operator()(int r, int c) const {
    return trans ? s[sidx<T>(c, r, ld)] : s[sidx<T>(r, c, ld)];
  }
};

// A warp's G x G group of 8 x 8 tiles at tile (ti0, tj0) of op(A) op(B)
// (ti_n x tj_n tiles): a tile past the last (warp-uniform) runs no mma
template <int G>
struct Group {
  int ti0, tj0;
  bool row_ok[G], col_ok[G];
  __device__ __forceinline__ Group(int group, int ti_n, int tj_n) {
    const int gj_n = (tj_n + G - 1) / G;
    ti0 = (group / gj_n) * G;
    tj0 = (group % gj_n) * G;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      row_ok[u] = ti0 + u < ti_n;
      col_ok[u] = tj0 + u < tj_n;
    }
  }
  // d += op(A)[rows][0, kpad) op(B)[0, kpad)[cols], in ascending blocks
  // of 4
  __device__ __forceinline__ void accumulate(Op<double> a, Op<double> b,
                                             int kpad, double (&d)[G][G][2])
      const {
    const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
    double av[G], bv[G];
    for (int k0 = 0; k0 < kpad; k0 += 4) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        av[u] = row_ok[u] ? a((ti0 + u) * 8 + g, k0 + t) : 0.0;
        bv[u] = col_ok[u] ? b(k0 + t, (tj0 + u) * 8 + g) : 0.0;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
#pragma unroll
        for (int v = 0; v < G; ++v) {
          if (!(row_ok[u] && col_ok[v])) continue;
          asm volatile(
              "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, "
              "{%2}, {%3}, {%0, %1};\n"
              : "+d"(d[u][v][0]), "+d"(d[u][v][1])
              : "d"(av[u]), "d"(bv[v]));
        }
      }
    }
  }
  // sink(i, j, v0, v1) for the outputs (i, j) and (i, j + 1) of every
  // tile of the group (i and j may reach the next multiple of 8; j even)
  template <typename Sink>
  __device__ __forceinline__ void drain(const double (&d)[G][G][2],
                                        Sink sink) const {
    const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int u = 0; u < G; ++u) {
#pragma unroll
      for (int v = 0; v < G; ++v) {
        if (!(row_ok[u] && col_ok[v])) continue;
        sink((ti0 + u) * 8 + g, (tj0 + v) * 8 + 2 * t, d[u][v][0],
             d[u][v][1]);
      }
    }
  }
};

// f64: op(A) op(B), (m, k) by (k, n), on the tensor cores: the warps take
// G x G groups of 8 x 8 tiles in turn; sink(i, j, v0, v1) for the
// outputs (i, j) and (i, j + 1) of every padded tile (i and j may reach
// the next multiple of 8; j even)
template <int G, typename Sink>
__device__ __forceinline__ void product(Op<double> a, Op<double> b, int m,
                                        int n, int k, Sink sink) {
  const int warp = threadIdx.x / kWarp, warps = blockDim.x / kWarp;
  const int ti_n = (m + 7) / 8, tj_n = (n + 7) / 8, kpad = (k + 3) & ~3;
  const int groups = ((ti_n + G - 1) / G) * ((tj_n + G - 1) / G);
  for (int group = warp; group < groups; group += warps) {
    const Group<G> grp(group, ti_n, tj_n);
    double d[G][G][2] = {};
    grp.accumulate(a, b, kpad, d);
    grp.drain(d, sink);
  }
}

__device__ __forceinline__ float4 lds4(const float* s, int r, int c,
                                       int ld) {
  return *reinterpret_cast<const float4*>(s + sidx<float>(r, c, ld));
}

// f32: op(A) op(B) for the thread's TM x 4 outputs, rows i0.. and columns
// j0.. (i0 < m, j0 < n), each by FFMA in ascending k from 0; k in blocks
// of 4, op(A) and op(B) read 16 bytes at a time along the stored rows
// (TA: A stored (k, m); TB: B stored (n, k)); sink(acc)
template <int TM, bool TA, bool TB>
__device__ __forceinline__ void accumulate_f32(const float* as, int lda,
                                               const float* bs, int ldb,
                                               int k, int i0, int j0,
                                               float (&acc)[TM][4]) {
  auto block = [&](int k0, int kk) {
    float av[TM][4], bv[4][4];  // av[r][q] = op(A)[i0 + r][k0 + q]
    if constexpr (TA && TM == 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) av[0][q] = as[sidx<float>(k0 + q, i0, lda)];
    } else if constexpr (!TA) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 v = lds4(as, i0 + r, k0, lda);
        av[r][0] = v.x, av[r][1] = v.y, av[r][2] = v.z, av[r][3] = v.w;
      }
    } else {
      static_assert(TM == 4, "op(A) stored (k, m) takes 1 or 4 rows");
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = lds4(as, k0 + q, i0, lda);
        av[0][q] = v.x, av[1][q] = v.y, av[2][q] = v.z, av[3][q] = v.w;
      }
    }
    if constexpr (!TB) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = lds4(bs, k0 + q, j0, ldb);
        bv[q][0] = v.x, bv[q][1] = v.y, bv[q][2] = v.z, bv[q][3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v = lds4(bs, j0 + c, k0, ldb);
        bv[0][c] = v.x, bv[1][c] = v.y, bv[2][c] = v.z, bv[3][c] = v.w;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= kk) break;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fma_(av[r][q], bv[q][c], acc[r][c]);
      }
    }
  };
  const int k4 = k & ~3;
  for (int k0 = 0; k0 < k4; k0 += 4) block(k0, 4);
  if (k4 < k) block(k4, k - k4);
}

// the same with the transposes as arguments
template <int TM>
__device__ __forceinline__ void accumulate_f32_op(const float* as, int lda,
                                                  bool ta, const float* bs,
                                                  int ldb, bool tb, int k,
                                                  int i0, int j0,
                                                  float (&acc)[TM][4]) {
  if (ta) {
    if (tb)
      accumulate_f32<TM, true, true>(as, lda, bs, ldb, k, i0, j0, acc);
    else
      accumulate_f32<TM, true, false>(as, lda, bs, ldb, k, i0, j0, acc);
  } else {
    if (tb)
      accumulate_f32<TM, false, true>(as, lda, bs, ldb, k, i0, j0, acc);
    else
      accumulate_f32<TM, false, false>(as, lda, bs, ldb, k, i0, j0, acc);
  }
}

// the f32 product of k terms from 0 for the thread's TM x 4 outputs, then
// sink(acc)
template <int TM, bool TA, bool TB, typename Sink>
__device__ __forceinline__ void product_f32(const float* as, int lda,
                                            const float* bs, int ldb, int k,
                                            int i0, int j0, Sink sink) {
  float acc[TM][4] = {};
  accumulate_f32<TM, TA, TB>(as, lda, bs, ldb, k, i0, j0, acc);
  sink(acc);
}

// the output's row of 4 f32 (j0 < n) or 2 f64 (j even, < n), stored 16
// bytes at once where vec
__device__ __forceinline__ void store(float* row, int j0, int n,
                                      const float* v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(row + j0) = make_float4(v[0], v[1], v[2],
                                                       v[3]);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (j0 + c < n) row[j0 + c] = v[c];
}
__device__ __forceinline__ void store(double* row, int j, int n, double v0,
                                      double v1, bool vec) {
  if (vec) {
    *reinterpret_cast<double2*>(row + j) = make_double2(v0, v1);
    return;
  }
  row[j] = v0;
  if (j + 1 < n) row[j + 1] = v1;
}

// The walk of a persistent block over units blockIdx.x, blockIdx.x +
// gridDim.x, ...: with S = 2 a ring, the next unit's copies in flight
// while a unit is computed; with S = 1 a unit staged, then computed.
// issue(stage, unit) issues a unit's copies (one cp.async group),
// compute(stage, unit) uses them.
template <int S, typename Issue, typename Compute>
__device__ __forceinline__ void ring(int units, Issue issue,
                                     Compute compute) {
  int u = blockIdx.x;
  if (u >= units) return;
  const int stride = gridDim.x;
  if constexpr (S == 1) {
    for (; u < units; u += stride) {
      issue(0, u);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      compute(0, u);
      __syncthreads();
    }
    return;
  }
  issue(0, u);
  cp_async_commit();
  for (int st = 0; u < units; u += stride, st ^= 1) {
    if (u + stride < units) issue(st ^ 1, u + stride);
    cp_async_commit();  // (an empty group past the last unit)
    cp_async_wait<1>();
    __syncthreads();
    compute(st, u);
    __syncthreads();  // the stage is read before a later unit refills it
  }
}

// C = op(A) op(B): units (fragment, band of kBand rows of op(A))
template <typename T, int N>
__global__ void __launch_bounds__(Cfg<T, N>::kThreads, Cfg<T, N>::kMinBlocks)
    bmm_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ c, int batch, int m, int n, int k,
               int flags) {
  using C = Cfg<T, N>;
  constexpr int kBand = C::kBand, kA = C::kA, kStage = C::kStage;
  constexpr int kLd = C::kLd, kLdA = C::kLdBand;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const bool ta = flags & kTransA, tb = flags & kTransB;
  const bool va = flags & kVecA, vb = flags & kVecB, vc = flags & kVecC;
  const int bands = (m + kBand - 1) / kBand;
  // a unit's fragment and first row
  auto decode = [&](int unit, long long& f, int& r0) {
    if constexpr (kBand == N) {
      f = unit;
      r0 = 0;
    } else {
      f = unit / bands;
      r0 = (unit - static_cast<int>(f) * bands) * kBand;
    }
  };
  ring<C::kStages>(
      batch * bands,
      [&](int st, int unit) {
        long long f;
        int r0;
        decode(unit, f, r0);
        const int mr = min(kBand, m - r0);
        T* as = buf + st * kStage;
        const T* af = a + f * m * k;
        const T* bf = b + f * k * n;
        if (ta) {
          stage(as, kLdA, af + r0, m, k, mr, va);
        } else {
          stage(as, kLd, af + static_cast<long long>(r0) * k, k, mr, k, va);
        }
        if (tb) {
          stage(as + kA, kLd, bf, k, n, k, vb);
        } else {
          stage(as + kA, kLd, bf, n, k, n, vb);
        }
      },
      [&](int st, int unit) {
        long long f;
        int r0;
        decode(unit, f, r0);
        const int mr = min(kBand, m - r0);
        const T* as = buf + st * kStage;
        T* cf = c + (f * m + r0) * n;
        if constexpr (C::kF64) {
          product<C::G>(Op<T>{as, ta ? kLdA : kLd, ta},
                        Op<T>{as + kA, kLd, tb}, mr, n, k,
                        [&](int i, int j, T v0, T v1) {
                    if (i < mr && j < n) store(cf + i * n, j, n, v0, v1, vc);
                  });
        } else {
          constexpr int TM = C::TM;
          const int ti = threadIdx.x / (N / 4), tj = threadIdx.x % (N / 4);
          const int i0 = ti * TM, j0 = tj * 4;
          if (i0 >= mr || j0 >= n) return;
          float acc[TM][4] = {};
          accumulate_f32_op<TM>(as, ta ? kLdA : kLd, ta, as + kA, kLd, tb, k,
                                i0, j0, acc);
#pragma unroll
          for (int r = 0; r < TM; ++r)
            if (i0 + r < mr) store(cf + (i0 + r) * n, j0, n, acc[r], vc);
        }
      });
}

// C = (X F) X + S: a unit a fragment, X F in shared memory
template <typename T, int N>
__global__ void __launch_bounds__(Cfg<T, N>::kSandwichThreads,
                                  Cfg<T, N>::kMinBlocks)
    sandwich_kernel(const T* __restrict__ x, const T* __restrict__ f,
                    const T* __restrict__ s, T* __restrict__ c, int batch,
                    int n, int flags) {
  using C = Cfg<T, N>;
  constexpr int kMat = C::kMat, kStage = 2 * kMat, kLd = C::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  T* ts = buf + C::kStages * kStage;
  const bool vx = flags & kVecA, vf = flags & kVecB, vc = flags & kVecC;
  const long long nn = static_cast<long long>(n) * n;
  ring<C::kStages>(
      batch,
      [&](int st, int unit) {
        T* xs = buf + st * kStage;
        stage(xs, kLd, x + unit * nn, n, n, n, vx);
        stage(xs + kMat, kLd, f + unit * nn, n, n, n, vf);
      },
      [&](int st, int unit) {
        const T* xs = buf + st * kStage;
        const T* fs = xs + kMat;
        const T* sf = s + unit * nn;
        T* cf = c + unit * nn;
        if constexpr (C::kF64) {
          // the tiles write X F's padding too (zeros, from the zero
          // padding of X and F), which the second product reads
          product<C::G>(Op<T>{xs, kLd, false}, Op<T>{fs, kLd, false}, n, n,
                        n, [&](int i, int j, T v0, T v1) {
                          *reinterpret_cast<double2*>(
                              ts + sidx<T>(i, j, kLd)) = make_double2(v0, v1);
                        });
          __syncthreads();
          product<C::G>(Op<T>{ts, kLd, false}, Op<T>{xs, kLd, false}, n, n,
                        n,
                  [&](int i, int j, T v0, T v1) {
                    if (i >= n || j >= n) return;
                    const T* srow = sf + i * n;
                    T s0, s1 = T(0);
                    if (vc) {
                      const double2 sv =
                          *reinterpret_cast<const double2*>(srow + j);
                      s0 = sv.x, s1 = sv.y;
                    } else {
                      s0 = srow[j];
                      if (j + 1 < n) s1 = srow[j + 1];
                    }
                    store(cf + i * n, j, n, v0 + s0, v1 + s1, vc);
                  });
        } else {
          constexpr int TM = C::TM;
          const int ti = threadIdx.x / (N / 4), tj = threadIdx.x % (N / 4);
          const int i0 = ti * TM, j0 = tj * 4;
          const bool mine = i0 < n && j0 < n;
          if (mine) {
            product_f32<TM, false, false>(
                xs, kLd, fs, kLd, n, i0, j0, [&](const float (&acc)[TM][4]) {
#pragma unroll
                  for (int r = 0; r < TM; ++r)
                    *reinterpret_cast<float4*>(ts + sidx<T>(i0 + r, j0, kLd)) =
                        make_float4(acc[r][0], acc[r][1], acc[r][2],
                                    acc[r][3]);
                });
          }
          __syncthreads();
          if (!mine) return;
          product_f32<TM, false, false>(
              ts, kLd, xs, kLd, n, i0, j0, [&](const float (&acc)[TM][4]) {
#pragma unroll
                for (int r = 0; r < TM; ++r) {
                  if (i0 + r >= n) continue;
                  const T* srow = sf + (i0 + r) * n;
                  float v[4];
                  if (vc) {
                    const float4 sv =
                        *reinterpret_cast<const float4*>(srow + j0);
                    v[0] = acc[r][0] + sv.x, v[1] = acc[r][1] + sv.y;
                    v[2] = acc[r][2] + sv.z, v[3] = acc[r][3] + sv.w;
                  } else {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                      v[q] = j0 + q < n ? acc[r][q] + srow[j0 + q] : 0.0f;
                  }
                  store(cf + (i0 + r) * n, j0, n, v, vc);
                }
              });
        }
      });
}

// Sizes above 64 (fragments above 64 AOs on the exact route, SP2's
// products, CPCM's (nat, points) by (points, nat) contraction, and the
// backward passes of such products, whose long k becomes their m or n):
// the tiled kernel (design in the header, "The tiled class"). A unit is
// (fragment, band of BM rows of op(A), band of BN columns of op(B)); k is
// streamed through a ring of kTiledStages stages in tiles of BK in
// ascending order, at any length, the unit's outputs held in registers
// from tile to tile, so each element takes the same blocks of 4 (f64) or
// the same chain of FFMAs (f32) as one pass over k would. The unit's shape
// follows the plan (`tiled_shape`):
// - wide: 64 x 64, k tiles of 32, where the batch gives at least
//   kWideUnitsPerSm such units an SM (the peptide's 241, SP2's 256);
// - small: 32 x 32, k tiles of 32, where it does not ((3, 128), (16,
//   96)), and where m and n are 32 or less;
// - tall: 64 x 8, k tiles of 32, where n is 8 or less and m is not (CPCM's
//   backward, (points, nat) by (nat, nat));
// - skinny: 8 x 8, k tiles of 128, where m and n are 8 or less (CPCM's
//   (nat, points) by (points, nat)): a fragment a block, one warp's chain
//   of mmas (f32: four threads' chains of FFMAs) with one barrier a 128 k,
//   kTiledMinThreads threads staging its long k.
constexpr int kTileK = 32, kSkinnyTileK = 128;
constexpr int kWideBand = 64, kSmallBand = 32, kTallBand = 64;
constexpr int kSkinnyN = 8;
constexpr int kWideUnitsPerSm = 2;
constexpr int kTiledStages = 3, kWideStages = 2;
// the fewest threads a block of the tiled kernel (those past a unit's
// tiles only stage)
constexpr int kTiledMinThreads = 128;
// f64 rows that are not 16-byte aligned go by bulk copies where a staged
// row is this many elements or more (`stage_bulk`), by 16-byte cp.async
// below (`stage_pairs`); bytes at the start of the kernel's shared memory
// for the stages' barriers
constexpr int kBulkRow = 64, kTiledBars = 64;
enum TiledShape { kWide = 0, kSmall = 1, kTall = 2, kSkinny = 3 };

// a unit's tile and its threads, by element type and shape:
// - f64: a warp a WM x WN group of 8 x 8 tiles, all its accumulators live
//   together (wide 4 x 4, small 2 x 2, tall 2 x 1, skinny 1 x 1);
// - f32: a thread a TM x 4 tile read by float4 (TM = 8 at a band of 64
//   rows: rows i0 .. i0 + 3 and i0 + BM / 2 .. + 3, so a phase of 8 lanes
//   reads distinct banks);
// - at least kTiledMinThreads threads a block, those past the tiles'
//   warps or threads only staging;
// - staged rows: f64 padded by 4 (a fragment load of 8 rows x 4 columns on
//   distinct banks in either layout), f32 at least 16 long, its 16-byte
//   chunks swizzled (`sidx`).
template <typename T, int Shape>
struct TileCfg {
  static constexpr bool kF64 = sizeof(T) == 8;
  static constexpr int BM = Shape == kWide ? kWideBand
                            : Shape == kSmall ? kSmallBand
                            : Shape == kTall  ? kTallBand
                                              : kSkinnyN;
  static constexpr int BN = Shape == kWide ? kWideBand
                            : Shape == kSmall ? kSmallBand
                                              : kSkinnyN;
  static constexpr int BK = Shape == kSkinny ? kSkinnyTileK : kTileK;
  static constexpr int WM = Shape == kWide ? 4 : Shape == kSkinny ? 1 : 2;
  static constexpr int WN = Shape == kWide ? 4 : Shape == kSmall ? 2 : 1;
  static constexpr int kWarpsN = BN / (8 * WN);
  static constexpr int TM = BM >= 64 ? 8 : 4;
  static constexpr int kComputing = kF64 ? 32 * (BM / (8 * WM)) * kWarpsN
                                         : (BM / TM) * (BN / 4);
  static constexpr int kThreads =
      kComputing < kTiledMinThreads ? kTiledMinThreads : kComputing;
  static constexpr int kStages = Shape == kWide ? kWideStages : kTiledStages;
  static constexpr int ld(int len) {
    return kF64 ? len + 4 : (len < 16 ? 16 : len);
  }
  // op(A)'s tile stored (m, k) or (k, m), op(B)'s stored (k, n) or (n, k)
  static constexpr int kLdAN = ld(BK), kLdAT = ld(BM);
  static constexpr int kLdBN = ld(BN), kLdBT = ld(BK);
  static constexpr int kA = BM * kLdAN > BK * kLdAT ? BM * kLdAN : BK * kLdAT;
  static constexpr int kB = BK * kLdBN > BN * kLdBT ? BK * kLdBN : BN * kLdBT;
  static constexpr int kStage = kA + kB;
};

// d += a b on the FP64 tensor cores, a warp's 8 x 8 tile over 4 k
__device__ __forceinline__ void mma884(double& d0, double& d1, double a,
                                       double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// d += a b on the FP64 tensor cores, a warp's 16 x 8 tile over 4 k: rows
// g (a0; d0, d1) and g + 8 (a1; d2, d3), each output summed as m8n8k4
// sums it (the fingerprints equal)
__device__ __forceinline__ void mma1684(double& d0, double& d1, double& d2,
                                        double& d3, double a0, double a1,
                                        double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// the parity of an f64 element's address in 16-byte chunks
__device__ __forceinline__ int odd_of(const double* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 3) & 1);
}

// Issue the copies of a stored (rows, cols) f64 block at g (row stride gs)
// whose rows are not all 16-byte aligned (odd n, a view with a storage
// offset) into s (rows of ld elements, ld even and at least the padded row
// plus one), and zero its padding up to the next multiples of 8: row i's
// element j at s[i ld + odd_of(g + i gs) + j], so that every pair whose
// source is 16-byte aligned lands 16-byte aligned. A padded row of pc
// elements is pc / 2 copies, a lane each: the pairs from element 0 where
// the row starts 16-byte aligned; else the pairs from element 1, and the
// first lane the row's first and last elements, an element a copy.
__device__ __forceinline__ void stage_pairs(double* s, int ld,
                                            const double* g, long long gs,
                                            int rows, int cols) {
  const int pr = (rows + 7) & ~7, pc = (cols + 7) & ~7;
  const int shift = row_shift(pc / 2);
  const int lane = threadIdx.x & ((1 << shift) - 1);
  for (int i = threadIdx.x >> shift; i < pr; i += blockDim.x >> shift) {
    const double* gi = g + i * gs;
    const int off = odd_of(gi);
    double* si = s + i * ld + off;
    const int live = i < rows ? cols : 0;  // elements to copy
    // element e of the row: copied, or zero past the block
    auto one = [&](int e) {
      if (e < live) {
        cp_async(si + e, gi + e);
      } else {
        si[e] = 0.0;
      }
    };
    for (int q = lane; q < pc / 2; q += 1 << shift) {
      if (off && q == 0) {
        one(0);
        one(pc - 1);
        continue;
      }
      const int j = 2 * q - off;  // si + j and gi + j are 16-byte aligned
      if (j + 1 < live) {
        cp_async16(si + j, gi + j);
      } else {
        one(j);
        one(j + 1);
      }
    }
  }
}

// The tensor memory accelerator's bulk copies (f64 rows that are not
// 16-byte aligned, long ones): a stage's copies complete on its mbarrier,
// which its readers wait on
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b));
}
// the initialized barriers visible to the async proxy
__device__ __forceinline__ void bar_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(b),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned d = smem_addr(dst), b = smem_addr(bar);
  const unsigned long long g = __cvta_generic_to_global(src);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(g), "r"(bytes), "r"(b)
      : "memory");
}

// The same layout by bulk copies, for long rows (kBulkRow elements or
// more): the lanes of one warp, a row a lane, its element j at s[i ld +
// odd_of(g + i gs) + j]; the row's 16-byte aligned pairs one bulk copy
// (its bytes expected on the stage's barrier before it is issued), an odd
// element at either end a cp.async in the item's group, so nothing outside
// the block's rows is read. Nothing else is written: the reader masks k
// past the block in a partial tile, and rows and columns past it give only
// outputs that are not stored.
__device__ __forceinline__ void stage_bulk(double* s, int ld, const double* g,
                                           long long gs, int rows, int cols,
                                           uint64_t* bar) {
  for (int i = threadIdx.x % kWarp; i < rows; i += kWarp) {
    const double* gi = g + i * gs;
    const int off = odd_of(gi);
    double* si = s + i * ld + off;  // element j at si[j]
    const int pairs = (cols - off) / 2;
    if (off) cp_async(si, gi);
    if ((cols - off) & 1) cp_async(si + cols - 1, gi + cols - 1);
    if (pairs > 0) {
      const unsigned bytes = static_cast<unsigned>(pairs) * 16;
      bar_expect(bar, bytes);
      bulk_copy(si + off, gi + off, bytes, bar);
    }
  }
}

template <typename T, int Shape, bool TA, bool TB>
__global__ void __launch_bounds__(TileCfg<T, Shape>::kThreads)
    tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ c, int batch, int m, int n, int k,
                 int flags) {
  using C = TileCfg<T, Shape>;
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, S = C::kStages;
  constexpr int kLdA = TA ? C::kLdAT : C::kLdAN;
  constexpr int kLdB = TB ? C::kLdBT : C::kLdBN;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* buf = reinterpret_cast<T*>(smem + kTiledBars);
  const bool va = flags & kVecA, vb = flags & kVecB, vc = flags & kVecC;
  const int rbands = (m + BM - 1) / BM, cbands = (n + BN - 1) / BN;
  const int tiles = (k + BK - 1) / BK;
  const int bands = rbands * cbands;
  const int units = batch * bands;
  if (static_cast<int>(blockIdx.x) >= units) return;
  // item i of this block: k tile i % tiles of its (i / tiles)-th unit
  const int items = ((units - 1 - blockIdx.x) / gridDim.x + 1) * tiles;
  struct Item {
    long long f;
    int r0, mr, c0, nc, kk, tile;
  };
  auto item = [&](int i) {
    Item it;
    const int unit = blockIdx.x + (i / tiles) * gridDim.x;
    it.tile = i - (i / tiles) * tiles;
    it.f = unit / bands;
    const int band = unit - static_cast<int>(it.f) * bands;
    const int rb = band / cbands;
    it.r0 = rb * BM;
    it.mr = min(BM, m - it.r0);
    it.c0 = (band - rb * cbands) * BN;
    it.nc = min(BN, n - it.c0);
    it.kk = min(BK, k - it.tile * BK);
    return it;
  };
  // the stored tiles of an item: op(A)'s at ga (rows of gsa), op(B)'s at
  // gb (rows of gsb)
  auto tiles_of = [&](const Item& it, const T*& ga, long long& gsa,
                      const T*& gb, long long& gsb) {
    const long long k0 = static_cast<long long>(it.tile) * BK;
    const T* af = a + it.f * m * k;
    const T* bf = b + it.f * k * n;
    ga = TA ? af + k0 * m + it.r0 : af + it.r0 * static_cast<long long>(k) + k0;
    gsa = TA ? m : k;
    gb = TB ? bf + it.c0 * static_cast<long long>(k) + k0 : bf + k0 * n + it.c0;
    gsb = TB ? k : n;
  };
  // f64 operands whose rows are not all 16-byte aligned (odd n, offset
  // views) go into rows shifted by their parity: long staged rows by bulk
  // copies (`stage_bulk`), short ones by 16-byte cp.async (`stage_pairs`);
  // the others, and f32's, as `stage` copies them
  const bool bulk_a = C::kF64 && !va && (TA ? BM : BK) >= kBulkRow;
  const bool bulk_b = C::kF64 && !vb && (TB ? BK : BN) >= kBulkRow;
  auto issue = [&](int st, int i) {
    const Item it = item(i);
    T* as = buf + st * C::kStage;
    const T *ga, *gb;
    long long gsa, gsb;
    tiles_of(it, ga, gsa, gb, gsb);
    const int ra = TA ? it.kk : it.mr, ca = TA ? it.mr : it.kk;
    const int rb = TB ? it.nc : it.kk, cb = TB ? it.kk : it.nc;
    if constexpr (C::kF64) {
      // warp 0: a bulk copy a row, then lane 0's arrival
      if ((bulk_a || bulk_b) && threadIdx.x < kWarp) {
        if (bulk_a) stage_bulk(as, kLdA, ga, gsa, ra, ca, bars + st);
        if (bulk_b) stage_bulk(as + C::kA, kLdB, gb, gsb, rb, cb, bars + st);
        __syncwarp();
        if (threadIdx.x == 0) bar_arrive(bars + st);
      }
      if (!va && !bulk_a) stage_pairs(as, kLdA, ga, gsa, ra, ca);
      if (!vb && !bulk_b) stage_pairs(as + C::kA, kLdB, gb, gsb, rb, cb);
    }
    if (!C::kF64 || va) stage(as, kLdA, ga, gsa, ra, ca, va);
    if (!C::kF64 || vb) stage(as + C::kA, kLdB, gb, gsb, rb, cb, vb);
  };
  // f64: the warp's first tile (rows wr.., columns wc.. of the unit) and
  // its lane's place in an 8 x 8 tile; f32: the thread's first row and
  // column
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x / kWarp;
  const int wr = (warp / C::kWarpsN) * C::WM * 8;
  const int wc = (warp % C::kWarpsN) * C::WN * 8;
  constexpr int TM = C::TM;
  const int i0 = (threadIdx.x / (BN / 4)) * 4;
  const int j0 = (threadIdx.x % (BN / 4)) * 4;
  double d[C::WM][C::WN][2] = {};
  float acc[TM][4] = {};
  // every thread's cp.async copies one group an item; the bulk copies
  // complete on the stage's barrier, which every thread waits on
  if (bulk_a || bulk_b) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) bar_init(bars + s);
      bar_fence();
    }
    __syncthreads();
  }
  for (int s = 0; s < S - 1; ++s) {
    if (s < items) issue(s, s);
    cp_async_commit();
  }
  for (int i = 0, st = 0; i < items; ++i, st = st == S - 1 ? 0 : st + 1) {
    // item i's copies have landed, and every thread is done with item
    // i - 1, whose stage the copies of item i + S - 1 then refill
    cp_async_wait<S - 2>();
    __syncthreads();
    if (i + S - 1 < items) issue(st == 0 ? S - 1 : st - 1, i + S - 1);
    cp_async_commit();
    if (bulk_a || bulk_b) bar_wait(bars + st, (i / S) & 1);
    const Item it = item(i);
    const T* as = buf + st * C::kStage;
    const T* bs = as + C::kA;
    const bool last = it.tile == tiles - 1;
    T* cf = c + (it.f * m + it.r0) * n + it.c0;
    if constexpr (C::kF64) {
      if (threadIdx.x >= C::kComputing) continue;
      bool row_ok[C::WM], col_ok[C::WN];
#pragma unroll
      for (int u = 0; u < C::WM; ++u) row_ok[u] = wr + u * 8 < it.mr;
#pragma unroll
      for (int v = 0; v < C::WN; ++v) col_ok[v] = wc + v * 8 < it.nc;
      // op(A)[wr + 8u + g][4s + t] and op(B)[4s + t][wc + 8v + g], each
      // stored row shifted by its parity (`stage_pairs`, `stage_bulk`):
      // the same for every u, v and s of the lane
      const T *ga, *gb;
      long long gsa, gsb;
      tiles_of(it, ga, gsa, gb, gsb);
      const int ra = TA ? t : wr + g, rb = TB ? wc + g : t;
      const double* pa =
          (TA ? as + t * kLdA + wr + g : as + (wr + g) * kLdA + t) +
          odd_of(ga + ra * gsa);
      const double* pb =
          (TB ? bs + (wc + g) * kLdB + t : bs + t * kLdB + wc + g) +
          odd_of(gb + rb * gsb);
      // k past the block (the end of a partial tile) read as the zeros
      // that padding adds: a bulk-staged tile has no padding, so every
      // partial tile takes the masked steps
      auto step = [&](int s, bool masked) {
        const bool in = !masked || s * 4 + t < it.kk;
        double av[C::WM], bv[C::WN];
#pragma unroll
        for (int u = 0; u < C::WM; ++u)
          av[u] = !in ? 0.0
                : TA ? pa[s * 4 * kLdA + u * 8]
                     : pa[u * 8 * kLdA + s * 4];
#pragma unroll
        for (int v = 0; v < C::WN; ++v)
          bv[v] = !in ? 0.0
                : TB ? pb[v * 8 * kLdB + s * 4]
                     : pb[s * 4 * kLdB + v * 8];
        // pairs of 8 x 8 tiles one m16n8k4 (the second's rows may be
        // padding: computed, never stored)
#pragma unroll
        for (int u = 0; u < C::WM; u += C::WM % 2 == 0 ? 2 : 1) {
#pragma unroll
          for (int v = 0; v < C::WN; ++v) {
            if (!(row_ok[u] && col_ok[v])) continue;
            if constexpr (C::WM % 2 == 0) {
              mma1684(d[u][v][0], d[u][v][1], d[u + 1][v][0],
                      d[u + 1][v][1], av[u], av[u + 1], bv[v]);
            } else {
              mma884(d[u][v][0], d[u][v][1], av[u], bv[v]);
            }
          }
        }
      };
      if (it.kk == BK) {
#pragma unroll
        for (int s = 0; s < BK / 4; ++s) step(s, false);
      } else {
        for (int s = 0; s < (it.kk + 3) / 4; ++s) step(s, true);
      }
      if (!last) continue;
#pragma unroll
      for (int u = 0; u < C::WM; ++u) {
#pragma unroll
        for (int v = 0; v < C::WN; ++v) {
          const int r = wr + u * 8 + g, j = wc + v * 8 + 2 * t;
          if (row_ok[u] && col_ok[v] && r < it.mr && j < it.nc)
            store(cf + static_cast<long long>(r) * n, j, it.nc, d[u][v][0],
                  d[u][v][1], vc);
          d[u][v][0] = d[u][v][1] = 0.0;
        }
      }
    } else {
      if (threadIdx.x >= C::kComputing || i0 >= it.mr || j0 >= it.nc)
        continue;
      // the thread's row r: i0 + r (r < 4), i0 + BM / 2 + r - 4 (TM = 8)
      auto row = [&](int r) { return i0 + (r >> 2) * (BM / 2) + (r & 3); };
      auto block = [&](int k0, int kq) {
        // av[r][q] = op(A)[row(r)][k0 + q], bv[q][c] = op(B)[k0 + q][j0 + c]
        float av[TM][4], bv[4][4];
        if constexpr (TA) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int h = 0; h < TM / 4; ++h) {
              const float4 v = lds4(as, k0 + q, i0 + h * (BM / 2), kLdA);
              av[4 * h][q] = v.x, av[4 * h + 1][q] = v.y;
              av[4 * h + 2][q] = v.z, av[4 * h + 3][q] = v.w;
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float4 v = lds4(as, row(r), k0, kLdA);
            av[r][0] = v.x, av[r][1] = v.y, av[r][2] = v.z, av[r][3] = v.w;
          }
        }
        if constexpr (TB) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 v = lds4(bs, j0 + cc, k0, kLdB);
            bv[0][cc] = v.x, bv[1][cc] = v.y, bv[2][cc] = v.z, bv[3][cc] = v.w;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = lds4(bs, k0 + q, j0, kLdB);
            bv[q][0] = v.x, bv[q][1] = v.y, bv[q][2] = v.z, bv[q][3] = v.w;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= kq) break;
#pragma unroll
          for (int r = 0; r < TM; ++r) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[r][cc] = fma_(av[r][q], bv[q][cc], acc[r][cc]);
          }
        }
      };
      if (it.kk == BK) {
#pragma unroll 2
        for (int k0 = 0; k0 < BK; k0 += 4) block(k0, 4);
      } else {
        for (int k0 = 0; k0 < it.kk; k0 += 4) block(k0, it.kk - k0);
      }
      if (!last) continue;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        if (row(r) < it.mr)
          store(cf + static_cast<long long>(row(r)) * n, j0, it.nc, acc[r],
                vc);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      }
    }
  }
}

// C = op(A) op(B) with a thread per output element, FMA in ascending k
// from global memory: the products whose sizes are all kTiny or less
// (D3's (1, R) by (R, R) per atom pair: a block per fragment would leave
// most of its threads idle there)
template <typename T>
__global__ void direct_kernel(const T* __restrict__ a,
                              const T* __restrict__ b, T* __restrict__ c,
                              long long total, int m, int n, int k,
                              bool trans_a, bool trans_b) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int mn = m * n;
  const long long f = idx / mn;
  const int r = static_cast<int>(idx - f * mn);
  const int i = r / n, j = r - (r / n) * n;
  const T* af = a + f * m * k;
  const T* bf = b + f * k * n;
  T acc = T(0);
  for (int q = 0; q < k; ++q) {
    const T av = trans_a ? af[q * m + i] : af[i * k + q];
    const T bv = trans_b ? bf[j * k + q] : bf[q * n + j];
    acc = fma_(av, bv, acc);
  }
  c[idx] = acc;
}

// Issue the copies of a stored (nr, nc) block at g (row stride gs) into s
// (rows of ld elements, 16-byte aligned): 16 bytes a copy where vec (g
// 16-byte aligned, gs a whole number of chunks), the ragged end of a row
// an element a copy; else an element a copy. A power-of-two count of
// lanes a row (no index division). Nothing else is written.
template <typename T>
__device__ __forceinline__ void stage_rows(T* s, int ld, const T* g,
                                           long long gs, int nr, int nc,
                                           bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int per = vec ? (nc + E - 1) / E : nc;  // copies a row
  const int shift = per <= 1 ? 0 : row_shift(per);
  const int lanes = 1 << shift;
  const int lane = threadIdx.x & (lanes - 1);
  for (int r = threadIdx.x >> shift; r < nr; r += blockDim.x >> shift) {
    const T* src = g + r * gs;
    T* dst = s + r * ld;
    for (int u = lane; u < per; u += lanes) {
      if (!vec) {
        cp_async(dst + u, src + u);
      } else if ((u + 1) * E <= nc) {
        cp_async16(dst + u * E, src + u * E);
      } else {
        for (int c = u * E; c < nc; ++c) cp_async(dst + c, src + c);
      }
    }
  }
}

// 16 bytes of a staged row: op(M)[i, q .. q + E) or x[q .. q + E)
template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  double v[2];
  __device__ __forceinline__ explicit Vec16(const double* p) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
};
template <>
struct Vec16<float> {
  float v[4];
  __device__ __forceinline__ explicit Vec16(const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};

// The matvec y = op(M) x (design in the header, "The matvec"). A unit is
// F whole fragments (R = rows), or one fragment's band of R rows of
// op(M); blocks walk the units with the grid's stride, each unit's rows of
// op(M) (plain: rows of M; transposed: columns of M, read from M's stored
// rows) and its fragments' x staged into one of two stages while the
// block computes the unit before it; a thread a chain runs acc =
// fma(op(M)[i, q], x[q], acc) for q ascending from acc = 0.
struct MvPlan {
  int batch, rows, cols;
  int trans;
  int in_place;      // whole fragments read in place (`mv_plan`)
  int vec_m, vec_x;  // 16-byte copies reach every staged row of M, of x
  int F;             // fragments a unit (R == rows where F > 1)
  int R;             // rows of op(M) a unit computes for each fragment
  int bands;         // units a group of fragments: ceil(rows / R)
  int units;         // ceil(batch / F) x bands; in place, kMvThreads
                     // outputs a unit
  int ld;            // staged row of M: plain op(M)'s rows, else M's rows
  int ldx;           // elements a fragment's staged x
  int stage;         // elements a stage: F (ldx + R ld), or ldx + cols ld
};

// The operands of columns j .. j + kMvBatch of a chain into registers:
// op(M)[i, q] at a[q * step] (plain: step 1, read 16 bytes at a time),
// x[q] at x[q]; columns past n are left alone
template <typename T, bool Trans>
__device__ __forceinline__ void mv_load(const T* a, int step, const T* x,
                                        int j, int n, T (&m)[kMvBatch],
                                        T (&v)[kMvBatch]) {
  constexpr int E = Trans ? 1 : 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kMvBatch; u += E) {
    if (j + u < n) {
      if (Trans) {
        m[u] = a[(j + u) * step];
        v[u] = x[j + u];
      } else {
        const Vec16<T> mm(a + j + u), vv(x + j + u);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          m[u + e] = mm.v[e];
          v[u + e] = vv.v[e];
        }
      }
    }
  }
}

// acc = fma(op(M)[i, q], x[q], acc) for q = 0 .. n - 1 (n <= KT) in
// ascending order, the next batch's operands read before this batch's
// FMAs
template <typename T, int KT, bool Trans>
__device__ __forceinline__ void mv_chain(const T* a, int step, const T* x,
                                         int n, T& acc) {
  T m0[kMvBatch], v0[kMvBatch], m1[kMvBatch], v1[kMvBatch];
  mv_load<T, Trans>(a, step, x, 0, n, m0, v0);
#pragma unroll
  for (int j = 0; j < KT; j += 2 * kMvBatch) {
    if (j + kMvBatch < KT && j + kMvBatch < n)
      mv_load<T, Trans>(a, step, x, j + kMvBatch, n, m1, v1);
#pragma unroll
    for (int u = 0; u < kMvBatch; ++u)
      if (j + u < n) acc = fma_(m0[u], v0[u], acc);
    if (j + 2 * kMvBatch < KT && j + 2 * kMvBatch < n)
      mv_load<T, Trans>(a, step, x, j + 2 * kMvBatch, n, m0, v0);
#pragma unroll
    for (int u = 0; u < kMvBatch; ++u)
      if (j + kMvBatch + u < n) acc = fma_(m1[u], v1[u], acc);
  }
}

// Issue the copies of unit u (its fragments' x, then its op(M) rows) into
// stage s: one group of copies
template <typename T>
__device__ __forceinline__ void mv_issue(const T* __restrict__ mat,
                                         const T* __restrict__ x,
                                         const MvPlan& p, int u, T* s) {
  const int group = u / p.bands;
  const long long f0 = static_cast<long long>(group) * p.F;
  const int nf = static_cast<int>(p.batch - f0 < p.F ? p.batch - f0 : p.F);
  const int r0 = (u - group * p.bands) * p.R;
  const int nr = p.rows - r0 < p.R ? p.rows - r0 : p.R;
  T* ms = s + p.F * p.ldx;
  stage_rows(s, p.ldx, x + f0 * p.cols, p.cols, nf, p.cols, p.vec_x != 0);
  if (!p.trans) {
    // nf x nr consecutive stored rows (F > 1 only with whole fragments)
    stage_rows(ms, p.ld, mat + (f0 * p.rows + r0) * p.cols, p.cols,
               nf * nr, p.cols, p.vec_m != 0);
  } else {
    // a band of one fragment (F = 1): R columns of each stored row
    stage_rows(ms, p.ld, mat + f0 * p.cols * p.rows + r0, p.rows, p.cols, nr,
               p.vec_m != 0);
  }
}

// KT: the columns of op(M) a step of the chain takes (16, or kMvTileK
// where cols > 16)
template <typename T, int KT>
__global__ void __launch_bounds__(kMvThreads)
    matvec_kernel(const T* __restrict__ mat, const T* __restrict__ x,
                  T* __restrict__ y, MvPlan p) {
  extern __shared__ __align__(16) unsigned char mv_smem[];
  const int tid = threadIdx.x;
  if (p.in_place) {
    // whole fragments, M and x read where they lie, a thread an output of
    // the batch (units of kMvThreads outputs): in the transposed form
    // consecutive threads read consecutive columns of M's row q
    const long long outs = static_cast<long long>(p.batch) * p.rows;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const long long g = static_cast<long long>(u) * kMvThreads + tid;
      if (g >= outs) continue;
      const long long f = g / p.rows;
      const int r = static_cast<int>(g - f * p.rows);
      const T* a = p.trans ? mat + f * p.cols * p.rows + r
                           : mat + (f * p.rows + r) * p.cols;
      const T* xf = x + f * p.cols;
      T acc = T(0);
      if (p.trans) {
        // a plain loop (measured faster here than the batched reads)
        for (int q = 0; q < p.cols; ++q)
          acc = fma_(a[static_cast<long long>(q) * p.rows], xf[q], acc);
      } else {
        for (int q0 = 0; q0 < p.cols; q0 += KT) {
          const int nq = p.cols - q0 < KT ? p.cols - q0 : KT;
          if (p.vec_m && p.vec_x)
            mv_chain<T, KT, false>(a + q0, 1, xf + q0, nq, acc);
          else
            mv_chain<T, KT, true>(a + q0, 1, xf + q0, nq, acc);
        }
      }
      y[g] = acc;
    }
    return;
  }
  T* stage[2] = {reinterpret_cast<T*>(mv_smem),
                 reinterpret_cast<T*>(mv_smem) + p.stage};
  int u = blockIdx.x;
  mv_issue(mat, x, p, u, stage[0]);
  cp_async_commit();
  for (int k = 0; u < p.units; ++k, u += gridDim.x) {
    // the next unit's copies into the other stage, then this unit's wait
    if (u + static_cast<int>(gridDim.x) < p.units)
      mv_issue(mat, x, p, u + gridDim.x, stage[(k + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // every thread's copies of unit u have landed
    const int group = u / p.bands;
    const long long f0 = static_cast<long long>(group) * p.F;
    const int nf = static_cast<int>(
        p.batch - f0 < p.F ? p.batch - f0 : p.F);
    const int r0 = (u - group * p.bands) * p.R;
    const int nr = p.rows - r0 < p.R ? p.rows - r0 : p.R;
    if (tid < nf * nr) {
      const int fl = tid / nr, r = tid - fl * nr;
      const T* xv = stage[k & 1] + fl * p.ldx;
      const T* ms = stage[k & 1] + p.F * p.ldx;
      T acc = T(0);
      for (int q0 = 0; q0 < p.cols; q0 += KT) {
        const int nq = p.cols - q0 < KT ? p.cols - q0 : KT;
        if (!p.trans) {
          mv_chain<T, KT, false>(ms + (fl * nr + r) * p.ld + q0, 1, xv + q0,
                                 nq, acc);
        } else {
          mv_chain<T, KT, true>(ms + q0 * p.ld + r, p.ld, xv + q0, nq,
                                acc);
        }
      }
      y[(f0 + fl) * p.rows + r0 + r] = acc;
    }
    __syncthreads();  // the stage is read before a later unit refills it
  }
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

// Above 48 KB a kernel needs its dynamic shared memory raised, once per
// device (the attribute is the context's)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device,
                       unsigned long long* done) {
  if (bytes <= static_cast<size_t>(kStaticSmem)) return cudaSuccess;
  const unsigned long long bit = 1ull << (device & 63);
  if (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) __atomic_fetch_or(done, bit, __ATOMIC_RELEASE);
  return err;
}

// The blocks of `kernel` the card holds at once (SMs x resident blocks an
// SM at this block size and shared memory), queried once per device after
// its shared memory was raised
template <typename Kernel>
cudaError_t resident(Kernel kernel, int threads, size_t smem, int device,
                     int* cache, int* slots) {
  int* held = cache + (device & 63);
  int v = __atomic_load_n(held, __ATOMIC_ACQUIRE);
  if (v == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    v = per_sm * sms;
    __atomic_store_n(held, v, __ATOMIC_RELEASE);
  }
  *slots = v;
  return cudaSuccess;
}

inline int grid_of(int units, int slots) {
  return units < slots ? units : slots;
}

template <typename T, int N>
cudaError_t launch_bmm(const T* a, const T* b, T* c, int batch, int m,
                       int n, int k, int flags, int device,
                       cudaStream_t stream) {
  using C = Cfg<T, N>;
  static unsigned long long done = 0;
  static int slots_of[64] = {};
  const size_t smem = C::kStages * C::kStage * sizeof(T);
  cudaError_t err = allow_smem(bmm_kernel<T, N>, smem, device, &done);
  if (err != cudaSuccess) return err;
  int slots = 0;
  err = resident(bmm_kernel<T, N>, C::kThreads, smem, device, slots_of,
                 &slots);
  if (err != cudaSuccess) return err;
  const long long units =
      static_cast<long long>(batch) * ((m + C::kBand - 1) / C::kBand);
  if (units > kMaxUnits) return cudaErrorInvalidValue;
  bmm_kernel<T, N><<<grid_of(static_cast<int>(units), slots), C::kThreads,
                     smem, stream>>>(
      a, b, c, batch, m, n, k, flags);
  return cudaGetLastError();
}

template <typename T, int Shape, bool TA, bool TB>
cudaError_t launch_tiled_as(const T* a, const T* b, T* c, int batch, int m,
                            int n, int k, int flags, int device,
                            cudaStream_t stream) {
  using C = TileCfg<T, Shape>;
  static unsigned long long done = 0;
  static int slots_of[64] = {};
  const auto kernel = tiled_kernel<T, Shape, TA, TB>;
  const size_t smem = kTiledBars + C::kStages * C::kStage * sizeof(T);
  cudaError_t err = allow_smem(kernel, smem, device, &done);
  if (err != cudaSuccess) return err;
  int slots = 0;
  err = resident(kernel, C::kThreads, smem, device, slots_of, &slots);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>(batch) *
                          ((m + C::BM - 1) / C::BM) *
                          ((n + C::BN - 1) / C::BN);
  if (units * ((k + C::BK - 1) / C::BK) > kMaxUnits)
    return cudaErrorInvalidValue;
  kernel<<<grid_of(static_cast<int>(units), slots), C::kThreads, smem,
           stream>>>(a, b, c, batch, m, n, k, flags);
  return cudaGetLastError();
}

template <typename T, int Shape>
cudaError_t launch_tiled_shape(const T* a, const T* b, T* c, int batch,
                               int m, int n, int k, int flags, int device,
                               cudaStream_t stream) {
  const bool ta = flags & kTransA, tb = flags & kTransB;
  if (ta && tb)
    return launch_tiled_as<T, Shape, true, true>(a, b, c, batch, m, n, k,
                                                 flags, device, stream);
  if (ta)
    return launch_tiled_as<T, Shape, true, false>(a, b, c, batch, m, n, k,
                                                  flags, device, stream);
  if (tb)
    return launch_tiled_as<T, Shape, false, true>(a, b, c, batch, m, n, k,
                                                  flags, device, stream);
  return launch_tiled_as<T, Shape, false, false>(a, b, c, batch, m, n, k,
                                                 flags, device, stream);
}

cudaError_t mv_card(int device, int* sms, int* smem_sm);

// The tiled class's unit shape at (batch, m, n) on a card of `sms` SMs
// (the bits do not depend on it): skinny where m and n are kSkinnyN or
// less, tall where n is and m is not, small where m and n are kSmallBand
// or less or where the batch gives fewer than kWideUnitsPerSm wide units
// an SM, else wide.
inline int tiled_shape(int batch, int m, int n, int sms) {
  if (m <= kSkinnyN && n <= kSkinnyN) return kSkinny;
  if (n <= kSkinnyN) return kTall;
  if (m <= kSmallBand && n <= kSmallBand) return kSmall;
  const long long wide = static_cast<long long>(batch) *
                         ((m + kWideBand - 1) / kWideBand) *
                         ((n + kWideBand - 1) / kWideBand);
  return wide >= static_cast<long long>(kWideUnitsPerSm) * sms ? kWide
                                                               : kSmall;
}

template <typename T>
cudaError_t launch_tiled(const T* a, const T* b, T* c, int batch, int m,
                         int n, int k, int flags, int device,
                         cudaStream_t stream) {
  int sms = 0, smem_sm = 0;
  const cudaError_t err = mv_card(device, &sms, &smem_sm);
  if (err != cudaSuccess) return err;
  switch (tiled_shape(batch, m, n, sms)) {
    case kWide:
      return launch_tiled_shape<T, kWide>(a, b, c, batch, m, n, k, flags,
                                          device, stream);
    case kSmall:
      return launch_tiled_shape<T, kSmall>(a, b, c, batch, m, n, k, flags,
                                           device, stream);
    case kTall:
      return launch_tiled_shape<T, kTall>(a, b, c, batch, m, n, k, flags,
                                          device, stream);
    default:
      return launch_tiled_shape<T, kSkinny>(a, b, c, batch, m, n, k, flags,
                                            device, stream);
  }
}

template <typename T, int N>
cudaError_t launch_sandwich(const T* x, const T* f, const T* s, T* c,
                            int batch, int n, int flags, int device,
                            cudaStream_t stream) {
  using C = Cfg<T, N>;
  static unsigned long long done = 0;
  static int slots_of[64] = {};
  const size_t smem = (2 * C::kStages + 1) * C::kMat * sizeof(T);
  cudaError_t err = allow_smem(sandwich_kernel<T, N>, smem, device, &done);
  if (err != cudaSuccess) return err;
  int slots = 0;
  err = resident(sandwich_kernel<T, N>, C::kSandwichThreads, smem, device,
                 slots_of, &slots);
  if (err != cudaSuccess) return err;
  if (batch > kMaxUnits) return cudaErrorInvalidValue;
  sandwich_kernel<T, N><<<grid_of(batch, slots), C::kSandwichThreads, smem,
                          stream>>>(x, f, s, c, batch, n, flags);
  return cudaGetLastError();
}

// the size class of a product's largest size: 16, 32 or 64 (operands
// staged whole), else 0 (the tiled kernel: k streamed in tiles, rows and
// columns in bands, any length)
inline int size_class(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= kStagedN ? 64 : 0;
}

// whether 16-byte copies reach every stored row of an operand at p with
// rows of row_len elements: p 16-byte aligned and the rows whole chunks
// (so is then every fragment's base)
template <typename T>
bool vec_ok(const T* p, long long row_len) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (row_len * static_cast<long long>(sizeof(T))) % 16 == 0;
}

template <typename T>
int direct(const T* a, const T* b, T* c, int batch, int m, int n, int k,
           int trans_a, int trans_b, int device, void* stream) {
  const long long total = static_cast<long long>(batch) * m * n;
  constexpr int threads = 128;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  return on_device(device, [&] {
    direct_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(
                                               stream)>>>(
        a, b, c, total, m, n, k, trans_a != 0, trans_b != 0);
    return cudaGetLastError();
  });
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// a staged row of n elements: whole 16-byte chunks, an odd number of them
// (so 16-byte reads of consecutive rows by consecutive threads fall on
// distinct banks)
inline int odd_chunks(int n, int e) {
  const int ld = ceil_div(n, e) * e;
  return (ld / e) % 2 == 0 ? ld + e : ld;
}

// The staged layout of a plan whose F and R are set; a stage's elements
template <typename T>
int mv_layout(MvPlan& p) {
  constexpr int E = 16 / sizeof(T);
  p.bands = ceil_div(p.rows, p.R);
  p.units = ceil_div(p.batch, p.F) * p.bands;
  p.ldx = odd_chunks(p.cols, E);
  if (p.in_place) {
    p.units = ceil_div(static_cast<long long>(p.batch) * p.rows, kMvThreads);
    p.ld = p.stage = 0;
  } else if (!p.trans) {
    p.ld = odd_chunks(p.cols, E);
    p.stage = p.F * (p.ldx + p.R * p.ld);
  } else {
    // M's stored rows, a band of R columns each (F = 1: staged in the
    // transposed form only where the rows are cut into bands)
    p.ld = ceil_div(p.R, E) * E;
    p.stage = p.ldx + p.cols * p.ld;
  }
  p.stage = ceil_div(p.stage, E) * E;  // the second stage 16-byte aligned
  return p.stage;
}

// The matvec's plan at (batch, rows, cols) on a card of `sms` SMs (the
// bits do not depend on it): whole fragments, as many a unit as leave two
// units an SM, up to kMvThreads chains; where the batch leaves SMs idle
// (fewer fragments than two an SM), a fragment's rows in bands of at least
// kMvMinBand (a multiple of 8); fewer chains where a stage would pass
// kMvStage bytes.
template <typename T>
void mv_plan(MvPlan& p, int sms) {
  int f = kMvThreads / p.rows;
  if (f > p.batch / (2 * sms)) f = p.batch / (2 * sms);
  p.F = f > 1 ? f : 1;
  p.R = p.rows;
  if (p.F == 1) {
    int bands = ceil_div(2ll * sms, p.batch);
    const int most = ceil_div(p.rows, kMvMinBand);
    if (bands > most) bands = most;
    if (bands < 1) bands = 1;
    p.R = ceil_div(ceil_div(p.rows, bands), 8) * 8;
    if (p.R > kMvThreads) p.R = kMvThreads;
    if (p.R > p.rows) p.R = p.rows;
  }
  // whole fragments read in place: units of kMvThreads outputs
  p.in_place = p.R == p.rows &&
               (p.trans || p.cols * static_cast<int>(sizeof(T)) <=
                               (sizeof(T) == 8 ? kMvInPlaceRow64
                                               : kMvInPlaceRow32));
  while (mv_layout<T>(p) * static_cast<int>(sizeof(T)) > kMvStage &&
         (p.F > 1 || p.R > 8)) {
    if (p.F > 1) {
      --p.F;
    } else {
      p.R = (p.R - 1) / 8 * 8;  // the next multiple of 8 down
    }
  }
}

// The card's SM count and shared memory an SM, queried once per device
cudaError_t mv_card(int device, int* sms, int* smem_sm) {
  static int sms_of[64] = {}, smem_of[64] = {};
  const int slot = device & 63;
  int v = __atomic_load_n(&sms_of[slot], __ATOMIC_ACQUIRE);
  if (v == 0) {
    int s = 0, m = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(
        &m, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (err != cudaSuccess) return err;
    __atomic_store_n(&smem_of[slot], m, __ATOMIC_RELEASE);
    __atomic_store_n(&sms_of[slot], s, __ATOMIC_RELEASE);
    v = s;
  }
  *sms = v;
  *smem_sm = __atomic_load_n(&smem_of[slot], __ATOMIC_ACQUIRE);
  return cudaSuccess;
}

template <typename T>
int matvec(const T* mat, const T* x, T* y, int batch, int rows, int cols,
           int trans, int device, void* stream) {
  if (batch <= 0 || rows <= 0) return 0;
  if (cols < 0 || rows > kMaxN || cols > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    int sms = 0, smem_sm = 0;
    cudaError_t err = mv_card(device, &sms, &smem_sm);
    if (err != cudaSuccess) return err;
    MvPlan p = {};
    p.batch = batch;
    p.rows = rows;
    p.cols = cols;
    p.trans = trans != 0;
    mv_plan<T>(p, sms);
    p.vec_m = vec_ok(mat, trans ? rows : cols);
    p.vec_x = vec_ok(x, cols);
    const size_t smem = 2 * static_cast<size_t>(p.stage) * sizeof(T);
    // blocks an SM holds at this block size and shared memory (1 KB of
    // it the system's a block)
    int per_sm = 2048 / kMvThreads;
    const int by_smem = static_cast<int>(smem_sm / (smem + 1024));
    if (per_sm > by_smem) per_sm = by_smem;
    if (per_sm < 1) per_sm = 1;
    const int grid = p.units < per_sm * sms ? p.units : per_sm * sms;
    const auto st = static_cast<cudaStream_t>(stream);
    if (cols <= 16) {
      matvec_kernel<T, 16><<<grid, kMvThreads, smem, st>>>(mat, x, y, p);
    } else {
      matvec_kernel<T, kMvTileK><<<grid, kMvThreads, smem, st>>>(mat, x, y,
                                                                 p);
    }
    return cudaGetLastError();
  });
}

template <typename T>
int bmm(const T* a, const T* b, T* c, int batch, int m, int n,
        int k, int trans_a, int trans_b, int device, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cls = size_class(m > n ? (m > k ? m : k) : (n > k ? n : k));
  if (m <= kTiny && n <= kTiny && k <= kTiny)
    return direct<T>(a, b, c, batch, m, n, k, trans_a, trans_b, device,
                     stream);
  const int flags = (trans_a ? kTransA : 0) | (trans_b ? kTransB : 0) |
                    (vec_ok(a, trans_a ? m : k) ? kVecA : 0) |
                    (vec_ok(b, trans_b ? k : n) ? kVecB : 0) |
                    (vec_ok(c, n) ? kVecC : 0);
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (cls == 16)
      return launch_bmm<T, 16>(a, b, c, batch, m, n, k, flags, device, st);
    if (cls == 32)
      return launch_bmm<T, 32>(a, b, c, batch, m, n, k, flags, device, st);
    if (cls == 64)
      return launch_bmm<T, 64>(a, b, c, batch, m, n, k, flags, device, st);
    return launch_tiled<T>(a, b, c, batch, m, n, k, flags, device, st);
  });
}

template <typename T>
int sandwich(const T* x, const T* f, const T* s, T* c, int batch, int n,
             int device, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int cls = size_class(n);
  if (cls == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int flags = (vec_ok(x, n) ? kVecA : 0) | (vec_ok(f, n) ? kVecB : 0) |
                    (vec_ok(c, n) && vec_ok(s, n) ? kVecC : 0);
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (cls == 16)
      return launch_sandwich<T, 16>(x, f, s, c, batch, n, flags, device, st);
    if (cls == 32)
      return launch_sandwich<T, 32>(x, f, s, c, batch, n, flags, device, st);
    return launch_sandwich<T, 64>(x, f, s, c, batch, n, flags, device, st);
  });
}

// D3's pair contraction (design in the header, "The pair contraction"): a
// block of P threads takes P consecutive pairs p = (b nat + i) nat + j of
// the flattened batch; their (R, R) grids, one contiguous run of P R^2
// elements (25 KB in f64), are staged into shared memory by 16-byte
// cp.async.cg (an element a copy where the base is not 16-byte aligned,
// and at the array's end); a thread a pair reads its w[b, i] and w[b, j]
// through the read-only cache while the grids land, then runs
//   v[c] = fma(w_i[a], grids[a, c], v[c]) for a ascending from +0,
//   q[c] = v[c] w_j[c] (rounded),
//   c = `pair_sum` of q,
// and stores c coalesced.

// sum_c q[c] in the association of torch's reduction over a short row on
// a card: lane t of H = 2^floor(log2 R) lanes holds (+0 + q[t]) + (+0 +
// q[t + H]) (the second where t + H < R), then the lanes are halved
// pairwise, lane t + h into lane t for h = H / 2, ..., 1
template <typename T, int R>
__device__ __forceinline__ T pair_sum(const T (&q)[R]) {
  constexpr int H = R >= 8 ? 8 : R >= 4 ? 4 : R >= 2 ? 2 : 1;
  T lane[H];
#pragma unroll
  for (int t = 0; t < H; ++t) {
    lane[t] = add_rn(T(0), q[t]);
    if (t + H < R)
      lane[t] = add_rn(lane[t], add_rn(T(0), q[t + H < R ? t + H : t]));
  }
#pragma unroll
  for (int h = H / 2; h > 0; h /= 2) {
#pragma unroll
    for (int t = 0; t < h; ++t) lane[t] = add_rn(lane[t], lane[t + h]);
  }
  return lane[0];
}

template <typename T>
__global__ void __launch_bounds__(kPairThreads)
    pair_bilinear_kernel(const T* __restrict__ w,
                         const T* __restrict__ grids, T* __restrict__ out,
                         long long pairs, int nat, int vec) {
  constexpr int P = kPairThreads, R = kPairR, RR = R * R;
  constexpr int E = 16 / sizeof(T);
  __shared__ __align__(16) T sg[P * RR];
  const long long p0 = static_cast<long long>(blockIdx.x) * P;
  const int np = static_cast<int>(
      pairs - p0 < P ? pairs - p0 : static_cast<long long>(P));
  const int len = np * RR;
  const T* src = grids + p0 * RR;
  const int t = threadIdx.x;
  const int chunks = vec ? len / E : 0;
  for (int q = t; q < chunks; q += P) cp_async16(sg + q * E, src + q * E);
  for (int e = chunks * E + t; e < len; e += P) cp_async(sg + e, src + e);
  cp_async_commit();
  // the pair's weights, while the grids land
  const bool live = t < np;
  const long long p = p0 + (live ? t : 0);
  const long long bi = p / nat;  // b nat + i
  const int j = static_cast<int>(p - bi * nat);
  const int i = static_cast<int>(bi % nat);
  const T* wi = w + bi * R;
  const T* wj = w + (bi - i + j) * R;
  T a[R], b[R], v[R], q[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    a[u] = __ldg(wi + u);
    b[u] = __ldg(wj + u);
    v[u] = T(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  const T* g = sg + t * RR;
#pragma unroll
  for (int x = 0; x < R; ++x) {
#pragma unroll
    for (int c = 0; c < R; ++c) v[c] = fma_(a[x], g[x * R + c], v[c]);
  }
#pragma unroll
  for (int c = 0; c < R; ++c) q[c] = mul_rn(v[c], b[c]);
  out[p] = pair_sum<T, R>(q);
}

template <typename T>
int pair_bilinear(const T* w, const T* grids, T* out, int batch, int nat,
                  int r, int device, void* stream) {
  if (batch <= 0 || nat <= 0) return 0;
  if (r != kPairR) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(batch) * nat * nat;
  const long long blocks = (pairs + kPairThreads - 1) / kPairThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(grids) % 16 == 0 ? 1 : 0;
  return on_device(device, [&] {
    pair_bilinear_kernel<T><<<static_cast<unsigned>(blocks), kPairThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        w, grids, out, pairs, nat, vec);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// a: (batch, m, k), or (batch, k, m) with trans_a; b: (batch, k, n), or
// (batch, n, k) with trans_b; c: (batch, m, n). Any sizes (above 64 in
// the tiled class). Any element-aligned base address (a view with a
// storage offset).
int mqc_fragment_bmm_f32(const float* a, const float* b, float* c,
                         int batch, int m, int n, int k, int trans_a,
                         int trans_b, int device, void* stream) {
  return bmm<float>(a, b, c, batch, m, n, k, trans_a, trans_b, device,
                    stream);
}

int mqc_fragment_bmm_f64(const double* a, const double* b, double* c,
                         int batch, int m, int n, int k, int trans_a,
                         int trans_b, int device, void* stream) {
  return bmm<double>(a, b, c, batch, m, n, k, trans_a, trans_b, device,
                     stream);
}

// x, f, s, c: (batch, n, n), n <= 64 (above, the wrapper runs two
// products and an add)
int mqc_fragment_sandwich_f32(const float* x, const float* f, const float* s,
                              float* c, int batch, int n, int device,
                              void* stream) {
  return sandwich<float>(x, f, s, c, batch, n, device, stream);
}

int mqc_fragment_sandwich_f64(const double* x, const double* f,
                              const double* s, double* c, int batch, int n,
                              int device, void* stream) {
  return sandwich<double>(x, f, s, c, batch, n, device, stream);
}

// mat: (batch, rows, cols), or (batch, cols, rows) with trans; x: (batch,
// cols); y: (batch, rows). rows, cols <= 256.
int mqc_fragment_matvec_f32(const float* mat, const float* x, float* y,
                            int batch, int rows, int cols, int trans,
                            int device, void* stream) {
  return matvec<float>(mat, x, y, batch, rows, cols, trans, device, stream);
}

int mqc_fragment_matvec_f64(const double* mat, const double* x, double* y,
                            int batch, int rows, int cols, int trans,
                            int device, void* stream) {
  return matvec<double>(mat, x, y, batch, rows, cols, trans, device, stream);
}

// w: (batch, nat, r), grids: (batch, nat, nat, r, r), c: (batch, nat,
// nat); r = 5
int mqc_pair_bilinear_f32(const float* w, const float* grids, float* c,
                          int batch, int nat, int r, int device,
                          void* stream) {
  return pair_bilinear<float>(w, grids, c, batch, nat, r, device, stream);
}

int mqc_pair_bilinear_f64(const double* w, const double* grids, double* c,
                          int batch, int nat, int r, int device,
                          void* stream) {
  return pair_bilinear<double>(w, grids, c, batch, nat, r, device, stream);
}

const char* mqc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
