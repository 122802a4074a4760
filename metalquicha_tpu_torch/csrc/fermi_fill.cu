// Fermi-level fill of a fragment batch's two spin channels, and the
// density built from it.
//
// Replaces, in metalquicha_tpu/methods/xtb/engine.py:
// - `_fermi_fill` (:324; its 80-step lax.fori_loop at :343), called twice
//   by `occupations` (:361): entry points mqc_fermi_fill_*;
// - with it, the density product of the SCC's `make_density`
//   (`(C * f[None, :]) @ C.T`, :787-793): entry points mqc_fermi_density_*,
//   which return P = C diag(f) C^T and no f (nao <= 64).
// Under jax.jit XLA compiles the loop and the product into the SCC's loop
// on the device; these kernels are their counterpart for the port, whose
// plain torch version (ops/fermi_fill.py) makes about 13 launches per
// bisection step. Neither is a Pallas kernel: the JAX package writes them
// in jnp.
//
// For one row (a fragment's spin channel, n_el = 0.5 (nelec +- nuhf)
// electrons) the fill computes, as the JAX function does:
//   e = ao_mask > 0.5 ? eps : 1e3  (masked AOs read 1e3 in the sum),
//   lo = min e - 10, hi = max (ao_mask > 0.5 ? e : -1e3) + 10,
//   occ(mu) = 1 / (1 + exp(clamp((e - mu) / kt, -60, 60))),
//   up to 80 steps: mid = 0.5 (lo + hi); sum occ(mid) > n_el ? hi = mid
//   : lo = mid,
//   f = occ(0.5 (lo + hi)), fc = clamp(f, 1e-30, 1 - 1e-30),
//   entropy = sum over 1e-12 < f < 1 - 1e-12 of
//             -(fc log fc + (1 - fc) log(1 - fc)),
// with a division by kt (not a product with 1/kt) and the strict test.
// The row's values may come in any order (the Jacobi route leaves its
// eigenvalues unsorted). mqc_fermi_fill_* writes f_alpha + f_beta (B, nao)
// and the two channels' entropies summed (B,), and optionally the steps
// each channel took (B, 2).
//
// What bounds it. Per row and step: nao subtractions, divisions, clamps,
// exps (about 20 FP64 or 8 FP32 operations each), adds, reciprocals and
// the row sum; each step depends on the one before. A small batch (the
// 512-dimer slice: 1024 rows of 16, every block resident at once) is
// bound by the latency of the chain of steps: a division, an exp, a
// second division and the sum's shuffles. A large one ((5985, 32), the
// w20 MBE(4) chunk: two waves of blocks) is bound by the FP64 pipes. The
// fused density adds 2 nao^3 FLOP per fragment (4 kFLOP at nao 16, 0.5
// MFLOP at 64) on the FP64 tensor cores, and the read of C: 2 KB to 32 KB
// per fragment.
//
// What the design does about it (every point keeps the 80-step result
// bit for bit):
// - The bisection stops at its fixed point. Once a step leaves (lo, hi)
//   unchanged every later step repeats it, so the state is the 80-step
//   state. In f64 a row gets there after about 60 steps, in f32 after
//   about 30. A NaN never compares equal: a NaN row runs all 80 steps.
//   The test is the same in every lane of the row's lanes, which leave
//   the loop together.
// - Runs of clamped steps are skipped. Where every level's (e - mid) / kt
//   is clamped to +-60 in a step, every occ is one of two constants, so
//   the row sum, and the decision, is that of any later mid that leaves
//   every level on its side. The margins (`Margins`: the least d with
//   d / kt >= 60 by this device's division, found by a warp testing 32
//   candidate ulps around 60 kt at once, and the same below -60, the
//   division rounding symmetrically about 0) turn that into
//   two tests a step on the nearest level above and below: rounding is
//   monotone, so they hold for every level. Such steps take the scalar
//   recurrence alone (`Bracket::skip`): the same mid, the same decision,
//   the same stop. On gapped rows they are the first few steps only: mu's
//   fixed point lies within 60 kT of the lowest empty level (about 35 kT
//   below it in f64), so the steps that close in on it all evaluate. So a
//   bisection notes clamped exponents only while its bracket is wider
//   than kRunWidth margins (`Margins::runs`), and then takes the plain
//   steps.
// - Rows of nao <= 16 (<= 8) take a half-warp (quarter-warp) each, and
//   the row sum's butterfly runs only the levels inside it: one (two)
//   shuffle levels fewer per step. The levels dropped added the zeros of
//   lanes >= nao, so no bit changes. A warp holds both channels of a
//   fragment, lanes 0-15 alpha and 16-31 beta; f_alpha + f_beta is one
//   __shfl_xor_sync(..., 16). A block holds 4 (8) fragments.
// - A closed shell (nuhf 0) is filled once: both channels have the same
//   n_el and the same arithmetic, so f_alpha + f_beta = 2 f_alpha and
//   s_alpha + s_beta = 2 s_alpha exactly. In the fill, the beta channel's
//   warp (or half-warp) skips the bisection; in a launch bound by the
//   FP64 pipes that frees them for other warps.
// - Rows longer than 16 take a warp per channel, two warps per fragment
//   (a block each), the row in K = 1, 2, 4 or 8 registers per lane; a row
//   longer than 256 is read again from device memory (through L1) at every
//   step. The beta warp adds its f to the alpha warp's after one barrier.
// - The fused density (nao <= 64, one launch per SCC iteration in place of
//   the fill, the product and a round trip of f through device memory):
//   the block first issues cp.async copies of the fragment's C into shared
//   memory, which complete while the latency-bound bisection runs, so the
//   load of C is hidden behind it. f goes to shared memory. In f64 P's 8 x
//   8 tiles run on the FP64 tensor cores (nao padded to a multiple of 8
//   with zeros; the A operand C[i][j] f[j] scaled in registers as it is
//   read, which rounds as a scaled copy in shared memory would; k in
//   blocks of 4 ascending; every tile computed, none mirrored). In f32 the
//   product is plain FP32 FMAs from shared memory: the tensor cores have
//   no full-f32 mode, and TF32 would drop 13 bits that the port's f32
//   products keep.
// - Lanes the fill leaves idle evaluate the bisection ahead. A step's two
//   possible successors are known before its decision: mid's left half
//   if it had too many electrons, the right half if not. So G groups of
//   lanes evaluate the nodes 1..G of the tree of steps in heap order (node
//   n's successors 2n and 2n + 1) at once, each with the same arithmetic
//   as the one step it stands for, and every lane then walks the tree
//   with the decisions (`walk`). Up to 32 AOs (the packed class, a warp a
//   fragment, kPackedWarps fragments a block) a closed shell's beta half
//   evaluates node 2: 1.5 steps a round; an open shell's halves take
//   their own steps. Smaller groups of lanes, each lane holding several
//   levels, were measured and lost: a round cost more than the steps it
//   took (tools/fermi_variants_torch.py). Above 32, where the batch leaves
//   the card underfilled (kWideAheadPerSM), a group is a warp of a block
//   of kWideWarps, the decisions exchanged through shared memory and one
//   barrier a round. Blocks of two warps (rows of 17-32, and of 33-64 in
//   a larger batch) take their steps one at a time: there, evaluating
//   ahead on the second warp lost to the warp's own channel.
// - f64 rows of 17-32 take a half-warp each where the batch fills the card
//   (kPacked32PerSM), two values a lane added in the warp butterfly's
//   first pair, so the sum keeps the fill's bits: an open shell's two
//   channels share one warp's exp and division chains, a lane's clamped
//   level takes occ(+-60) and its others are evaluated one chain a pass.
//   A smaller batch, and f32 (whose product is one FMA chain an output),
//   takes a block of two warps, one a channel.
// - Above 32 AOs every warp of the block stages C and runs the product
//   (m16n8k4: two 8 x 8 tiles a product, the same sums as m8n8k4), and in
//   f64 C's rows are copied in 16-byte pieces, each stored row shifted by
//   the parity of its address (odd nao), which the operand loads add
//   back.
//
// The kernels launch on the caller's stream, allocate nothing, and the C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSteps = 80;
constexpr int kMaxK = 8;  // registers per lane for the row: nao <= 256
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPackedWarps = 4;  // warps per block of the packed rows
constexpr int kDensityMaxN = 64;
constexpr int kWideWarps = 8;     // warps a fragment > 32 evaluating ahead
// f64 rows of 17-32 on a half-warp each where the batch has this many
// fragments a multiprocessor (fewer, and f32: blocks of two warps)
constexpr int kPacked32PerSM = 16;
// rows of 33-64 on blocks of kWideWarps evaluating the bisection ahead
// where the batch has at most this many fragments a multiprocessor (more:
// blocks of two warps)
constexpr int kWideAheadPerSM = 3;
// a step whose exponents are all clamped is followed by its run of
// repeats (`Bracket::skip`), tested while the bracket is wider than
// kRunWidth margins: the runs of a gapped row are its first steps
constexpr int kRunWidth = 32;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float ln(float x) { return logf(x); }
__device__ __forceinline__ double ln(double x) { return log(x); }

// torch.clamp: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// min and max that keep a NaN, and give both lanes of a butterfly pair the
// same value
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// Butterflies over a group of W lanes (W a power of two <= 32), `mask`
// its lanes: every lane of the group ends with the same bits.
template <int W, typename T>
__device__ __forceinline__ T group_sum(T v, unsigned mask) {
#pragma unroll
  for (int m = W / 2; m > 0; m >>= 1) v += __shfl_xor_sync(mask, v, m);
  return v;
}
template <int W, typename T>
__device__ __forceinline__ T group_min(T v, unsigned mask) {
#pragma unroll
  for (int m = W / 2; m > 0; m >>= 1)
    v = min_nan(v, __shfl_xor_sync(mask, v, m));
  return v;
}
template <int W, typename T>
__device__ __forceinline__ T group_max(T v, unsigned mask) {
#pragma unroll
  for (int m = W / 2; m > 0; m >>= 1)
    v = max_nan(v, __shfl_xor_sync(mask, v, m));
  return v;
}

// the lanes of the calling lane's group of W
template <int W>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (W == kWarp) {
    return kFull;
  } else {
    return ((1u << W) - 1u) << (lane & ~(W - 1));
  }
}

// occ of a level d = e - mu above mu
template <typename T>
__device__ __forceinline__ T occ_of(T d, T kt) {
  const T x = clip(d / kt, T(-60.0), T(60.0));
  return T(1) / (T(1) + ex(x));
}

template <typename T>
__device__ __forceinline__ T occ(T e, T mu, T kt) {
  return occ_of(e - mu, kt);
}

template <typename T>
__device__ __forceinline__ T entropy_of(T f) {
  if (!(f > T(1.0e-12) && f < T(1.0 - 1.0e-12))) return T(0);
  const T fc = clip(f, T(1.0e-30), T(1.0 - 1.0e-30));
  return -(fc * ln(fc) + (T(1) - fc) * ln(T(1) - fc));
}

// ---------------------------------------------------------------------------
// The bisection's state, and its runs of clamped steps
// ---------------------------------------------------------------------------

// x moved k ulps (x positive and finite, the result too): on its bits
__device__ __forceinline__ double ulps(double x, int k) {
  return __longlong_as_double(__double_as_longlong(x) + k);
}
__device__ __forceinline__ float ulps(float x, int k) {
  return __int_as_float(__float_as_int(x) + k);
}

// The margin of the clamp at 60: the least m > 0 with m / kt >= 60 by this
// device's division, among 60 kt - 16 ulps, ..., 60 kt + 15 ulps, a lane
// each (called by whole warps: one division's latency). NaN where kt is
// not positive or none of them is past: no d then compares past it. The
// division rounds (-m) / kt to -(m / kt), so it is the margin of the clamp
// at -60 too.
template <typename T>
__device__ T clamp_margin(T kt) {
  const T m0 = T(60.0) * kt;
  if (!(kt > T(0) && m0 > T(1.0e-30) && m0 < T(1.0e30)))
    return static_cast<T>(NAN);
  const T m = ulps(m0, static_cast<int>(threadIdx.x % kWarp) - 16);
  const unsigned past = __ballot_sync(kFull, m / kt >= T(60.0));
  if (past == 0u) return static_cast<T>(NAN);
  return ulps(m0, __ffs(past) - 17);
}

// A level d = e - mid above mid has its exponent clamped to 60 where
// d >= hi, to -60 where d <= -lo: rounding is monotone, so these are the
// tests (d / kt >= 60, d / kt <= -60) themselves. Made by whole warps.
template <typename T>
struct Margins {
  T hi, lo;

  __device__ explicit Margins(T kt) : hi(clamp_margin(kt)), lo(hi) {}

  __device__ __forceinline__ bool high(T d) const { return d >= hi; }

  // occ of d = e - mid, and whether its exponent was clamped
  __device__ __forceinline__ T occ(T d, T kt, bool* was_clamped) const {
    *was_clamped = (d >= hi) | (d <= -lo);
    return occ_of(d, kt);
  }

  // whether a run of clamped steps may still start from `br`: its bracket
  // wider than kRunWidth margins (the steps are exact either way)
  template <typename B>
  __device__ __forceinline__ bool runs(const B& br) const {
    return br.hi - br.lo >= T(kRunWidth) * hi;
  }
};

// (lo, hi) of a row and the steps taken; `done` after the first step that
// leaves (lo, hi) unchanged (every later step would repeat it), or the
// 80th.
template <typename T>
struct Bracket {
  T lo, hi;
  int step;
  bool done;

  __device__ Bracket(T lo_, T hi_) : lo(lo_), hi(hi_), step(0), done(false) {}

  __device__ __forceinline__ T mid() const { return T(0.5) * (lo + hi); }

  // the step at mid = mid() with its decision
  __device__ __forceinline__ void take(T mid, bool too_many) {
    const T old = too_many ? hi : lo;
    if (too_many) {
      hi = mid;
    } else {
      lo = mid;
    }
    ++step;
    done = mid == old || step >= kSteps;  // a NaN never compares equal
  }

  // After a step at a mid where every level's exponent was clamped, the
  // lowest level clamped to 60 being eh and the highest clamped to -60 el:
  // the steps while mid leaves both (so every level) on its side, each
  // with that step's decision.
  __device__ __forceinline__ void skip(T eh, T el, bool too_many,
                                       const Margins<T>& mg) {
    while (!done) {
      const T m = mid();
      if (!(eh - m >= mg.hi && el - m <= -mg.lo)) break;
      take(m, too_many);
    }
  }
};

// The row's values seen by one lane of a group of W: element j0 + W k.
// K > 0 in registers, K == 0 read from device memory at every visit.
template <typename T, int W, int K>
struct Row {
  T e[K > 0 ? K : 1];
  const T* eps;
  const T* mask;
  int nao;
  int j0;

  __device__ __forceinline__ T masked(int j) const {
    return mask[j] > T(0.5) ? eps[j] : T(1.0e3);
  }

  __device__ __forceinline__ void load() {
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + W * k;
        e[k] = j < nao ? masked(j) : T(0);
      }
    }
  }

  // fn(j, e_j) for the lane's values in order
  template <typename Fn>
  __device__ __forceinline__ void visit(Fn fn) const {
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + W * k;
        if (j < nao) fn(j, e[k]);
      }
    } else {
      for (int j = j0; j < nao; j += W) fn(j, masked(j));
    }
  }

  // the initial bracket: min e - 10, max of the real AOs' e + 10
  __device__ __forceinline__ Bracket<T> bracket(unsigned mask) const {
    const T inf = static_cast<T>(INFINITY);
    T lo = inf, hi = -inf;
    visit([&](int j, T e) {
      lo = min_nan(lo, e);
      hi = max_nan(hi, this->mask[j] > T(0.5) ? e : T(-1.0e3));
    });
    return Bracket<T>(group_min<W>(lo, mask) - T(10.0),
                      group_max<W>(hi, mask) + T(10.0));
  }

  // the row sum at mid: the lane's values in order, then the butterfly
  __device__ __forceinline__ T sum(T mid, T kt, unsigned mask) const {
    T n = T(0);
    visit([&](int, T e) { n += occ(e, mid, kt); });
    return group_sum<W>(n, mask);
  }

  // the same, noting whether every exponent of the lane's values was
  // clamped
  __device__ __forceinline__ T sum_noting(T mid, T kt, const Margins<T>& mg,
                                          unsigned mask,
                                          bool* clamped) const {
    T n = T(0);
    bool c = true;
    visit([&](int, T e) {
      bool ci;
      n += mg.occ(e - mid, kt, &ci);
      c &= ci;
    });
    *clamped = c;
    return group_sum<W>(n, mask);
  }

  // the lowest level clamped to 60 and the highest to -60 at mid
  __device__ __forceinline__ void extremes(T mid, const Margins<T>& mg,
                                           unsigned mask, T* eh,
                                           T* el) const {
    const T inf = static_cast<T>(INFINITY);
    T h = inf, l = -inf;
    visit([&](int, T e) {
      if (mg.high(e - mid)) {
        h = min_nan(h, e);
      } else {
        l = max_nan(l, e);
      }
    });
    *eh = group_min<W>(h, mask);
    *el = group_max<W>(l, mask);
  }
};

// The bisection of one row by its group of W lanes: mu, and the steps
// taken. While the bracket may hold a run of clamped steps, a step whose
// exponents were all clamped is followed by its run (`Bracket::skip`);
// then the plain steps.
template <typename T, int W, int K>
__device__ __forceinline__ T bisect(const Row<T, W, K>& row, T n_el, T kt,
                                    const Margins<T>& mg, unsigned mask,
                                    int* steps) {
  Bracket<T> br = row.bracket(mask);
  while (!br.done && mg.runs(br)) {
    const T mid = br.mid();
    bool clamped;
    const bool too_many = row.sum_noting(mid, kt, mg, mask, &clamped) > n_el;
    br.take(mid, too_many);
    if (!br.done && __all_sync(mask, clamped)) {
      T eh, el;
      row.extremes(mid, mg, mask, &eh, &el);
      br.skip(eh, el, too_many, mg);
    }
  }
  while (!br.done) {
    const T mid = br.mid();
    br.take(mid, row.sum(mid, kt, mask) > n_el);
  }
  *steps = br.step;
  return br.mid();
}

// The mid of node `node` (of depth below D) of the tree of steps from `br`
// (node 1 the next step; 2n and 2n + 1 the step after n where n had too
// many electrons and where it had not), each halving as the step it
// stands for would.
template <int D, typename T>
__device__ __forceinline__ T node_mid(const Bracket<T>& br, int node) {
  T a = br.lo, b = br.hi;
  const int depth = 31 - __clz(node);
#pragma unroll
  for (int l = D - 1; l >= 0; --l) {
    if (l < depth) {
      const T m = T(0.5) * (a + b);
      if ((node >> l) & 1) {
        a = m;
      } else {
        b = m;
      }
    }
  }
  return T(0.5) * (a + b);
}

// Walk the tree of nodes 1..groups with their decisions (`vote(h)`: bit 0
// too many electrons at node h + 1, bit 1 every exponent clamped there,
// noted where kNote), then the run of clamped steps after the last where
// it was clamped (`extremes(mid, &eh, &el)`).
template <bool kNote, typename T, typename Vote, typename Extremes>
__device__ __forceinline__ void walk(Bracket<T>& br, int groups,
                                     const Margins<T>& mg, Vote vote,
                                     Extremes extremes) {
  int node = 1;
  T mid = T(0);
  int last = 0;
  while (!br.done && node <= groups) {
    last = vote(node - 1);
    mid = br.mid();
    br.take(mid, last & 1);
    node = 2 * node + ((last & 1) ? 0 : 1);
  }
  if (kNote && !br.done && (last & 2)) {
    T eh, el;
    extremes(mid, &eh, &el);
    br.skip(eh, el, last & 1, mg);
  }
}

// ---------------------------------------------------------------------------
// The fill alone
// ---------------------------------------------------------------------------

// Rows of nao <= W <= 16: a warp holds 16 / W fragments, lanes 0-15 their
// alpha channels and lanes 16-31 their beta channels, W lanes a row; a
// block holds kPackedWarps such warps.
template <typename T, int W>
__global__ void __launch_bounds__(kPackedWarps* kWarp)
    fermi_fill_packed(const T* __restrict__ eps, const T* __restrict__ mask,
                      const T* __restrict__ nelec,
                      const T* __restrict__ nuhf, T kt, T* __restrict__ f,
                      T* __restrict__ entropy, int* __restrict__ steps,
                      int batch, int nao) {
  constexpr int kPerWarp = 16 / W;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int j = lane % W;
  const bool beta = lane >= 16;
  const int b = (blockIdx.x * kPackedWarps + warp) * kPerWarp +
                (lane % 16) / W;
  const bool valid = b < batch;
  const bool closed = valid && nuhf[b] == T(0);
  const unsigned gmask = group_mask<W>(lane);
  const size_t off = static_cast<size_t>(valid ? b : 0) * nao;
  const Margins<T> mg(kt);

  Row<T, W, 1> row;
  row.eps = eps + off;
  row.mask = mask + off;
  row.nao = nao;
  row.j0 = j;

  T fj = T(0), s = T(0);
  int taken = 0;
  if (valid && !(beta && closed)) {
    row.load();
    const T n_el = beta ? T(0.5) * (nelec[b] - nuhf[b])
                        : T(0.5) * (nelec[b] + nuhf[b]);
    const T mu = bisect(row, n_el, kt, mg, gmask, &taken);
    row.visit([&](int, T e) {
      fj = occ(e, mu, kt);
      s += entropy_of(fj);
    });
    s = group_sum<W>(s, gmask);
  }
  // f_alpha + f_beta and s_alpha + s_beta, in that order, as the
  // 80-step kernel adds them
  const T f_other = __shfl_xor_sync(kFull, fj, 16);
  const T s_other = __shfl_xor_sync(kFull, s, 16);
  if (!valid) return;
  if (!beta) {
    if (j < nao) f[off + j] = fj + (closed ? fj : f_other);
    if (j == 0) entropy[b] = s + (closed ? s : s_other);
  }
  if (steps != nullptr && j == 0) steps[2 * b + beta] = taken;
}

// Rows longer than 16: a block of two warps per fragment, warp 0 on the
// alpha channel and warp 1 on the beta channel.
template <typename T, int K>
__global__ void __launch_bounds__(2 * kWarp)
    fermi_fill_warps(const T* __restrict__ eps, const T* __restrict__ mask,
                     const T* __restrict__ nelec, const T* __restrict__ nuhf,
                     T kt, T* __restrict__ f, T* __restrict__ entropy,
                     int* __restrict__ steps, int nao) {
  __shared__ T entropy_alpha;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const bool beta = threadIdx.x >= kWarp;
  const bool closed = nuhf[b] == T(0);
  const size_t off = static_cast<size_t>(b) * nao;
  const Margins<T> mg(kt);

  Row<T, kWarp, K> row;
  row.eps = eps + off;
  row.mask = mask + off;
  row.nao = nao;
  row.j0 = lane;

  T* f_row = f + off;
  T mu = T(0), s = T(0);
  int taken = 0;
  if (!(beta && closed)) {
    row.load();
    const T n_el = beta ? T(0.5) * (nelec[b] - nuhf[b])
                        : T(0.5) * (nelec[b] + nuhf[b]);
    mu = bisect(row, n_el, kt, mg, kFull, &taken);
  }
  if (!beta) {
    row.visit([&](int j, T e) {
      const T fj = occ(e, mu, kt);
      f_row[j] = closed ? fj + fj : fj;
      s += entropy_of(fj);
    });
    s = group_sum<kWarp>(s, kFull);
    if (lane == 0) {
      if (closed) {
        entropy[b] = s + s;
      } else {
        entropy_alpha = s;
      }
    }
  }
  if (steps != nullptr && lane == 0) steps[2 * b + beta] = taken;
  // f_alpha and its entropy are visible to warp 1 after the barrier
  __syncthreads();
  if (beta && !closed) {
    row.visit([&](int j, T e) {
      const T fj = occ(e, mu, kt);
      f_row[j] = f_row[j] + fj;
      s += entropy_of(fj);
    });
    s = group_sum<kWarp>(s, kFull);
    if (lane == 0) entropy[b] = entropy_alpha + s;
  }
}

template <typename T>
cudaError_t launch_fill(const T* eps, const T* mask, const T* nelec,
                        const T* nuhf, T kt, T* f, T* entropy, int* steps,
                        int batch, int nao, cudaStream_t stream) {
  if (nao <= 8) {
    constexpr int per_block = kPackedWarps * 2;
    fermi_fill_packed<T, 8>
        <<<(batch + per_block - 1) / per_block, kPackedWarps * kWarp, 0,
           stream>>>(eps, mask, nelec, nuhf, kt, f, entropy, steps, batch,
                     nao);
  } else if (nao <= 16) {
    constexpr int per_block = kPackedWarps;
    fermi_fill_packed<T, 16>
        <<<(batch + per_block - 1) / per_block, kPackedWarps * kWarp, 0,
           stream>>>(eps, mask, nelec, nuhf, kt, f, entropy, steps, batch,
                     nao);
  } else {
    const int k = (nao + kWarp - 1) / kWarp;
    auto* kernel = k <= 1       ? &fermi_fill_warps<T, 1>
                   : k <= 2     ? &fermi_fill_warps<T, 2>
                   : k <= 4     ? &fermi_fill_warps<T, 4>
                   : k <= kMaxK ? &fermi_fill_warps<T, kMaxK>
                                : &fermi_fill_warps<T, 0>;
    kernel<<<batch, 2 * kWarp, 0, stream>>>(eps, mask, nelec, nuhf, kt, f,
                                            entropy, steps, nao);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fill and P = C diag(f) C^T in one launch (nao <= 64)
// ---------------------------------------------------------------------------

// Row stride of C in shared memory: f64 with 4 more than a multiple of 16
// (the m8n8k4 operands' 8 rows x 4 columns fall on distinct banks; even,
// so that a row shifted by one element keeps its 16-byte pieces aligned);
// f32 odd (a warp reads 32 rows of one column)
template <typename T, int N>
struct Tile {
  static constexpr int ld = sizeof(T) == 8 ? N + 4 : N + 1;
};

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
__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of C (nao x nao) into cs (N x ld) by `nthreads` threads
// from `tid`, and zero the padding rows and columns below N.
template <typename T, int N>
__device__ __forceinline__ void load_c(T* cs, const T* c, int nao, int tid,
                                       int nthreads) {
  constexpr int ld = Tile<T, N>::ld;
  const int pad = (nao + 7) & ~7;
  for (int idx = tid; idx < pad * pad; idx += nthreads) {
    const int i = idx / pad, j = idx % pad;
    if (i < nao && j < nao) {
      cp_async(cs + i * ld + j, c + i * nao + j);
    } else {
      cs[i * ld + j] = T(0);
    }
  }
}

// The shift of C's row i in shared memory: the parity of its address in
// elements (c0 the parity of C's first element), so that the row's pairs
// that are 16-byte aligned in device memory are in shared memory too.
__device__ __forceinline__ int row_shift(int c0, int i, int nao) {
  return (c0 + i * nao) & 1;
}

// The same for f64 C in 16-byte pieces: row i's element j at cs[i ld +
// row_shift(i) + j]: a row starting 16-byte aligned is its pairs from
// element 0 and an odd last element alone; else element 0 alone, then the
// pairs from element 1 (and an odd last element alone). The padding
// columns of the rows < nao zeroed; the padding rows feed only outputs
// that are not stored.
template <int N>
__device__ __forceinline__ void load_c_pairs(double* cs, const double* c,
                                             int nao, int tid,
                                             int nthreads) {
  constexpr int ld = Tile<double, N>::ld;
  const int pad = (nao + 7) & ~7;
  const int c0 = static_cast<int>((reinterpret_cast<uintptr_t>(c) >> 3) & 1);
  const int pieces = (nao + 2) / 2;
  for (int idx = tid; idx < nao * pieces; idx += nthreads) {
    const int i = idx / pieces, q = idx % pieces;
    const int sh = row_shift(c0, i, nao);
    const int j = 2 * q - sh;
    double* dst = cs + i * ld + sh;
    const double* src = c + static_cast<size_t>(i) * nao;
    if (j < 0 || j + 1 == nao) {
      const int jj = j < 0 ? 0 : j;
      cp_async(dst + jj, src + jj);
    } else if (j + 1 < nao) {
      cp_async16(dst + j, src + j);
    }
  }
  const int extra = pad - nao;
  for (int idx = tid; idx < nao * extra; idx += nthreads) {
    const int i = idx / extra, j = nao + idx % extra;
    cs[i * ld + row_shift(c0, i, nao) + j] = 0.0;
  }
}

// P's rows and columns [0, nao) from C in shared memory and f (zero past
// nao): in f64 the 8 x 8 tiles tile0, tile0 + tiles_step, ... on the FP64
// tensor cores; called by whole warps.
template <int N>
__device__ __forceinline__ void product(const double* cs, const double* fs,
                                        double* p, int nao, int lane,
                                        int tile0, int tiles_step) {
  constexpr int ld = Tile<double, N>::ld;
  const int pad = (nao + 7) & ~7;
  const int nt = pad / 8;
  const int g = lane >> 2, t = lane & 3;
  for (int tile = tile0; tile < nt * nt; tile += tiles_step) {
    const int ti = tile / nt, tk = tile % nt;
    const double* a_row = cs + (ti * 8 + g) * ld;
    const double* b_row = cs + (tk * 8 + g) * ld;
    double d0 = 0.0, d1 = 0.0;
    for (int k0 = 0; k0 < pad; k0 += 4) {
      const int j = k0 + t;
      const double a = a_row[j] * fs[j];
      const double b = b_row[j];
      asm volatile(
          "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
          "{%3}, {%0, %1};\n"
          : "+d"(d0), "+d"(d1)
          : "d"(a), "d"(b));
    }
    const int i = ti * 8 + g, k = tk * 8 + 2 * t;
    if (i < nao) {
      if (k < nao) p[i * nao + k] = d0;
      if (k + 1 < nao) p[i * nao + k + 1] = d1;
    }
  }
}

// in f32: element idx0, idx0 + step, ... of P, each a dot product of FMAs
template <int N>
__device__ __forceinline__ void product(const float* cs, const float* fs,
                                        float* p, int nao, int idx0,
                                        int step) {
  constexpr int ld = Tile<float, N>::ld;
  for (int idx = idx0; idx < nao * nao; idx += step) {
    const int i = idx / nao, k = idx % nao;
    const float* a_row = cs + i * ld;
    const float* b_row = cs + k * ld;
    float acc = 0.0f;
    for (int j = 0; j < nao; ++j) acc = fmaf(a_row[j] * fs[j], b_row[j], acc);
    p[idx] = acc;
  }
}

// rows g (a0; d0, d1) and g + 8 (a1; d2, d3) of a 16 x 8 tile: two 8 x 8
// tiles, each output summed as m8n8k4 sums it
__device__ __forceinline__ void mma1684(double& d0, double& d1, double& d2,
                                        double& d3, double a0, double a1,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// P from C staged by `load_c_pairs` (c0 the parity of C's first element),
// by `nwarps` warps from `warp`: (16-row, 8-column) units, two a warp at a
// time; the second 8 rows of the last unit may be padding (computed,
// never stored).
template <int N>
__device__ __forceinline__ void product_pairs(const double* cs,
                                              const double* fs, double* p,
                                              int nao, int c0, int warp,
                                              int nwarps, int lane) {
  constexpr int ld = Tile<double, N>::ld;
  const int pad = (nao + 7) & ~7;
  const int nt = pad / 8;
  const int units = ((nt + 1) / 2) * nt;
  const int g = lane >> 2, t = lane & 3;
  auto row = [&](int i) { return cs + i * ld + row_shift(c0, i, nao); };
  auto store = [&](int i, int k, double v0, double v1) {
    if (i < nao) {
      if (k < nao) p[i * nao + k] = v0;
      if (k + 1 < nao) p[i * nao + k + 1] = v1;
    }
  };
  for (int u = warp; u < units; u += 2 * nwarps) {
    const int v = u + nwarps;
    const bool two = v < units;
    const int i0 = (u / nt) * 16 + g, k0 = (u % nt) * 8;
    const int i1 = (v / nt) * 16 + g, k1 = (v % nt) * 8;
    const double* a0 = row(i0);
    const double* a1 = row(i0 + 8);
    const double* b0 = row(k0 + g);
    const double* a2 = row(two ? i1 : i0);
    const double* a3 = row(two ? i1 + 8 : i0 + 8);
    const double* b1 = row(two ? k1 + g : k0 + g);
    double d[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int kk = 0; kk < pad; kk += 4) {
      const int j = kk + t;
      const double fj = fs[j];
      mma1684(d[0], d[1], d[2], d[3], a0[j] * fj, a1[j] * fj, b0[j]);
      if (two) mma1684(d[4], d[5], d[6], d[7], a2[j] * fj, a3[j] * fj, b1[j]);
    }
    store(i0, k0 + 2 * t, d[0], d[1]);
    store(i0 + 8, k0 + 2 * t, d[2], d[3]);
    if (two) {
      store(i1, k1 + 2 * t, d[4], d[5]);
      store(i1 + 8, k1 + 2 * t, d[6], d[7]);
    }
  }
}

// A row of nao <= W as the fill's W lanes hold it (lane j element j, the
// sum's butterfly W / 2, ..., 2, 1: a half-warp's rows up to 16, a warp's
// up to 32), held by a half-warp: lane p the elements p and, at W = 32,
// p + 16. The butterfly's level 16 is the lane's own pair; the levels
// below are the same shuffles, so every row sum keeps its bits.
template <typename T, int W>
struct PackedRow {
  static constexpr int L = 16;
  static constexpr int E = W / L;
  T e[E];
  int nao;
  int p;
  T occ_hi, occ_lo;  // occ at the clamps (+60, -60), by the same arithmetic

  __device__ __forceinline__ void clamps(const Margins<T>& mg, T kt) {
    if constexpr (E > 1) {
      occ_hi = occ_of(mg.hi, kt);
      occ_lo = occ_of(-mg.lo, kt);
    }
  }

  __device__ __forceinline__ void load(const T* eps, const T* mask) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = p + L * i;
      e[i] = j < nao ? (mask[j] > T(0.5) ? eps[j] : T(1.0e3)) : T(0);
    }
  }

  __device__ __forceinline__ Bracket<T> bracket(const T* mask,
                                                unsigned gmask) const {
    const T inf = static_cast<T>(INFINITY);
    T lo = inf, hi = -inf;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = p + L * i;
      if (j < nao) {
        lo = min_nan(lo, e[i]);
        hi = max_nan(hi, mask[j] > T(0.5) ? e[i] : T(-1.0e3));
      }
    }
    return Bracket<T>(group_min<L>(lo, gmask) - T(10.0),
                      group_max<L>(hi, gmask) + T(10.0));
  }

  // the row sum at mid, noting (kNote) whether every exponent of the
  // lane's values was clamped. Where a lane holds two values, its clamped
  // values take occ(+-60) (a constant of the clamp) and the others are
  // evaluated one a pass, a single exp and division chain each: a pass
  // for the warp where every lane has at most one value unclamped.
  template <bool kNote>
  __device__ __forceinline__ T sum(T mid, T kt, const Margins<T>& mg,
                                   unsigned gmask, bool* clamped) const {
    T s[E];
    bool c = true;
    if constexpr (E > 1) {
      T d[E];
      unsigned pending = 0u;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        s[i] = T(0);
        d[i] = e[i] - mid;
        if (p + L * i < nao) {
          const bool up = d[i] >= mg.hi, down = d[i] <= -mg.lo;
          c &= up | down;
          if (up | down) {
            s[i] += up ? occ_hi : occ_lo;
          } else {
            pending |= 1u << i;
          }
        }
      }
      while (pending != 0u) {
        const int k = __ffs(pending) - 1;
        T dk = T(0);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (i == k) dk = d[i];
        }
        const T o = occ_of(dk, kt);
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (i == k) s[i] += o;
        }
        pending &= pending - 1u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        s[i] = T(0);
        if (p + L * i < nao) {
          if (kNote) {
            bool ci;
            s[i] += mg.occ(e[i] - mid, kt, &ci);
            c &= ci;
          } else {
            s[i] += occ(e[i], mid, kt);
          }
        }
      }
    }
    if constexpr (E == 2) s[0] = s[0] + s[1];
    *clamped = c;
    return group_sum<L>(s[0], gmask);
  }

  __device__ __forceinline__ void extremes(T mid, const Margins<T>& mg,
                                           unsigned gmask, T* eh,
                                           T* el) const {
    const T inf = static_cast<T>(INFINITY);
    T h = inf, l = -inf;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (p + L * i < nao) {
        if (mg.high(e[i] - mid)) {
          h = min_nan(h, e[i]);
        } else {
          l = max_nan(l, e[i]);
        }
      }
    }
    *eh = group_min<L>(h, gmask);
    *el = group_max<L>(l, gmask);
  }
};

// log2 of n (a power of two)
__host__ __device__ constexpr int log2_of(int n) {
  return n > 1 ? 1 + log2_of(n / 2) : 0;
}

// One round of a packed row's half-warp: G = 1, a channel's half takes
// its own step; G = 2, a closed shell's two halves evaluate nodes 1 and 2,
// exchange the decisions by ballot and walk them.
template <bool kNote, int G, typename T, int W>
__device__ __forceinline__ void packed_round(Bracket<T>& br,
                                            const PackedRow<T, W>& row,
                                            T n_el, T kt,
                                            const Margins<T>& mg, int node,
                                            unsigned gmask) {
  const T mid = G == 1 ? br.mid() : node_mid<1>(br, node);
  bool clamped;
  const bool too_many =
      row.template sum<kNote>(mid, kt, mg, gmask, &clamped) > n_el;
  if constexpr (G == 1) {
    br.take(mid, too_many);
    if (kNote && !br.done && __all_sync(gmask, clamped)) {
      T eh, el;
      row.extremes(mid, mg, gmask, &eh, &el);
      br.skip(eh, el, too_many, mg);
    }
  } else {
    const unsigned many = __ballot_sync(kFull, too_many);
    const unsigned all = kNote ? __ballot_sync(kFull, clamped) : 0u;
    walk<kNote>(
        br, G, mg,
        [&](int h) {
          const int src = h * 16;
          return static_cast<int>((many >> src) & 1u) |
                 (((all >> src) & 0xffffu) == 0xffffu ? 2 : 0);
        },
        [&](T m, T* eh, T* el) { row.extremes(m, mg, gmask, eh, el); });
  }
}

// A packed row's bisection in rounds of G (`packed_round`)
template <int G, typename T, int W>
__device__ __forceinline__ T packed_bisect(Bracket<T> br,
                                           const PackedRow<T, W>& row,
                                           T n_el, T kt,
                                           const Margins<T>& mg, int node,
                                           unsigned gmask) {
  while (!br.done && mg.runs(br)) {
    packed_round<true, G>(br, row, n_el, kt, mg, node, gmask);
  }
  while (!br.done) {
    packed_round<false, G>(br, row, n_el, kt, mg, node, gmask);
  }
  return br.mid();
}

// nao <= W (16 or 32): a warp per fragment, kPackedWarps fragments a
// block, lanes 0-15 alpha and 16-31 beta. A closed shell's beta half
// evaluates the step after the next (node 2: the next one's left half).
template <typename T, int W>
__global__ void __launch_bounds__(kPackedWarps* kWarp)
    fermi_density_packed(const T* __restrict__ eps,
                         const T* __restrict__ mask,
                         const T* __restrict__ nelec,
                         const T* __restrict__ nuhf, T kt,
                         const T* __restrict__ c, T* __restrict__ p,
                         int batch, int nao) {
  constexpr int N = W;
  constexpr int ld = Tile<T, N>::ld;
  __shared__ __align__(16) T c_s[kPackedWarps][N * ld];
  __shared__ T f_s[kPackedWarps][N];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int b = blockIdx.x * kPackedWarps + warp;
  if (b >= batch) return;  // whole warps: no block barrier below
  const bool closed = nuhf[b] == T(0);
  const size_t off = static_cast<size_t>(b) * nao;
  T* cs = c_s[warp];
  T* fs = f_s[warp];
  const T* c_frag = c + off * nao;
  const int c0 =
      static_cast<int>((reinterpret_cast<uintptr_t>(c_frag) >> 3) & 1);
  if constexpr (sizeof(T) == 8 && W > 16) {
    load_c_pairs<N>(cs, c_frag, nao, lane, kWarp);
  } else {
    load_c<T, N>(cs, c_frag, nao, lane, kWarp);
  }
  const Margins<T> mg(kt);

  const bool beta = lane >= 16;
  const unsigned gmask = group_mask<16>(lane);

  PackedRow<T, W> row;
  row.nao = nao;
  row.p = lane % 16;
  row.load(eps + off, mask + off);
  row.clamps(mg, kt);
  const T n_el = beta && !closed ? T(0.5) * (nelec[b] - nuhf[b])
                                 : T(0.5) * (nelec[b] + nuhf[b]);
  // the fragment's shells are the warp's: the branch is uniform
  const Bracket<T> br = row.bracket(mask + off, gmask);
  const T mu = closed
                   ? packed_bisect<2>(br, row, n_el, kt, mg, beta ? 2 : 1,
                                      gmask)
                   : packed_bisect<1>(br, row, n_el, kt, mg, 1, gmask);
  // f_alpha + f_beta (closed: 2 f_alpha), by the alpha half
#pragma unroll
  for (int i = 0; i < PackedRow<T, W>::E; ++i) {
    const int j = row.p + 16 * i;
    const T fj = j < nao ? occ(row.e[i], mu, kt) : T(0);
    const T f_other = __shfl_xor_sync(kFull, fj, 16);
    if (!beta) fs[j] = j < nao ? fj + (closed ? fj : f_other) : T(0);
  }
  cp_async_wait_all();
  __syncwarp();
  if constexpr (sizeof(T) == 8 && W > 16) {
    product_pairs<N>(cs, fs, p + off * nao, nao, c0, 0, 1, lane);
  } else if constexpr (sizeof(T) == 8) {
    product<N>(cs, fs, p + off * nao, nao, lane, 0, 1);
  } else {
    product<N>(cs, fs, p + off * nao, nao, lane, kWarp);
  }
}

// The barrier of a team of `team` warps of a block of NW: the block's own
// where the team is the block, else named barrier 1 (alpha) or 2 (beta),
// by constant ids (a register id reserves all 16 of the block's barriers,
// and resident blocks with them)
template <int NW>
__device__ __forceinline__ void team_sync(int team, bool beta) {
  if (team == NW) {
    __syncthreads();
  } else if constexpr (NW > 2) {
    if (beta) {
      asm volatile("bar.sync 2, %0;\n" ::"r"(team * kWarp) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"r"(team * kWarp) : "memory");
    }
  }
}

// One round of a row's team of warps (a warp a group, g its node - 1,
// the decisions through `votes` and the team's barrier).
template <bool kNote, int NW, typename T, int K>
__device__ __forceinline__ void warps_round(
    Bracket<T>& br, const Row<T, kWarp, K>& row, T n_el, T kt,
    const Margins<T>& mg, int g, int team, bool beta, int lane,
    int (*votes)[NW], int* round) {
  const T mid = node_mid<log2_of(NW)>(br, g + 1);
  bool clamped = false;
  const bool too_many =
      (kNote ? row.sum_noting(mid, kt, mg, kFull, &clamped)
             : row.sum(mid, kt, kFull)) > n_el;
  const bool all = kNote && __all_sync(kFull, clamped);
  int* slot = votes[*round & 1] + (beta ? team : 0);
  if (lane == 0) slot[g] = static_cast<int>(too_many) | (all ? 2 : 0);
  team_sync<NW>(team, beta);
  ++*round;
  walk<kNote>(
      br, team, mg, [&](int h) { return slot[h]; },
      [&](T m, T* eh, T* el) { row.extremes(m, mg, kFull, eh, el); });
}

// 16 < nao <= 32 K: a block of NW warps per fragment. Two warps: the
// bisection by warp 0 (alpha) and warp 1 (beta; a closed shell's filled
// once), a step at a time (`bisect`). More: by teams of warps evaluating
// the tree of steps ahead (a closed shell's team every warp, an open
// shell's each channel's half of them), the decisions exchanged through
// shared memory with one barrier a round. Then every warp on the product.
template <typename T, int K, int NW>
__global__ void __launch_bounds__(NW* kWarp)
    fermi_density_warps(const T* __restrict__ eps, const T* __restrict__ mask,
                        const T* __restrict__ nelec,
                        const T* __restrict__ nuhf, T kt,
                        const T* __restrict__ c, T* __restrict__ p, int nao) {
  constexpr bool kAhead = NW > 2;
  constexpr int N = kWarp * K;
  constexpr int ld = Tile<T, N>::ld;
  __shared__ __align__(16) T cs[N * ld];
  __shared__ T fs[N];
  __shared__ int votes[2][NW];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const bool closed = nuhf[b] == T(0);
  const size_t off = static_cast<size_t>(b) * nao;
  const T* c_frag = c + off * nao;
  const int c0 =
      static_cast<int>((reinterpret_cast<uintptr_t>(c_frag) >> 3) & 1);
  if constexpr (sizeof(T) == 8) {
    load_c_pairs<N>(cs, c_frag, nao, threadIdx.x, NW * kWarp);
  } else {
    load_c<T, N>(cs, c_frag, nao, threadIdx.x, NW * kWarp);
  }
  const Margins<T> mg(kt);

  // the teams: warps [0, team) alpha (a closed shell's every channel),
  // [team, 2 team) beta
  const int team = kAhead ? (closed ? NW : NW / 2) : 1;
  const bool beta = !closed && warp >= team;
  const bool filling = kAhead || warp == 0 || (warp == 1 && !closed);

  Row<T, kWarp, K> row;
  row.eps = eps + off;
  row.mask = mask + off;
  row.nao = nao;
  row.j0 = lane;
  T mu = T(0);
  if (filling) {
    row.load();
    const T n_el = beta ? T(0.5) * (nelec[b] - nuhf[b])
                        : T(0.5) * (nelec[b] + nuhf[b]);
    if constexpr (kAhead) {
      const int g = beta ? warp - team : warp;
      Bracket<T> br = row.bracket(kFull);
      int round = 0;
      while (!br.done && mg.runs(br)) {
        warps_round<true, NW>(br, row, n_el, kt, mg, g, team, beta, lane,
                              votes, &round);
      }
      while (!br.done) {
        warps_round<false, NW>(br, row, n_el, kt, mg, g, team, beta, lane,
                               votes, &round);
      }
      mu = br.mid();
    } else {
      int taken;
      mu = bisect(row, n_el, kt, mg, kFull, &taken);
    }
  }
  // f_alpha (closed: 2 f_alpha) by warp 0, f_beta added by the beta team's
  // first warp after the barrier
  const int beta_warp = team;
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + kWarp * k;
      if (j < nao) {
        const T fj = occ(row.e[k], mu, kt);
        fs[j] = closed ? fj + fj : fj;
      } else {
        fs[j] = T(0);
      }
    }
  }
  __syncthreads();
  if (!closed && warp == beta_warp) {
    row.visit([&](int j, T e) { fs[j] = fs[j] + occ(e, mu, kt); });
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (sizeof(T) == 8) {
    product_pairs<N>(cs, fs, p + off * nao, nao, c0, warp, NW, lane);
  } else {
    product<N>(cs, fs, p + off * nao, nao, threadIdx.x, NW * kWarp);
  }
}

// the multiprocessors of `device` (read once a device)
int multiprocessors(int device) {
  static int known[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (known[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n <= 0) {
      cudaGetLastError();
      n = 132;
    }
    known[device] = n;
  }
  return known[device];
}

// The class of nao and the batch choose the kernel: up to 16, a warp a
// fragment; 17-32, in f64 a warp a fragment where the batch fills the card
// (kPacked32PerSM), else a block of two warps; 33-64, a block of
// kWideWarps evaluating ahead where the batch leaves the card underfilled
// (kWideAheadPerSM), else a block of two warps.
template <typename T>
cudaError_t launch_density(const T* eps, const T* mask, const T* nelec,
                           const T* nuhf, T kt, const T* c, T* p, int batch,
                           int nao, int device, cudaStream_t stream) {
  if (nao > kDensityMaxN) return cudaErrorInvalidValue;
  const int blocks = (batch + kPackedWarps - 1) / kPackedWarps;
  const int sms = multiprocessors(device);
  if (nao <= 16) {
    fermi_density_packed<T, 16><<<blocks, kPackedWarps * kWarp, 0, stream>>>(
        eps, mask, nelec, nuhf, kt, c, p, batch, nao);
  } else if (nao <= kWarp && sizeof(T) == 8 &&
             batch >= kPacked32PerSM * sms) {
    fermi_density_packed<T, kWarp><<<blocks, kPackedWarps * kWarp, 0,
                                     stream>>>(eps, mask, nelec, nuhf, kt, c,
                                               p, batch, nao);
  } else if (nao <= kWarp) {
    fermi_density_warps<T, 1, 2><<<batch, 2 * kWarp, 0, stream>>>(
        eps, mask, nelec, nuhf, kt, c, p, nao);
  } else if (batch <= kWideAheadPerSM * sms) {
    fermi_density_warps<T, 2, kWideWarps>
        <<<batch, kWideWarps * kWarp, 0, stream>>>(eps, mask, nelec, nuhf,
                                                   kt, c, p, nao);
  } else {
    fermi_density_warps<T, 2, 2><<<batch, 2 * kWarp, 0, stream>>>(
        eps, mask, nelec, nuhf, kt, c, p, nao);
  }
  return cudaGetLastError();
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

template <typename T>
int fill(const T* eps, const T* mask, const T* nelec, const T* nuhf,
         double kt, T* f, T* entropy, int* steps, int batch, int nao,
         int device, void* stream) {
  if (batch <= 0 || nao <= 0) return 0;
  return on_device(device, [&] {
    return launch_fill<T>(eps, mask, nelec, nuhf, static_cast<T>(kt), f,
                          entropy, steps, batch, nao,
                          static_cast<cudaStream_t>(stream));
  });
}

template <typename T>
int density(const T* eps, const T* mask, const T* nelec, const T* nuhf,
            double kt, const T* c, T* p, int batch, int nao, int device,
            void* stream) {
  if (batch <= 0 || nao <= 0) return 0;
  return on_device(device, [&] {
    return launch_density<T>(eps, mask, nelec, nuhf, static_cast<T>(kt), c,
                             p, batch, nao, device,
                             static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// steps: null, or int (batch, 2) for the steps each channel's bisection
// took (0 for a closed shell's beta channel, which is not filled)
int mqc_fermi_fill_f32(const float* eps, const float* mask,
                       const float* nelec, const float* nuhf, double kt,
                       float* f, float* entropy, int* steps, int batch,
                       int nao, int device, void* stream) {
  return fill<float>(eps, mask, nelec, nuhf, kt, f, entropy, steps, batch,
                     nao, device, stream);
}

int mqc_fermi_fill_f64(const double* eps, const double* mask,
                       const double* nelec, const double* nuhf, double kt,
                       double* f, double* entropy, int* steps, int batch,
                       int nao, int device, void* stream) {
  return fill<double>(eps, mask, nelec, nuhf, kt, f, entropy, steps, batch,
                      nao, device, stream);
}

// c: (batch, nao, nao) eigenvectors in columns; p: (batch, nao, nao)
int mqc_fermi_density_f32(const float* eps, const float* mask,
                          const float* nelec, const float* nuhf, double kt,
                          const float* c, float* p, int batch, int nao,
                          int device, void* stream) {
  return density<float>(eps, mask, nelec, nuhf, kt, c, p, batch, nao, device,
                        stream);
}

int mqc_fermi_density_f64(const double* eps, const double* mask,
                          const double* nelec, const double* nuhf, double kt,
                          const double* c, double* p, int batch, int nao,
                          int device, void* stream) {
  return density<double>(eps, mask, nelec, nuhf, kt, c, p, batch, nao,
                         device, stream);
}

const char* mqc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
