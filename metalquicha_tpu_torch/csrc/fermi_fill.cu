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
// - Rows of nao <= 16 (<= 8) take a half-warp (quarter-warp) each, and
//   the row sum's butterfly runs only the levels inside it: one (two)
//   shuffle levels fewer per step. The levels dropped added the zeros of
//   lanes >= nao, so no bit changes. A warp holds both channels of a
//   fragment, lanes 0-15 alpha and 16-31 beta; f_alpha + f_beta is one
//   __shfl_xor_sync(..., 16). A block holds 4 (8) fragments.
// - A closed shell (nuhf 0) is filled once: both channels have the same
//   n_el and the same arithmetic, so f_alpha + f_beta = 2 f_alpha and
//   s_alpha + s_beta = 2 s_alpha exactly. The beta channel's warp (or
//   half-warp) skips the bisection; in a launch bound by the FP64 pipes
//   that frees them for other warps.
// - Rows longer than 16 take a warp per channel, two warps per fragment
//   (a block each), the row in K = 1, 2, 4 or 8 registers per lane; a row
//   longer than 256 is read again from device memory (through L1) at every
//   step. The beta warp adds its f to the alpha warp's after one barrier.
// - The fused density (nao <= 64, one launch per SCC iteration in place of
//   the fill, the product and a round trip of f through device memory):
//   the block first issues cp.async copies of the fragment's C into shared
//   memory (row stride padded, padding zeroed), which complete while the
//   latency-bound bisection runs, so the load of C is hidden behind it.
//   f goes to shared memory. In f64 each warp then forms 8 x 8 tiles of P
//   on the FP64 tensor cores (mma.sync m8n8k4, nao padded to a multiple
//   of 8 with zeros; the A operand C[i][j] f[j] scaled in registers as it
//   is read, which rounds as a scaled copy in shared memory would). In f32
//   the product is plain FP32 FMAs from shared memory: the tensor cores
//   have no full-f32 mode, and TF32 would drop 13 bits that the port's f32
//   products keep.
//
// The kernels launch on the caller's stream, allocate nothing, and the C
// entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSteps = 80;
constexpr int kMaxK = 8;  // registers per lane for the row: nao <= 256
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPackedWarps = 4;  // warps per block of the packed rows
constexpr int kDensityMaxN = 64;

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

template <typename T>
__device__ __forceinline__ T occ(T e, T mu, T kt) {
  const T x = clip((e - mu) / kt, T(-60.0), T(60.0));
  return T(1) / (T(1) + ex(x));
}

template <typename T>
__device__ __forceinline__ T entropy_of(T f) {
  if (!(f > T(1.0e-12) && f < T(1.0 - 1.0e-12))) return T(0);
  const T fc = clip(f, T(1.0e-30), T(1.0 - 1.0e-30));
  return -(fc * ln(fc) + (T(1) - fc) * ln(T(1) - fc));
}

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
};

// The bisection of one row by its group of W lanes: mu, and the steps
// taken. It stops after the first step that leaves (lo, hi) unchanged
// (every later step would repeat it), at 80 at most.
template <typename T, int W, int K>
__device__ __forceinline__ T bisect(const Row<T, W, K>& row, T n_el, T kt,
                                    unsigned mask, int* steps) {
  const T inf = static_cast<T>(INFINITY);
  T lo = inf, hi = -inf;
  row.visit([&](int j, T e) {
    lo = min_nan(lo, e);
    hi = max_nan(hi, row.mask[j] > T(0.5) ? e : T(-1.0e3));
  });
  lo = group_min<W>(lo, mask) - T(10.0);
  hi = group_max<W>(hi, mask) + T(10.0);

  int step = 0;
  while (step < kSteps) {
    const T mid = T(0.5) * (lo + hi);
    T n = T(0);
    row.visit([&](int, T e) { n += occ(e, mid, kt); });
    const bool too_many = group_sum<W>(n, mask) > n_el;
    const T old = too_many ? hi : lo;
    if (too_many) {
      hi = mid;
    } else {
      lo = mid;
    }
    ++step;
    if (mid == old) break;  // a NaN never compares equal
  }
  *steps = step;
  return T(0.5) * (lo + hi);
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
    const T mu = bisect(row, n_el, kt, gmask, &taken);
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
    mu = bisect(row, n_el, kt, kFull, &taken);
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
// (the m8n8k4 operands' 8 rows x 4 columns fall on distinct banks); f32
// odd (a warp reads 32 rows of one column)
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

// nao <= 16: a warp per fragment (lanes 0-15 alpha, 16-31 beta, as in the
// packed fill), kPackedWarps fragments a block
template <typename T>
__global__ void __launch_bounds__(kPackedWarps* kWarp)
    fermi_density_packed(const T* __restrict__ eps,
                         const T* __restrict__ mask,
                         const T* __restrict__ nelec,
                         const T* __restrict__ nuhf, T kt,
                         const T* __restrict__ c, T* __restrict__ p,
                         int batch, int nao) {
  constexpr int N = 16;
  constexpr int ld = Tile<T, N>::ld;
  __shared__ __align__(16) T c_s[kPackedWarps][N * ld];
  __shared__ T f_s[kPackedWarps][N];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int b = blockIdx.x * kPackedWarps + warp;
  if (b >= batch) return;  // whole warps: no block barrier below
  const int j = lane % 16;
  const bool beta = lane >= 16;
  const bool closed = nuhf[b] == T(0);
  const unsigned gmask = group_mask<16>(lane);
  const size_t off = static_cast<size_t>(b) * nao;
  T* cs = c_s[warp];
  T* fs = f_s[warp];
  load_c<T, N>(cs, c + off * nao, nao, lane, kWarp);

  Row<T, 16, 1> row;
  row.eps = eps + off;
  row.mask = mask + off;
  row.nao = nao;
  row.j0 = j;
  T fj = T(0);
  if (!(beta && closed)) {
    row.load();
    const T n_el = beta ? T(0.5) * (nelec[b] - nuhf[b])
                        : T(0.5) * (nelec[b] + nuhf[b]);
    int taken;
    const T mu = bisect(row, n_el, kt, gmask, &taken);
    row.visit([&](int, T e) { fj = occ(e, mu, kt); });
  }
  const T f_other = __shfl_xor_sync(kFull, fj, 16);
  if (!beta) fs[j] = j < nao ? fj + (closed ? fj : f_other) : T(0);
  cp_async_wait_all();
  __syncwarp();
  if constexpr (sizeof(T) == 8) {
    product<N>(cs, fs, p + off * nao, nao, lane, 0, 1);
  } else {
    product<N>(cs, fs, p + off * nao, nao, lane, kWarp);
  }
}

// 16 < nao <= 32 K: a block of two warps per fragment (alpha, beta), then
// both on the product
template <typename T, int K>
__global__ void __launch_bounds__(2 * kWarp)
    fermi_density_warps(const T* __restrict__ eps, const T* __restrict__ mask,
                        const T* __restrict__ nelec,
                        const T* __restrict__ nuhf, T kt,
                        const T* __restrict__ c, T* __restrict__ p, int nao) {
  constexpr int N = kWarp * K;
  constexpr int ld = Tile<T, N>::ld;
  __shared__ __align__(16) T cs[N * ld];
  __shared__ T fs[N];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const bool beta = threadIdx.x >= kWarp;
  const bool closed = nuhf[b] == T(0);
  const size_t off = static_cast<size_t>(b) * nao;
  load_c<T, N>(cs, c + off * nao, nao, threadIdx.x, 2 * kWarp);

  Row<T, kWarp, K> row;
  row.eps = eps + off;
  row.mask = mask + off;
  row.nao = nao;
  row.j0 = lane;
  T mu = T(0);
  if (!(beta && closed)) {
    row.load();
    const T n_el = beta ? T(0.5) * (nelec[b] - nuhf[b])
                        : T(0.5) * (nelec[b] + nuhf[b]);
    int taken;
    mu = bisect(row, n_el, kt, kFull, &taken);
  }
  if (!beta) {
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
  if (beta && !closed) {
    row.visit([&](int j, T e) { fs[j] = fs[j] + occ(e, mu, kt); });
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (sizeof(T) == 8) {
    product<N>(cs, fs, p + off * nao, nao, lane, beta, 2);
  } else {
    product<N>(cs, fs, p + off * nao, nao, threadIdx.x, 2 * kWarp);
  }
}

template <typename T>
cudaError_t launch_density(const T* eps, const T* mask, const T* nelec,
                           const T* nuhf, T kt, const T* c, T* p, int batch,
                           int nao, cudaStream_t stream) {
  if (nao > kDensityMaxN) return cudaErrorInvalidValue;
  if (nao <= 16) {
    fermi_density_packed<T>
        <<<(batch + kPackedWarps - 1) / kPackedWarps, kPackedWarps * kWarp, 0,
           stream>>>(eps, mask, nelec, nuhf, kt, c, p, batch, nao);
  } else if (nao <= kWarp) {
    fermi_density_warps<T, 1><<<batch, 2 * kWarp, 0, stream>>>(
        eps, mask, nelec, nuhf, kt, c, p, nao);
  } else {
    fermi_density_warps<T, 2><<<batch, 2 * kWarp, 0, stream>>>(
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
                             p, batch, nao,
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
