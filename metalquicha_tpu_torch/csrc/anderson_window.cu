// The Anderson window step of the SCC loop: a warp per fragment at small
// nx, a block per fragment above.
//
// Replaces, in metalquicha_tpu/methods/xtb/engine.py, the window algebra
// of the SCC's Anderson step (:808-842, GFN2's :614-641): everything after
// f_res = g(x) - x. The JAX package writes it in jnp under `vmap`, and XLA
// solves each fragment's (m, m) normal equations alone; the port's plain
// torch version (ops/anderson_window.py, `anderson_window_reference`)
// makes about 40 launches per step, and its batched products and
// `torch.linalg.solve_ex` choose their routines by the batch count, so a
// fragment's bits depend on the batch it sits in (ROADMAP C17). Not a
// Pallas kernel: the JAX package has none here.
//
// For one fragment (x, f = f_res of length nx; windows hx, hf (m, nx);
// the counter it, read on the device) it computes, as the plain version:
//   it_resid = max |f| (a NaN kept),
//   hx[it % m] = x, hf[it % m] = f,
//   prev = (it - 1) mod m, valid_j = j <= it and j != prev,
//   dX_j = valid_j ? hx_j - hx_prev : 0, dF_j likewise,
//   G = dF dF^T + (reg tr(dF dF^T) / m + 1e-30) I, rhs = dF f,
//   c = G^-1 rhs (Gaussian elimination with partial pivoting),
//   x_and = x + beta f - sum_j c_j (dX_j + beta dF_j), x_damped = x + beta f,
//   bad = it < 1 or a non-finite x_and or max |c| > c_lim,
//   x_next = bad ? x_damped : x_and,
// and, for a fragment still active (every fragment at it = 0), x = x_next
// and resid = it_resid; then active = (active or it = 0) and resid >
// scf_tol. The counter's increment is the caller's: one block cannot bump
// a value that the others read.
//
// What bounds it. Per fragment, (m(m+1)/2 + m) dot products of length nx
// (2 FLOP per element), the (m, m) elimination (m^3 / 3 multiply-adds, a
// chain of m pivot steps) and the step (2 m FLOP per element); the bytes
// are the two windows read (2 m nx elements), x and f read, x and the new
// window slots written. At the main path's shapes (m = 12, nx = 12-400)
// both bounds are a few microseconds for the whole batch, and every
// fragment's work is resident at once: the launch is bound by the latency
// of one fragment's chain of dependent steps.
//
// What the design does about it, and for the bits:
// - The window is staged in shared memory once: dF_j and dS_j = dX_j +
//   beta dF_j for the m rows (2 m nx elements) and f, so no product
//   re-derives a difference from device memory. Where 2 m nx does not fit
//   (nx above about 1000 at m = 12 in f64) the products stream nx in
//   tiles of dF, and the step forms dS_j from the window again, with the
//   same arithmetic.
// - nx <= 32 (GFN1's dimers and tetramers): a warp per fragment, four
//   fragments a 128-thread block, no block barrier. G and rhs a lane per
//   entry: a dot product in ascending order from shared memory, with no
//   shuffle tree. Above, a block per fragment: a warp per dot product, its
//   lanes striding over nx in a fixed order and summed by a fixed
//   __shfl_xor_sync butterfly, four products in flight per warp.
// - The elimination in registers of one warp (m <= 16): lane i holds row
//   i of [G | rhs]; the pivot is the first index of the largest |.| (a NaN
//   counts as the largest), as LAPACK's i?amax and torch.argmax pick it,
//   found by a butterfly; rows are swapped by relabelling the lanes, the
//   pivot row is broadcast by shuffles, the update is a - f b rounded
//   twice (no contraction into an FMA), and the back substitution
//   broadcasts each coefficient by a shuffle: the arithmetic of the
//   elementwise plain twin (`anderson_window_rowwise`). For 16 < m <= 32
//   the same arithmetic on the rows in shared memory (a register row
//   unrolled to 32 would take nvcc half a minute).
// - The step is formed once, sum_j c_j dS_j rounded twice per term in
//   ascending j as the twin rounds it; x_and is written, and rewritten
//   with the damped step (from the new window slot, which holds the state
//   read) only if a value was not finite.
// Every fragment's arithmetic depends on (m, nx) alone, not on the batch
// or the fragment's place in it (what C17 asks of the window).
//
// The kernel launches on the caller's stream, allocates nothing, and the
// C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
// the largest window (broyden_memory) the kernel takes: its [G | rhs]
// system (m, m + 1) in shared memory beside the tiles, in f64 too
constexpr int kMaxM = 128;
constexpr unsigned kFull = 0xffffffffu;
// a warp per fragment up to this nx, a block above
constexpr int kSmallNx = 32;
// the dynamic shared memory a block stages its window in
constexpr size_t kStageBytes = 200 * 1024;
constexpr size_t kStaticSmem = 48 * 1024;
// the dynamic shared memory a block may take (the card's 227 KB, less
// the kernels' own static arrays)
constexpr size_t kMaxDynamic = 232448 - 1024;
// dot products in flight per warp at large nx
constexpr int kInFlight = 4;
// the largest m whose solve runs in registers (a lane per row, the row
// unrolled); above it the rows stay in shared memory, each lane holding
// rows lane, lane + 32, ... Every caller in the repo runs broyden_memory =
// 12, but the window is a setting a user may raise
// (settings_from_params(broyden_memory=...)), and the JAX package takes
// any: the shared memory solve keeps m in (16, kMaxM] on the kernel (no
// plain-torch path on a card) without the register row's compile time.
constexpr int kRegM = 16;

// correctly rounded arithmetic that the compiler may not contract
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// a max that keeps a NaN, and gives both lanes of a butterfly pair the
// same value
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (value, index) of the pivot search: the larger |a| wins, a NaN counts as
// the largest, and a tie goes to the smaller index
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T w, int j) {
  const bool vn = v != v, wn = w != w;
  if (vn != wn) return vn;
  if (vn || v == w) return i < j;
  return v > w;
}

// the lane whose flag is set (exactly one)
__device__ __forceinline__ int lane_of(bool flag) {
  return __ffs(__ballot_sync(kFull, flag)) - 1;
}

// product p of G's upper triangle (row by row) and then of rhs: (j, k),
// k = -1 for rhs_j
__device__ __forceinline__ void entry(int p, int m, int* j, int* k) {
  const int n_g = m * (m + 1) / 2;
  if (p >= n_g) {
    *j = p - n_g;
    *k = -1;
    return;
  }
  int r = 0, q = p;
  while (q >= m - r) {
    q -= m - r;
    ++r;
  }
  *j = r;
  *k = r + q;
}

template <typename T>
struct Window {
  const T* hx;  // the fragment's (m, nx) windows
  const T* hf;
  const T* x;   // its state and residual vector
  const T* f;
  int slot, prev, nx;
  long long it;

  __device__ bool valid(int j) const { return j <= it && j != prev; }
  // window entries, the slot being written read from x and f
  __device__ T wx(int j, int e) const {
    return j == slot ? x[e] : hx[static_cast<long long>(j) * nx + e];
  }
  __device__ T wf(int j, int e) const {
    return j == slot ? f[e] : hf[static_cast<long long>(j) * nx + e];
  }
  // dF_j and dS_j = dX_j + beta dF_j at e for j0 <= j < j1, into
  // dF[(j - j0) * ld] and (where dS is given) dS[(j - j0) * ld]: the
  // window entries loaded kRegM rows at a time before any is used
  __device__ void stage(int e, int j0, int j1, T beta, T* dF, T* dS,
                        int ld) const {
    const T xp = wx(prev, e), fp = wf(prev, e);
    for (int jb = j0; jb < j1; jb += kRegM) {
      T vx[kRegM], vf[kRegM];
#pragma unroll
      for (int u = 0; u < kRegM; ++u) {
        if (jb + u < j1) {
          vx[u] = wx(jb + u, e);
          vf[u] = wf(jb + u, e);
        }
      }
#pragma unroll
      for (int u = 0; u < kRegM; ++u) {
        const int j = jb + u;
        if (j < j1) {
          const bool v = valid(j);
          const T d_f = v ? sub(vf[u], fp) : T(0);
          const T d_x = v ? sub(vx[u], xp) : T(0);
          dF[(j - j0) * ld] = d_f;
          if (dS != nullptr) dS[(j - j0) * ld] = add(d_x, mul(beta, d_f));
        }
      }
    }
  }
};

// Solve (G + shift I) c = rhs for the [G | rhs] rows in shared memory (row
// stride ld) in the registers of one warp (called by all its lanes), m <=
// kRegM; c to cs in shared memory.
template <typename T>
__device__ __forceinline__ void solve_registers(const T* aug, int ld, int m,
                                                T reg, T* cs) {
  const int lane = threadIdx.x % kWarp;
  T row[kRegM];
  T rhs = T(0);
#pragma unroll
  for (int q = 0; q < kRegM; ++q)
    row[q] = (lane < m && q < m) ? aug[lane * ld + q] : T(0);
  if (lane < m) rhs = aug[lane * ld + m];

  // the regularizer: the trace summed in ascending order
  T diag = T(0);
#pragma unroll
  for (int q = 0; q < kRegM; ++q)
    if (q == lane) diag = row[q];
  T tr = T(0);
  for (int j = 0; j < m; ++j) tr = add(tr, __shfl_sync(kFull, diag, j));
  const T shift = add(dvd(mul(reg, tr), T(m)), T(1e-30));
#pragma unroll
  for (int q = 0; q < kRegM; ++q)
    if (q == lane && q < m) row[q] = add(row[q], shift);

  // the elimination: lane `lane` holds logical row L
  int L = lane;
#pragma unroll
  for (int k = 0; k < kRegM; ++k) {
    if (k >= m) break;
    T v = T(-1);
    int i = kMaxM;
    if (L >= k && L < m) {
      v = fabs(row[k]);
      i = L;
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const T v2 = __shfl_xor_sync(kFull, v, o);
      const int i2 = __shfl_xor_sync(kFull, i, o);
      if (better(v2, i2, v, i)) {
        v = v2;
        i = i2;
      }
    }
    // swap logical rows k and i: relabel the two lanes
    const int pl = lane_of(L == i);
    const int kl = lane_of(L == k);
    if (lane == kl) L = i;
    if (lane == pl) L = k;
    const bool upd = L > k && L < m;
    const T piv = dvd(row[k], __shfl_sync(kFull, row[k], pl));
#pragma unroll
    for (int q = k + 1; q < kRegM; ++q) {
      if (q < m) {
        const T b = __shfl_sync(kFull, row[q], pl);
        if (upd) row[q] = sub(row[q], mul(piv, b));
      }
    }
    const T b = __shfl_sync(kFull, rhs, pl);
    if (upd) rhs = sub(rhs, mul(piv, b));
  }

  // the back substitution, each coefficient from the lane of its row
  T c[kRegM];
#pragma unroll
  for (int k = kRegM - 1; k >= 0; --k) {
    c[k] = T(0);
    if (k < m) {
      T acc = T(0);
#pragma unroll
      for (int q = k + 1; q < kRegM; ++q)
        if (q < m) acc = add(acc, mul(row[q], c[q]));
      const T val = dvd(sub(rhs, acc), row[k]);
      c[k] = __shfl_sync(kFull, val, lane_of(L == k));
      if (lane == 0) cs[k] = c[k];
    }
  }
  __syncwarp();
}

// The same solve, m in (kRegM, kMaxM], on the rows in shared memory, lane
// l holding rows l, l + 32, ..., the rows swapped in place; the same
// arithmetic (and bits).
template <typename T>
__device__ __forceinline__ void solve_shared(T* aug, int ld, int m, T reg,
                                             T* cs) {
  const int lane = threadIdx.x % kWarp;
  if (lane == 0) {
    T tr = T(0);
    for (int j = 0; j < m; ++j) tr = add(tr, aug[j * ld + j]);
    const T shift = add(dvd(mul(reg, tr), T(m)), T(1e-30));
    for (int j = 0; j < m; ++j) aug[j * ld + j] = add(aug[j * ld + j], shift);
  }
  __syncwarp();
  for (int k = 0; k < m; ++k) {
    T v = T(-1);
    int i = kMaxM;
    for (int r = lane; r < m; r += kWarp) {
      if (r >= k && better(fabs(aug[r * ld + k]), r, v, i)) {
        v = fabs(aug[r * ld + k]);
        i = r;
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const T v2 = __shfl_xor_sync(kFull, v, o);
      const int i2 = __shfl_xor_sync(kFull, i, o);
      if (better(v2, i2, v, i)) {
        v = v2;
        i = i2;
      }
    }
    if (i != k) {
      for (int col = lane; col <= m; col += kWarp) {
        const T t = aug[k * ld + col];
        aug[k * ld + col] = aug[i * ld + col];
        aug[i * ld + col] = t;
      }
    }
    __syncwarp();
    for (int r = lane; r < m; r += kWarp) {
      if (r <= k) continue;
      const T piv = dvd(aug[r * ld + k], aug[k * ld + k]);
      for (int col = k + 1; col <= m; ++col)
        aug[r * ld + col] = sub(aug[r * ld + col], mul(piv, aug[k * ld + col]));
    }
    __syncwarp();
  }
  if (lane == 0) {
    for (int k = m - 1; k >= 0; --k) {
      T acc = T(0);
      for (int j = k + 1; j < m; ++j)
        acc = add(acc, mul(aug[k * ld + j], cs[j]));
      cs[k] = dvd(sub(aug[k * ld + m], acc), aug[k * ld + k]);
    }
  }
  __syncwarp();
}

// c (in cs) of the fragment's window, by one warp
template <typename T>
__device__ __forceinline__ void solve(T* aug, int ld, int m, T reg, T* cs) {
  if (m <= kRegM) {
    solve_registers(aug, ld, m, reg, cs);
  } else {
    solve_shared(aug, ld, m, reg, cs);
  }
}

template <typename T>
__device__ __forceinline__ T max_abs(const T* c, int m) {
  T cmax = T(0);
  for (int j = 0; j < m; ++j) cmax = max_nan(cmax, fabs(c[j]));
  return cmax;
}

// nx <= 32: a warp per fragment, up to kWarps fragments a block (fewer
// where a large window's shared memory would not fit). Shared memory per
// warp: dF (m, nx), dS (m, nx), f (nx), [G | rhs] (m, m + 1), c (m).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_warp(T* __restrict__ x, const T* __restrict__ f,
                T* __restrict__ hx, T* __restrict__ hf,
                T* __restrict__ resid, bool* __restrict__ active,
                const long long* __restrict__ it_ptr, T beta, T reg,
                T c_lim, T scf_tol, int batch, int m, int nx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int b = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (b >= batch) return;  // whole warps: no block barrier below
  const int ld = m + 1;
  T* dF = reinterpret_cast<T*>(smem) +
          static_cast<size_t>(warp) * (2 * m * nx + nx + m * ld + m);
  T* dS = dF + m * nx;
  T* fs = dS + m * nx;
  T* aug = fs + nx;
  T* cs = aug + m * ld;

  const long long it = *it_ptr;
  const long long mm = m;
  const int slot = static_cast<int>(it % mm);
  const int prev = static_cast<int>((((it - 1) % mm) + mm) % mm);
  // every fragment is active at the first iteration (a cached loop's
  // restart resets only the counter)
  const bool on = active[b] || it < 1;
  T* xb = x + static_cast<long long>(b) * nx;
  const T* fb = f + static_cast<long long>(b) * nx;
  T* hxb = hx + static_cast<long long>(b) * m * nx;
  T* hfb = hf + static_cast<long long>(b) * m * nx;
  const Window<T> w{hxb, hfb, xb, fb, slot, prev, nx, it};

  // the residual, the new window slot, the staged window
  const bool in = lane < nx;
  T xe = T(0), fe = T(0);
  if (in) {
    xe = xb[lane];
    fe = fb[lane];
    fs[lane] = fe;
    w.stage(lane, 0, m, beta, dF + lane, dS + lane, nx);
  }
  const T it_resid = warp_max(in ? max_nan(T(0), fabs(fe)) : T(0));
  __syncwarp();
  if (in) {
    hxb[static_cast<long long>(slot) * nx + lane] = xe;
    hfb[static_cast<long long>(slot) * nx + lane] = fe;
  }

  // G's upper triangle and rhs: a lane per entry, ascending e. A masked
  // row is 0 and still multiplied, as in the plain version's product (0
  // times a non-finite value is NaN there too)
  const int n_prod = m * (m + 1) / 2 + m;
  for (int p = lane; p < n_prod; p += kWarp) {
    int j, k;
    entry(p, m, &j, &k);
    const T* a = dF + j * nx;
    const T* o = k < 0 ? fs : dF + k * nx;
    T acc = T(0);
    for (int e = 0; e < nx; ++e) acc = fma_(a[e], o[e], acc);
    if (k < 0) {
      aug[j * ld + m] = acc;
    } else {
      aug[j * ld + k] = acc;
      aug[k * ld + j] = acc;
    }
  }
  __syncwarp();

  solve(aug, ld, m, reg, cs);
  const bool known_bad = it < 1 || max_abs(cs, m) > c_lim;

  // the step, once; rejected where a value is not finite
  const T damped = add(xe, mul(beta, fe));
  T x_and = damped;
  if (in) {
    T step = T(0);
    for (int j = 0; j < m; ++j)
      step = add(step, mul(cs[j], dS[j * nx + lane]));
    x_and = sub(damped, step);
  }
  const bool nonfinite = __any_sync(kFull, in && !isfinite(x_and));
  const bool bad = known_bad || nonfinite;
  if (on && in) xb[lane] = bad ? damped : x_and;
  if (lane == 0) {
    const T r = on ? it_resid : resid[b];
    resid[b] = r;
    active[b] = on && r > scf_tol;
  }
}

// nx > 32: a block per fragment. Dynamic shared memory: [G | rhs] (m,
// m + 1) and c (m), dF (m, nt), then, where the whole window is staged
// (nt = nx), dS (m, nt); then f (nt).
// The registers are capped so that four blocks fit an SM (the dimer
// slice's 512 fragments in one wave): only warp 0 needs the solve's.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    window_block(T* __restrict__ x, const T* __restrict__ f,
                 T* __restrict__ hx, T* __restrict__ hf,
                 T* __restrict__ resid, bool* __restrict__ active,
                 const long long* __restrict__ it_ptr, T beta, T reg,
                 T c_lim, T scf_tol, int m, int nx, int nt, bool staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kWarps];
  __shared__ T cmax_s;
  __shared__ int bad_any;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int ld = m + 1;
  T* aug = reinterpret_cast<T*>(smem);  // [G | rhs]
  T* c_s = aug + m * ld;
  T* dF = c_s + m;
  T* dS = dF + m * nt;
  T* fs = staged ? dS + m * nt : dS;

  const long long it = *it_ptr;
  const long long mm = m;
  const int slot = static_cast<int>(it % mm);
  const int prev = static_cast<int>((((it - 1) % mm) + mm) % mm);
  const bool on = active[b] || it < 1;
  T* xb = x + static_cast<long long>(b) * nx;
  const T* fb = f + static_cast<long long>(b) * nx;
  T* hxb = hx + static_cast<long long>(b) * m * nx;
  T* hfb = hf + static_cast<long long>(b) * m * nx;
  const Window<T> w{hxb, hfb, xb, fb, slot, prev, nx, it};

  // G's upper triangle and rhs, nx in tiles of nt: a warp per product,
  // kInFlight at once; a tile's sums added to the running ones
  const int n_prod = m * (m + 1) / 2 + m;
  for (int e0 = 0; e0 < nx; e0 += nt) {
    const int ne = min(nt, nx - e0);
    if (e0 > 0) __syncthreads();  // the last tile's products are done
    for (int e = tid; e < ne; e += kThreads) {
      fs[e] = fb[e0 + e];
      w.stage(e0 + e, 0, m, beta, dF + e, staged ? dS + e : nullptr, nt);
    }
    __syncthreads();
    for (int p0 = warp * kInFlight; p0 < n_prod; p0 += kWarps * kInFlight) {
      int jj[kInFlight], kk[kInFlight];
      T acc[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        jj[u] = 0;
        kk[u] = -1;
        if (p0 + u < n_prod) entry(p0 + u, m, &jj[u], &kk[u]);
        acc[u] = T(0);
      }
      for (int e = lane; e < ne; e += kWarp) {
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const T o = kk[u] < 0 ? fs[e] : dF[kk[u] * nt + e];
          acc[u] = fma_(dF[jj[u] * nt + e], o, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const T s = warp_sum(acc[u]);
        if (lane == 0 && p0 + u < n_prod) {
          const int j = jj[u], k = kk[u];
          T* dst = aug + j * ld + (k < 0 ? m : k);
          const T total = e0 == 0 ? s : add(*dst, s);
          *dst = total;
          if (k >= 0) aug[k * ld + j] = total;
        }
      }
    }
  }

  // the residual and the new window slot (every read of the old slot is
  // done: the products' last barrier)
  T amax = T(0);
  for (int e = tid; e < nx; e += kThreads) {
    const T xe = xb[e], fe = fb[e];
    amax = max_nan(amax, fabs(fe));
    hxb[static_cast<long long>(slot) * nx + e] = xe;
    hfb[static_cast<long long>(slot) * nx + e] = fe;
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();

  if (warp == 0) {
    solve(aug, ld, m, reg, c_s);
    if (lane == 0) {
      cmax_s = max_abs(c_s, m);
      bad_any = 0;
    }
  }
  __syncthreads();

  // the step, once: x_and written; rewritten with the damped step below if
  // a value was not finite
  const bool known_bad = it < 1 || cmax_s > c_lim;
  bool nonfinite = false;
  if (on) {
    for (int e = tid; e < nx; e += kThreads) {
      const T damped = add(xb[e], mul(beta, fb[e]));
      if (known_bad) {
        xb[e] = damped;
        continue;
      }
      T step = T(0);
      if (staged) {
        for (int j = 0; j < m; ++j)
          step = add(step, mul(c_s[j], dS[j * nt + e]));
      } else {
        // dS_j at e formed again from the window, kRegM rows at a time,
        // with the staged rows' arithmetic
        for (int j0 = 0; j0 < m; j0 += kRegM) {
          const int j1 = min(m, j0 + kRegM);
          T df_e[kRegM], ds_e[kRegM];
          w.stage(e, j0, j1, beta, df_e, ds_e, 1);
          for (int j = j0; j < j1; ++j)
            step = add(step, mul(c_s[j], ds_e[j - j0]));
        }
      }
      const T x_and = sub(damped, step);
      nonfinite |= !isfinite(x_and);
      xb[e] = x_and;
    }
  }
  if (__any_sync(kFull, nonfinite) && lane == 0) atomicOr(&bad_any, 1);
  __syncthreads();
  if (on && !known_bad && bad_any) {
    // x from the new window slot: the state this step read
    for (int e = tid; e < nx; e += kThreads)
      xb[e] = add(hxb[static_cast<long long>(slot) * nx + e],
                  mul(beta, fb[e]));
  }
  if (tid == 0) {
    T it_resid = red[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) it_resid = max_nan(it_resid, red[k]);
    const T r = on ? it_resid : resid[b];
    resid[b] = r;
    active[b] = on && r > scf_tol;
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
// device (the attribute is the context's) and per size asked
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device,
                       size_t* granted) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  size_t* g = granted + (device & 63);
  if (__atomic_load_n(g, __ATOMIC_ACQUIRE) >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) __atomic_store_n(g, bytes, __ATOMIC_RELEASE);
  return err;
}

template <typename T>
cudaError_t launch(T* x, const T* f, T* hx, T* hf, T* resid, bool* active,
                   const long long* it, T beta, T reg, T c_lim, T scf_tol,
                   int batch, int m, int nx, int device,
                   cudaStream_t stream) {
  // [G | rhs] and c
  const size_t system = static_cast<size_t>(m * (m + 1) + m) * sizeof(T);
  if (nx <= kSmallNx) {
    static size_t granted[64] = {};
    const size_t per_warp =
        static_cast<size_t>(2 * m * nx + nx) * sizeof(T) + system;
    int warps = kWarps;
    while (warps > 1 && warps * per_warp > kMaxDynamic) warps /= 2;
    if (per_warp > kMaxDynamic) return cudaErrorInvalidValue;
    const size_t smem = warps * per_warp;
    const cudaError_t err = allow_smem(window_warp<T>, smem, device, granted);
    if (err != cudaSuccess) return err;
    window_warp<T><<<(batch + warps - 1) / warps, warps * kWarp, smem,
                     stream>>>(x, f, hx, hf, resid, active, it, beta, reg,
                               c_lim, scf_tol, batch, m, nx);
    return cudaGetLastError();
  }
  static size_t granted[64] = {};
  // the whole window where it fits beside the system, else tiles of dF
  // and f (multiples of 32 wide)
  const size_t room = kMaxDynamic - system < kStageBytes
                          ? kMaxDynamic - system
                          : kStageBytes;
  int nt = nx;
  size_t tiles = static_cast<size_t>(2 * m + 1) * nx * sizeof(T);
  const bool staged = tiles <= room;
  if (!staged) {
    nt = static_cast<int>(room / ((m + 1) * sizeof(T))) / kWarp * kWarp;
    if (nt > nx) nt = nx;
    if (nt < kWarp) return cudaErrorInvalidValue;
    tiles = static_cast<size_t>(m + 1) * nt * sizeof(T);
  }
  const size_t smem = system + tiles;
  const cudaError_t err = allow_smem(window_block<T>, smem, device, granted);
  if (err != cudaSuccess) return err;
  window_block<T><<<batch, kThreads, smem, stream>>>(
      x, f, hx, hf, resid, active, it, beta, reg, c_lim, scf_tol, m, nx, nt,
      staged);
  return cudaGetLastError();
}

template <typename T>
int window(T* x, const T* f, T* hx, T* hf, T* resid, bool* active,
           const long long* it, double beta, double reg, double c_lim,
           double scf_tol, int batch, int m, int nx, int device,
           void* stream) {
  if (batch <= 0 || nx <= 0) return 0;
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    return launch<T>(x, f, hx, hf, resid, active, it, static_cast<T>(beta),
                     static_cast<T>(reg), static_cast<T>(c_lim),
                     static_cast<T>(scf_tol), batch, m, nx, device,
                     static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// x, f: (batch, nx); hx, hf: (batch, m, nx); resid: (batch,); active:
// bool (batch,); it: the int64 counter on the device. x, hx, hf, resid
// and active are updated in place.
int mqc_anderson_window_f32(float* x, const float* f, float* hx, float* hf,
                            float* resid, bool* active, const long long* it,
                            double beta, double reg, double c_lim,
                            double scf_tol, int batch, int m, int nx,
                            int device, void* stream) {
  return window<float>(x, f, hx, hf, resid, active, it, beta, reg, c_lim,
                       scf_tol, batch, m, nx, device, stream);
}

int mqc_anderson_window_f64(double* x, const double* f, double* hx,
                            double* hf, double* resid, bool* active,
                            const long long* it, double beta, double reg,
                            double c_lim, double scf_tol, int batch, int m,
                            int nx, int device, void* stream) {
  return window<double>(x, f, hx, hf, resid, active, it, beta, reg, c_lim,
                        scf_tol, batch, m, nx, device, stream);
}

const char* mqc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
