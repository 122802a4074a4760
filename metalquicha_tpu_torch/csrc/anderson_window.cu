// The Anderson window step of the SCC loop, one fragment per block.
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
//   x_and = x + beta f - c^T (dX + beta dF), x_damped = x + beta f,
//   bad = it < 1 or a non-finite x_and or max |c| > c_lim,
//   x_next = bad ? x_damped : x_and,
// and, for a fragment still active (every fragment at it = 0), x = x_next
// and resid = it_resid; then active = (active or it = 0) and resid >
// scf_tol. The counter's increment is the caller's: one block cannot bump
// a value that the others read.
//
// What bounds it. Per fragment, (m(m+1)/2 + m) dot products of length nx
// (2 FLOP per element), the (m, m) elimination (m^3 / 3 multiply-adds,
// one warp, a chain of m pivot steps) and the step (2 m FLOP per element);
// the bytes are the two windows read (2 m nx elements), x and f read, x
// and the new window slots written. At the main path's shapes (m = 12, nx
// = 12-400) both bounds are a few microseconds for the whole batch, and
// the launch is bound by the latency of each block's chain: the dot
// products' shuffle trees, the elimination's 12 dependent pivot steps and
// the block barriers between the phases.
//
// What the design does about it, and for the bits:
// - One block of 128 threads per fragment; a fragment's arithmetic is the
//   same whatever the batch or the fragment's place in it, so its bits do
//   not depend on either (what C17 asks of the window).
// - The dot products: one warp per product, its lanes striding over nx
//   with fused multiply-adds in a fixed order, summed by a fixed
//   __shfl_xor_sync butterfly (every lane ends with the same bits). The
//   window is read through L1; the slot just written is read from the
//   caller's x and f.
// - G and rhs go to shared memory as one augmented (m, m + 1) matrix. One
//   warp eliminates, a lane per row: the pivot is the first index of the
//   largest |.| (a NaN counts as the largest), as LAPACK's i?amax and
//   torch.argmax pick it; the row update is a - f b rounded twice (no
//   contraction into an FMA), as the elementwise plain twin computes it
//   (`anderson_window_rowwise`). m <= 32.
// - The step and the update are elementwise, rounded as the plain version
//   rounds x + beta f (no FMA); `bad` and the residual are block
//   reductions.
//
// The kernel launches on the caller's stream, allocates nothing, and the
// C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxM = 32;
constexpr unsigned kFull = 0xffffffffu;

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

template <typename T>
struct Window {
  const T* hx;  // the fragment's (m, nx) windows
  const T* hf;
  const T* x;   // its state and residual vector
  const T* f;
  int slot, prev, m, nx;
  long long it;

  __device__ bool valid(int j) const { return j <= it && j != prev; }
  // window entries, the slot being written read from x and f
  __device__ T wx(int j, int e) const {
    return j == slot ? x[e] : hx[static_cast<long long>(j) * nx + e];
  }
  __device__ T wf(int j, int e) const {
    return j == slot ? f[e] : hf[static_cast<long long>(j) * nx + e];
  }
  __device__ T dX(int j, int e) const {
    return valid(j) ? sub(wx(j, e), wx(prev, e)) : T(0);
  }
  __device__ T dF(int j, int e) const {
    return valid(j) ? sub(wf(j, e), wf(prev, e)) : T(0);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_kernel(T* __restrict__ x, const T* __restrict__ f, T* __restrict__ hx,
              T* __restrict__ hf, T* __restrict__ resid,
              bool* __restrict__ active, const long long* __restrict__ it_ptr,
              T beta, T reg, T c_lim, T scf_tol, int m, int nx) {
  __shared__ T aug[kMaxM][kMaxM + 1];  // [G | rhs], then eliminated
  __shared__ T c[kMaxM];
  __shared__ T red[kWarps];
  __shared__ int bad_any;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const long long it = *it_ptr;
  const long long mm = m;
  const int slot = static_cast<int>(it % mm);
  const int prev = static_cast<int>((((it - 1) % mm) + mm) % mm);
  T* xb = x + static_cast<long long>(b) * nx;
  const T* fb = f + static_cast<long long>(b) * nx;
  T* hxb = hx + static_cast<long long>(b) * m * nx;
  T* hfb = hf + static_cast<long long>(b) * m * nx;
  const Window<T> w{hxb, hfb, xb, fb, slot, prev, m, nx, it};

  // the residual; the new window slot
  T amax = T(0);
  for (int e = tid; e < nx; e += kThreads) {
    const T fe = fb[e];
    amax = max_nan(amax, fabs(fe));
    hxb[static_cast<long long>(slot) * nx + e] = xb[e];
    hfb[static_cast<long long>(slot) * nx + e] = fe;
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  if (tid == 0) bad_any = 0;
  __syncthreads();
  T it_resid = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) it_resid = max_nan(it_resid, red[k]);

  // G's upper triangle and rhs: one warp per dot product
  const int n_g = m * (m + 1) / 2;
  for (int p = warp; p < n_g + m; p += kWarps) {
    int j, k;
    if (p < n_g) {  // p -> (j, k), j <= k, row by row
      j = 0;
      int q = p;
      while (q >= m - j) {
        q -= m - j;
        ++j;
      }
      k = j + q;
    } else {
      j = p - n_g;
      k = -1;
    }
    // a masked row is 0 and still multiplied, as in the plain version's
    // product (0 times a non-finite value is NaN there too)
    T acc = T(0);
    for (int e = lane; e < nx; e += kWarp) {
      const T other = k < 0 ? fb[e] : w.dF(k, e);
      acc = fma_(w.dF(j, e), other, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      if (k < 0) {
        aug[j][m] = acc;
      } else {
        aug[j][k] = acc;
        aug[k][j] = acc;
      }
    }
  }
  __syncthreads();

  // the regularizer, then the elimination: warp 0, a lane per row
  if (warp == 0) {
    if (lane == 0) {
      T tr = T(0);
      for (int j = 0; j < m; ++j) tr = add(tr, aug[j][j]);
      const T shift = add(dvd(mul(reg, tr), T(m)), T(1e-30));
      for (int j = 0; j < m; ++j) aug[j][j] = add(aug[j][j], shift);
    }
    __syncwarp();
    for (int k = 0; k < m; ++k) {
      T v = T(-1);
      int i = kMaxM;
      if (lane >= k && lane < m) {
        v = fabs(aug[lane][k]);
        i = lane;
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
      const int p = i;
      if (p != k) {
        for (int col = lane; col <= m; col += kWarp) {
          const T t = aug[k][col];
          aug[k][col] = aug[p][col];
          aug[p][col] = t;
        }
      }
      __syncwarp();
      if (lane > k && lane < m) {
        const T piv = dvd(aug[lane][k], aug[k][k]);
        for (int col = 0; col <= m; ++col)
          aug[lane][col] = sub(aug[lane][col], mul(piv, aug[k][col]));
      }
      __syncwarp();
    }
    if (lane == 0) {
      for (int k = m - 1; k >= 0; --k) {
        T acc = T(0);
        for (int j = k + 1; j < m; ++j) acc = add(acc, mul(aug[k][j], c[j]));
        c[k] = dvd(sub(aug[k][m], acc), aug[k][k]);
      }
    }
  }
  __syncthreads();

  // the step: rejected where a value is not finite
  T cmax = T(0);
  for (int j = 0; j < m; ++j) cmax = max_nan(cmax, fabs(c[j]));
  const T bf = beta;
  int nonfinite = 0;
  for (int e = tid; e < nx; e += kThreads) {
    T step = T(0);
    for (int j = 0; j < m; ++j)
      step = fma_(c[j], add(w.dX(j, e), mul(bf, w.dF(j, e))), step);
    const T x_and = sub(add(xb[e], mul(bf, fb[e])), step);
    nonfinite |= !isfinite(x_and);
  }
  nonfinite = __any_sync(kFull, nonfinite);
  if (lane == 0 && nonfinite) atomicOr(&bad_any, 1);
  __syncthreads();
  const bool bad = it < 1 || bad_any || cmax > c_lim;

  // every fragment is active at the first iteration (a cached loop's
  // restart resets only the counter)
  const bool on = active[b] || it < 1;
  if (on) {
    for (int e = tid; e < nx; e += kThreads) {
      const T damped = add(xb[e], mul(bf, fb[e]));
      if (bad) {
        xb[e] = damped;
      } else {
        T step = T(0);
        for (int j = 0; j < m; ++j)
          step = fma_(c[j], add(w.dX(j, e), mul(bf, w.dF(j, e))), step);
        xb[e] = sub(damped, step);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
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

template <typename T>
int window(T* x, const T* f, T* hx, T* hf, T* resid, bool* active,
           const long long* it, double beta, double reg, double c_lim,
           double scf_tol, int batch, int m, int nx, int device,
           void* stream) {
  if (batch <= 0 || nx <= 0) return 0;
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    window_kernel<T><<<batch, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        x, f, hx, hf, resid, active, it, static_cast<T>(beta),
        static_cast<T>(reg), static_cast<T>(c_lim), static_cast<T>(scf_tol),
        m, nx);
    return cudaGetLastError();
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
