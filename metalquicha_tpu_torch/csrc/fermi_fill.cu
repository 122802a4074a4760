// Fermi-level fill of a fragment batch's two spin channels.
//
// Replaces metalquicha_tpu/methods/xtb/engine.py:_fermi_fill (:324; its
// 80-step lax.fori_loop at :343), called twice by `occupations` (:361).
// Under jax.jit XLA compiles that loop into a loop on the device; this
// kernel is its counterpart for the port, where the plain torch version
// (ops/fermi_fill.py `fermi_occupations_reference`) makes about 13
// launches per bisection step. It is not a Pallas kernel: the JAX package
// writes it in jnp.
//
// For one row (a fragment's spin channel, n_el = 0.5 (nelec +- nuhf)
// electrons) it computes, as the JAX function does:
//   e = ao_mask > 0.5 ? eps : 1e3  (masked AOs read 1e3 in the sum),
//   lo = min e - 10, hi = max (ao_mask > 0.5 ? e : -1e3) + 10,
//   occ(mu) = 1 / (1 + exp(clamp((e - mu) / kt, -60, 60))),
//   80 steps: mid = 0.5 (lo + hi); sum occ(mid) > n_el ? hi = mid : lo = mid,
//   f = occ(0.5 (lo + hi)), fc = clamp(f, 1e-30, 1 - 1e-30),
//   entropy = sum over 1e-12 < f < 1 - 1e-12 of
//             -(fc log fc + (1 - fc) log(1 - fc)),
// with a division by kt (not a product with 1/kt) and the strict test.
// The row's values may come in any order (the Jacobi route leaves its
// eigenvalues unsorted). It writes f_alpha + f_beta (B, nao) and the two
// channels' entropies summed (B,): the channel stack and the final sum of
// `occupations` are fused into the one launch.
//
// Bound on this card: per row, 81 fills of nao values, each a subtraction,
// a division, a clamp, an exp, an add and a reciprocal, plus the sum's add
// (7 operations and the exp, which CUDA's exp computes in about 20 FP64
// operations: a range reduction and a degree-11 polynomial; expf in about
// 8), the min and max, and the entropy of the last fill. At (B, nao) =
// (512, 16) that is 37 MFLOP, 1.1 us at the FP64 vector rate of 34
// TFLOP/s; eps and the mask in, f out, 0.2 MB, 0.06 us at 3.35 TB/s.
// Every shape is bound by operations. Tensor cores play no part: the work
// is exp, a division and a reduction, with no matrix product. In practice
// a step is one chain of dependent division, exp and five shuffles, so a
// small batch is bound by the latency of 80 such chains.
//
// Design: a block of two warps per fragment, warp 0 on the alpha channel
// and warp 1 on the beta channel. Lane l keeps e[l + 32 k] (k < K) in
// registers, K the power of two that holds the row (nao <= 256); a longer
// row is read again from device memory (through L1) at every step. Each
// step sums the lane's values in order and then the warp with a butterfly
// of __shfl_xor_sync, so every lane holds the same total bit for bit and
// takes the same branch: the loop needs no barrier. Warp 0 writes f_alpha
// and its entropy; after one block barrier warp 1 adds f_beta and its
// own (f_alpha + f_beta, as the plain version adds them).
//
// The kernel launches on the caller's stream, allocates nothing, and the
// C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSteps = 80;
constexpr int kMaxK = 8;  // registers per lane for the row: nao <= 256
constexpr unsigned kFull = 0xffffffffu;

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1)
    v = min_nan(v, __shfl_xor_sync(kFull, v, m));
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1)
    v = max_nan(v, __shfl_xor_sync(kFull, v, m));
  return v;
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

// The row's values seen by one lane: K > 0 in registers, K == 0 read from
// device memory at every visit.
template <typename T, int K>
struct Row {
  T e[K > 0 ? K : 1];
  const T* eps;
  const T* mask;
  int nao;
  int lane;

  __device__ __forceinline__ T masked(int j) const {
    return mask[j] > T(0.5) ? eps[j] : T(1.0e3);
  }

  __device__ __forceinline__ void load() {
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = lane + kWarp * k;
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
        const int j = lane + kWarp * k;
        if (j < nao) fn(j, e[k]);
      }
    } else {
      for (int j = lane; j < nao; j += kWarp) fn(j, masked(j));
    }
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(2 * kWarp)
    fermi_fill_kernel(const T* __restrict__ eps, const T* __restrict__ mask,
                      const T* __restrict__ nelec,
                      const T* __restrict__ nuhf, T kt, T* __restrict__ f,
                      T* __restrict__ entropy, int nao) {
  __shared__ T entropy_alpha;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const bool beta = threadIdx.x >= kWarp;
  const size_t off = static_cast<size_t>(b) * nao;

  Row<T, K> row;
  row.eps = eps + off;
  row.mask = mask + off;
  row.nao = nao;
  row.lane = lane;
  row.load();

  const T n_el = beta ? T(0.5) * (nelec[b] - nuhf[b])
                      : T(0.5) * (nelec[b] + nuhf[b]);
  const T inf = static_cast<T>(INFINITY);
  T lo = inf, hi = -inf;
  row.visit([&](int j, T e) {
    lo = min_nan(lo, e);
    hi = max_nan(hi, row.mask[j] > T(0.5) ? e : T(-1.0e3));
  });
  lo = warp_min(lo) - T(10.0);
  hi = warp_max(hi) + T(10.0);

  for (int step = 0; step < kSteps; ++step) {
    const T mid = T(0.5) * (lo + hi);
    T n = T(0);
    row.visit([&](int, T e) { n += occ(e, mid, kt); });
    const bool too_many = warp_sum(n) > n_el;
    lo = too_many ? lo : mid;
    hi = too_many ? mid : hi;
  }
  const T mu = T(0.5) * (lo + hi);

  T* f_row = f + off;
  T s = T(0);
  if (!beta) {
    row.visit([&](int j, T e) {
      const T fj = occ(e, mu, kt);
      f_row[j] = fj;
      s += entropy_of(fj);
    });
    s = warp_sum(s);
    if (lane == 0) entropy_alpha = s;
  }
  // f_alpha and its entropy are visible to warp 1 after the barrier
  __syncthreads();
  if (beta) {
    row.visit([&](int j, T e) {
      const T fj = occ(e, mu, kt);
      f_row[j] = f_row[j] + fj;
      s += entropy_of(fj);
    });
    s = warp_sum(s);
    if (lane == 0) entropy[b] = entropy_alpha + s;
  }
}

template <typename T, int K>
cudaError_t launch_k(const T* eps, const T* mask, const T* nelec,
                     const T* nuhf, T kt, T* f, T* entropy, int batch,
                     int nao, cudaStream_t stream) {
  fermi_fill_kernel<T, K><<<batch, 2 * kWarp, 0, stream>>>(
      eps, mask, nelec, nuhf, kt, f, entropy, nao);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_on_current_device(const T* eps, const T* mask,
                                     const T* nelec, const T* nuhf, T kt,
                                     T* f, T* entropy, int batch, int nao,
                                     cudaStream_t stream) {
  const int k = (nao + kWarp - 1) / kWarp;
  if (k <= 1)
    return launch_k<T, 1>(eps, mask, nelec, nuhf, kt, f, entropy, batch,
                          nao, stream);
  if (k <= 2)
    return launch_k<T, 2>(eps, mask, nelec, nuhf, kt, f, entropy, batch,
                          nao, stream);
  if (k <= 4)
    return launch_k<T, 4>(eps, mask, nelec, nuhf, kt, f, entropy, batch,
                          nao, stream);
  if (k <= kMaxK)
    return launch_k<T, kMaxK>(eps, mask, nelec, nuhf, kt, f, entropy, batch,
                              nao, stream);
  return launch_k<T, 0>(eps, mask, nelec, nuhf, kt, f, entropy, batch, nao,
                        stream);
}

// Launches on `device` and leaves the calling thread's current device as
// it found it.
template <typename T>
int launch(const T* eps, const T* mask, const T* nelec, const T* nuhf,
           double kt, T* f, T* entropy, int batch, int nao, int device,
           void* stream) {
  if (batch <= 0 || nao <= 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch_on_current_device<T>(eps, mask, nelec, nuhf,
                                    static_cast<T>(kt), f, entropy, batch,
                                    nao, static_cast<cudaStream_t>(stream));
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int mqc_fermi_fill_f32(const float* eps, const float* mask,
                       const float* nelec, const float* nuhf, double kt,
                       float* f, float* entropy, int batch, int nao,
                       int device, void* stream) {
  return launch<float>(eps, mask, nelec, nuhf, kt, f, entropy, batch, nao,
                       device, stream);
}

int mqc_fermi_fill_f64(const double* eps, const double* mask,
                       const double* nelec, const double* nuhf, double kt,
                       double* f, double* entropy, int batch, int nao,
                       int device, void* stream) {
  return launch<double>(eps, mask, nelec, nuhf, kt, f, entropy, batch, nao,
                        device, stream);
}

const char* mqc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
