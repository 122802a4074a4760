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
// One thread an output (a warp or a block a row for fragment_sum): the
// sizes here are small (a fragment's AOs, atoms, moments), and simple
// first. The launches allocate nothing, never synchronize, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
// fragment_sum: rows up to this length take a warp, longer a block
constexpr long long kWarpRowMax = 4096;

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

// sum_d v[k, d] m[d, k, l] over d ascending, for one fragment's v (n, dv)
// and m (dv, n, n)
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
__global__ void moment_fock_kernel(const T* __restrict__ f,
                                   const T* __restrict__ v1,
                                   const T* __restrict__ m1, int d1,
                                   const T* __restrict__ v2,
                                   const T* __restrict__ m2, int d2,
                                   T* __restrict__ out, long long total,
                                   int n, int sym) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long nn = static_cast<long long>(n) * n;
  const long long b = idx / nn;
  const int r = static_cast<int>(idx - b * nn);
  const int k = r / n, l = r - (r / n) * n;
  const T* v1f = v1 + b * n * d1;
  const T* m1f = m1 + b * d1 * nn;
  const T* v2f = d2 > 0 ? v2 + b * n * d2 : nullptr;
  const T* m2f = d2 > 0 ? m2 + b * d2 * nn : nullptr;
  T g = contract(v1f, m1f, d1, n, k, l);
  if (d2 > 0) g = add_(g, contract(v2f, m2f, d2, n, k, l));
  if (!sym) {
    out[idx] = g;
    return;
  }
  T gt = contract(v1f, m1f, d1, n, l, k);
  if (d2 > 0) gt = add_(gt, contract(v2f, m2f, d2, n, l, k));
  out[idx] = sub_(f[idx], mul_(T(0.5), add_(g, gt)));
}

// c[k, e] = sum_l a[k, l] m[e, k, l], l ascending, for one fragment
template <typename T>
__device__ __forceinline__ T row_dot(const T* __restrict__ a,
                                     const T* __restrict__ m, int n, int k,
                                     int e) {
  const long long nn = static_cast<long long>(n) * n;
  const T* ar = a + static_cast<long long>(k) * n;
  const T* mr = m + e * nn + static_cast<long long>(k) * n;
  T acc = T(0);
  for (int l = 0; l < n; ++l) acc = add_(acc, mul_(ar[l], mr[l]));
  return acc;
}

// without an index: a thread per (b, k, e); with one: a thread per
// (b, s, e), k ascending over the fragment's rows in segment s
template <typename T>
__global__ void moment_rows_kernel(const T* __restrict__ a,
                                   const T* __restrict__ m, int d,
                                   const long long* __restrict__ seg,
                                   const T* __restrict__ w, int size,
                                   T* __restrict__ out, long long total,
                                   int n) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int rows = seg ? size : n;
  const long long per = static_cast<long long>(rows) * d;
  const long long b = idx / per;
  const int r = static_cast<int>(idx - b * per);
  const int s = r / d, e = r - (r / d) * d;
  const long long nn = static_cast<long long>(n) * n;
  const T* af = a + b * nn;
  const T* mf = m + b * d * nn;
  if (!seg) {
    out[idx] = row_dot(af, mf, n, s, e);
    return;
  }
  const long long* sf = seg + b * n;
  T acc = T(0);
  for (int k = 0; k < n; ++k) {
    if (sf[k] != s) continue;
    const T c = row_dot(af, mf, n, k, e);
    acc = add_(acc, w ? mul_(w[b * n + k], c) : c);
  }
  out[idx] = acc;
}

// a thread per (b, s, e), k ascending over the fragment's entries in
// segment s
template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ v,
                                   const long long* __restrict__ seg,
                                   const T* __restrict__ w, int size,
                                   T* __restrict__ out, long long total,
                                   int n, int c) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long per = static_cast<long long>(size) * c;
  const long long b = idx / per;
  const int r = static_cast<int>(idx - b * per);
  const int s = r / c, e = r - (r / c) * c;
  const long long* sf = seg + b * n;
  const T* vf = v + b * n * c;
  T acc = T(0);
  for (int k = 0; k < n; ++k) {
    if (sf[k] != s) continue;
    const T x = vf[static_cast<long long>(k) * c + e];
    acc = add_(acc, w ? mul_(w[b * n + k], x) : x);
  }
  out[idx] = acc;
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

// a warp per row (rows up to kWarpRowMax long): 32 lanes, then halved
// with shuffles, lane t + h into lane t
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

// a block of kThreads lanes per row (longer rows), halved through shared
// memory down to a warp, then with shuffles: the same pairing, t + h into t
template <typename T>
__global__ void row_sum_block_kernel(const T* __restrict__ x,
                                     T* __restrict__ out, long long len) {
  __shared__ T part[kThreads];
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  part[t] = strided_sum(x + row * len, len, t, kThreads);
  __syncthreads();
  for (int h = kThreads / 2; h >= kWarp; h /= 2) {
    if (t < h) part[t] = add_(part[t], part[t + h]);
    __syncthreads();
  }
  if (t < kWarp) {
    T v = part[t];
    for (int h = kWarp / 2; h > 0; h /= 2)
      v = add_(v, __shfl_down_sync(0xffffffffu, v, h));
    if (t == 0) out[row] = v;
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

inline bool too_many(long long threads) {
  return (threads + kThreads - 1) / kThreads > 0x7fffffffll;
}

inline unsigned blocks_of(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T>
int moment_fock(const T* f, const T* v1, const T* m1, int d1, const T* v2,
                const T* m2, int d2, T* out, int batch, int n, int sym,
                int device, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (d1 < 1 || d2 < 0 || (d2 > 0 && (!v2 || !m2)) || (sym && !f))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) * n * n;
  if (too_many(total)) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    moment_fock_kernel<T><<<blocks_of(total), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        f, v1, m1, d1, v2, m2, d2, out, total, n, sym);
    return cudaGetLastError();
  });
}

template <typename T>
int moment_rows(const T* a, const T* m, int d, const long long* seg,
                const T* w, int size, T* out, int batch, int n, int device,
                void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (d < 1 || (seg && size < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total =
      static_cast<long long>(batch) * (seg ? size : n) * d;
  if (total == 0) return 0;
  if (too_many(total)) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    moment_rows_kernel<T><<<blocks_of(total), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        a, m, d, seg, w, size, out, total, n);
    return cudaGetLastError();
  });
}

template <typename T>
int segment_sum(const T* v, const long long* seg, const T* w, int size,
                T* out, int batch, int n, int c, int device, void* stream) {
  if (batch <= 0 || size <= 0 || c <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) * size * c;
  if (too_many(total)) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    segment_sum_kernel<T><<<blocks_of(total), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        v, seg, w, size, out, total, n, c);
    return cudaGetLastError();
  });
}

template <typename T>
int fragment_sum(const T* x, T* out, long long rows, long long len,
                 int device, void* stream) {
  if (rows <= 0) return 0;
  if (len < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (len <= kWarpRowMax) {
    const long long threads = rows * kWarp;
    if (too_many(threads)) return static_cast<int>(cudaErrorInvalidValue);
    return on_device(device, [&] {
      row_sum_warp_kernel<T><<<blocks_of(threads), kThreads, 0, st>>>(
          x, out, rows, len);
      return cudaGetLastError();
    });
  }
  if (rows > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    row_sum_block_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0,
                              st>>>(x, out, len);
    return cudaGetLastError();
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
