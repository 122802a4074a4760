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
// Entries (f32 and f64; all operands contiguous, one fragment after the
// other; sizes up to 64, the range of the fused density):
// - bmm: C = op(A) op(B), op(A) (m, k), op(B) (k, n), where op
//   transposes a matrix stored the other way round;
// - sandwich: C = (X F) X + S for (n, n) X, F, S, in one launch, X F kept
//   in shared memory;
// - matvec: y = op(M) x for op(M) (rows, cols).
//
// Arithmetic. Where every size is 8 or less (D3's (1, R) by (R, R) per
// atom pair), and for the matvec, a thread per output element by FMA in
// ascending k from global memory (the direct kernel). Above, a block per
// fragment: f64 on the FP64 tensor cores (mma.sync m8n8k4), each 8 x 8
// output tile accumulating over k in ascending blocks of 4, the operands
// padded with zeros to a multiple of 8 in shared memory (a zero block adds
// exact zeros); from 32 up a warp runs a 2 x 2 group of tiles at once
// (four independent chains, each tile's sum unchanged). f32 by FFMA in
// ascending k from 0 (no TF32, which would keep 10 bits of the mantissa),
// a thread holding TM x TN outputs in registers, so each value read from
// shared memory feeds several FMAs; each element's sum is the same
// whatever the tile. S is added to the rounded product, as torch's
// `a @ b + s` rounds.
//
// What bounds it. At the main path's shapes ((512, 16) to (5985, 32) and
// (128, 64)) a product is 2 n^3 operations over 3 n^2 elements moved:
// 10.7 operations a byte at n = 64 in f64, under the card's ridge (20 at
// 67 TFLOP/s and 3.35 TB/s), so the bound is the bytes; every launch is
// short, and one block per fragment keeps the batch's loads in flight on
// all SMs at once. The kernel launches on the caller's stream, allocates
// nothing, and the C entry points return cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxN = 64;
// products with every size up to this take the direct kernel
constexpr int kTiny = 8;
constexpr int kStaticSmem = 48 * 1024;

// Row stride of a staged matrix: f64 with 4 more than a multiple of 16
// (an m8n8k4 operand's 8 rows x 4 columns fall on distinct banks); f32 odd
// (a warp reads 32 rows of one column)
template <typename T, int N>
__host__ __device__ constexpr int ld_of() {
  return sizeof(T) == 8 ? N + 4 : N + 1;
}

template <int N>
__host__ __device__ constexpr int threads_of() {
  return N == 64 ? 256 : 128;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ double fma_(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// Issue the copies of a stored (rows, cols) matrix into s (row stride ld)
// and zero the padding up to the next multiples of 8: 8, 16 or 32
// threads a row as the padded row is long (shifts, no index division per
// element, and few threads idle on short rows).
template <typename T>
__device__ __forceinline__ void stage(T* s, int ld, const T* g, int rows,
                                      int cols) {
  const int pr = (rows + 7) & ~7, pc = (cols + 7) & ~7;
  const int shift = pc <= 8 ? 3 : pc <= 16 ? 4 : 5;
  const int per_row = 1 << shift;
  const int lane = threadIdx.x & (per_row - 1);
  for (int i = threadIdx.x >> shift; i < pr; i += blockDim.x >> shift) {
    const T* gi = g + static_cast<long long>(i) * cols;
    for (int j = lane; j < pc; j += per_row) {
      if (i < rows && j < cols) {
        cp_async(s + i * ld + j, gi + j);
      } else {
        s[i * ld + j] = T(0);
      }
    }
  }
}

// op(X)[r][c] of a matrix staged in shared memory as it is stored
template <typename T>
struct Op {
  const T* s;
  int ld;
  bool trans;
  __device__ __forceinline__ T operator()(int r, int c) const {
    return trans ? s[c * ld + r] : s[r * ld + c];
  }
};

// The outputs of a thread (f32) and the tiles of a warp (f64), by size
// class: f32 TM x TN, a thread for every TM x TN of the class's padded
// square (16: 1 x 2 on 128 threads, 32: 4 x 2 on 128, 64: 4 x 4 on 256);
// f64 G x G tiles of 8 x 8 a warp (16: 1, 32 and 64: 2)
template <int N>
struct Tiling {
  static constexpr int TM = N == 16 ? 1 : 4;
  static constexpr int TN = N == 64 ? 4 : 2;
  static constexpr int G = N == 16 ? 1 : 2;
};

// op(A) op(B), (m, k) by (k, n): sink(i, j, v) for every output element
// of the padded tiles (i and j may reach the next multiple of 8). f64: the
// warps take G x G groups of 8 x 8 tiles in turn on the tensor cores.
template <int N, typename Sink>
__device__ __forceinline__ void product(Op<double> a, Op<double> b, int m,
                                        int n, int k, Sink sink) {
  constexpr int G = Tiling<N>::G;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int ti_n = (m + 7) / 8, tj_n = (n + 7) / 8, kpad = (k + 3) & ~3;
  const int gi_n = (ti_n + G - 1) / G, gj_n = (tj_n + G - 1) / G;
  for (int group = warp; group < gi_n * gj_n; group += warps) {
    const int ti0 = (group / gj_n) * G, tj0 = (group % gj_n) * G;
    // a tile of the group past the last (warp-uniform) runs no mma
    bool row_ok[G], col_ok[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      row_ok[u] = ti0 + u < ti_n;
      col_ok[u] = tj0 + u < tj_n;
    }
    double d[G][G][2] = {};
    for (int k0 = 0; k0 < kpad; k0 += 4) {
      double av[G], bv[G];
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
#pragma unroll
    for (int u = 0; u < G; ++u) {
#pragma unroll
      for (int v = 0; v < G; ++v) {
        if (!(row_ok[u] && col_ok[v])) continue;
        const int i = (ti0 + u) * 8 + g, j = (tj0 + v) * 8 + 2 * t;
        sink(i, j, d[u][v][0]);
        sink(i, j + 1, d[u][v][1]);
      }
    }
  }
}

// f32: a thread per TM x TN set of the padded outputs in turn (rows i0 +
// r tiles_i, columns j0 + c tiles_j: neighbouring threads read and write
// neighbouring columns), each element by FFMA in ascending k
template <int N, typename Sink>
__device__ __forceinline__ void product(Op<float> a, Op<float> b, int m,
                                        int n, int k, Sink sink) {
  constexpr int TM = Tiling<N>::TM, TN = Tiling<N>::TN;
  const int tiles_i = ((m + 7) & ~7) / TM, tiles_j = ((n + 7) & ~7) / TN;
  for (int idx = threadIdx.x; idx < tiles_i * tiles_j; idx += blockDim.x) {
    const int i0 = idx / tiles_j, j0 = idx % tiles_j;
    float acc[TM][TN] = {};
    for (int q = 0; q < k; ++q) {
      float av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = a(i0 + r * tiles_i, q);
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = b(q, j0 + c * tiles_j);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fma_(av[r], bv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c)
        sink(i0 + r * tiles_i, j0 + c * tiles_j, acc[r][c]);
    }
  }
}

// C = op(A) op(B): one block per fragment
template <typename T, int N>
__global__ void __launch_bounds__(threads_of<N>())
    bmm_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ c, int m, int n, int k, bool trans_a,
               bool trans_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = ld_of<T, N>();
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + N * ld;
  const long long f = blockIdx.x;
  stage(as, ld, a + f * m * k, trans_a ? k : m, trans_a ? m : k);
  stage(bs, ld, b + f * k * n, trans_b ? n : k, trans_b ? k : n);
  cp_async_wait_all();
  __syncthreads();
  T* cf = c + f * m * n;
  product<N>(Op<T>{as, ld, trans_a}, Op<T>{bs, ld, trans_b}, m, n, k,
          [&](int i, int j, T v) {
            if (i < m && j < n) cf[i * n + j] = v;
          });
}

// C = (X F) X + S: one block per fragment, X F in shared memory
template <typename T, int N>
__global__ void __launch_bounds__(threads_of<N>())
    sandwich_kernel(const T* __restrict__ x, const T* __restrict__ f,
                    const T* __restrict__ s, T* __restrict__ c, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = ld_of<T, N>();
  T* xs = reinterpret_cast<T*>(smem);
  T* fs = xs + N * ld;
  T* ts = fs + N * ld;
  const long long off = static_cast<long long>(blockIdx.x) * n * n;
  stage(xs, ld, x + off, n, n);
  stage(fs, ld, f + off, n, n);
  cp_async_wait_all();
  __syncthreads();
  // the tiles write X F's padding too (zeros, from the zero padding of X
  // and F), which the second product reads
  product<N>(Op<T>{xs, ld, false}, Op<T>{fs, ld, false}, n, n, n,
             [&](int i, int j, T v) { ts[i * ld + j] = v; });
  __syncthreads();
  const T* sf = s + off;
  T* cf = c + off;
  product<N>(Op<T>{ts, ld, false}, Op<T>{xs, ld, false}, n, n, n,
             [&](int i, int j, T v) {
               if (i < n && j < n) cf[i * n + j] = v + sf[i * n + j];
             });
}

// C = op(A) op(B) with a thread per output element, FMA in ascending k
// from global memory: the matvec (n = 1) and the products whose sizes are
// all kTiny or less (D3's (1, R) by (R, R) per atom pair: a block per
// fragment would leave most of its threads idle there)
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

template <typename T, int N>
cudaError_t launch_bmm(const T* a, const T* b, T* c, int batch,
                       int m, int n, int k, bool ta, bool tb, int device,
                       cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = 2 * N * ld_of<T, N>() * sizeof(T);
  cudaError_t err = allow_smem(bmm_kernel<T, N>, smem, device, &done);
  if (err != cudaSuccess) return err;
  bmm_kernel<T, N><<<batch, threads_of<N>(), smem, stream>>>(a, b, c, m, n,
                                                            k, ta, tb);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_sandwich(const T* x, const T* f, const T* s, T* c,
                            int batch, int n, int device,
                            cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = 3 * N * ld_of<T, N>() * sizeof(T);
  cudaError_t err = allow_smem(sandwich_kernel<T, N>, smem, device, &done);
  if (err != cudaSuccess) return err;
  sandwich_kernel<T, N><<<batch, threads_of<N>(), smem, stream>>>(x, f, s,
                                                                  c, n);
  return cudaGetLastError();
}

// the size class of the staged tiles: 16, 32 or 64 (0: too large)
inline int size_class(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= kMaxN ? 64 : 0;
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

template <typename T>
int matvec(const T* mat, const T* x, T* y, int batch, int rows, int cols,
           int trans, int device, void* stream) {
  if (batch <= 0 || rows <= 0) return 0;
  if (cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  return direct<T>(mat, x, y, batch, rows, 1, cols, trans, 0, device,
                   stream);
}

template <typename T>
int bmm(const T* a, const T* b, T* c, int batch, int m, int n,
        int k, int trans_a, int trans_b, int device, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const int cls = size_class(m > n ? (m > k ? m : k) : (n > k ? n : k));
  if (k < 1 || cls == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= kTiny && n <= kTiny && k <= kTiny)
    return direct<T>(a, b, c, batch, m, n, k, trans_a, trans_b, device,
                     stream);
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (cls == 16)
      return launch_bmm<T, 16>(a, b, c, batch, m, n, k, trans_a, trans_b,
                               device, st);
    if (cls == 32)
      return launch_bmm<T, 32>(a, b, c, batch, m, n, k, trans_a, trans_b,
                               device, st);
    return launch_bmm<T, 64>(a, b, c, batch, m, n, k, trans_a, trans_b,
                             device, st);
  });
}

template <typename T>
int sandwich(const T* x, const T* f, const T* s, T* c, int batch, int n,
             int device, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int cls = size_class(n);
  if (cls == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (cls == 16)
      return launch_sandwich<T, 16>(x, f, s, c, batch, n, device, st);
    if (cls == 32)
      return launch_sandwich<T, 32>(x, f, s, c, batch, n, device, st);
    return launch_sandwich<T, 64>(x, f, s, c, batch, n, device, st);
  });
}

}  // namespace

extern "C" {

// a: (batch, m, k), or (batch, k, m) with trans_a; b: (batch, k, n), or
// (batch, n, k) with trans_b; c: (batch, m, n). m, n, k <= 64.
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

// x, f, s, c: (batch, n, n), n <= 64
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
// cols); y: (batch, rows)
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

const char* mqc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
