// Batched symmetric eigendecomposition through cuSOLVER, on the caller's
// stream, with no host synchronization.
//
// A thin binding of the library routine `torch.linalg.eigh` calls on a
// card for a batch of small matrices, for the SCC loop (ops/batched_eigh.py). The JAX package computes
// its in-loop eigh outside any Pallas kernel, with XLA's cuSOLVER call
// (metalquicha_tpu/methods/xtb/engine.py:392), so this is a library call
// and not a hand-written kernel. What `torch.linalg.eigh` adds around the
// same routine is a check of cuSOLVER's `info` on the host, which
// synchronizes the device with the host in every call: a call that
// synchronizes cannot be captured in a CUDA graph, and in an eager loop it
// stalls the host once per iteration. Here `info` stays on the device:
// `fold_info` folds it into one int per solve (the largest |info| seen),
// which the caller reads once, after the loop.
//
// The routine is cusolverDnXsyevBatched (64-bit API, default parameters,
// one call for the batch), looked up at run time so that an older
// toolkit's header need not declare it. It is the routine torch 2.11 calls
// for a batch of matrices up to 32, so there the eigenpairs are torch's
// bit for bit. For one matrix, and above 32, torch calls syevd (or syevj
// in float32), one matrix at a time; both synchronize inside the library,
// so neither can be captured in a CUDA graph, and the binding keeps
// XsyevBatched there too (its eigenpairs then differ from torch's in the
// last bits). It runs in place on a column-major copy of the matrices (the
// caller passes A^T row-major, i.e. A column-major, as torch makes it) and
// reads the lower triangle (torch's default UPLO = "L"); eigenvalues come
// out ascending, eigenvectors in the columns.
//
// Handles: one cuSOLVER handle per thread and device, made at the first
// call (before any capture: the SCC's warm-up iteration runs eagerly), with
// its stream set to the caller's at every call.
//
// The same file binds cuSOLVER's LU factorization and solve
// (cusolverDnXgetrf, cusolverDnXgetrs, one matrix after another on the
// caller's stream, their infos folded the same way), for CPCM's linear
// system (`ops/batched_eigh.py` `solve`): torch's `torch.linalg.solve`
// reads its info on the host, and for some shapes takes MAGMA's batched
// routines, which synchronize; neither can be captured.
//
// Return codes: 0, a cudaError_t, or kSolverBase + a cusolverStatus_t
// (`mqc_cuda_error_string` names both).

#include <cuda_runtime.h>
#include <cusolverDn.h>
#include <dlfcn.h>

#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kSolverBase = 10000;

struct Solver {
  cusolverDnHandle_t handle = nullptr;
  cusolverDnParams_t params = nullptr;
  std::vector<char> host_work;
};

thread_local Solver solvers[kMaxDevices];

int status(cusolverStatus_t s) {
  return s == CUSOLVER_STATUS_SUCCESS ? 0 : kSolverBase + static_cast<int>(s);
}

// The calling thread's solver for the current device, made at first use.
int solver_for(int device, Solver*& out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Solver& s = solvers[device];
  out = &s;
  if (s.handle != nullptr) return 0;
  int err = status(cusolverDnCreate(&s.handle));
  if (err == 0) err = status(cusolverDnCreateParams(&s.params));
  if (err != 0) s.handle = nullptr;
  return err;
}

// cusolverDnXsyevBatched and its buffer query, where the library has them
using SyevBatchedSize = cusolverStatus_t (*)(
    cusolverDnHandle_t, cusolverDnParams_t, cusolverEigMode_t,
    cublasFillMode_t, int64_t, cudaDataType, const void*, int64_t,
    cudaDataType, const void*, cudaDataType, size_t*, size_t*, int64_t);
using SyevBatched = cusolverStatus_t (*)(
    cusolverDnHandle_t, cusolverDnParams_t, cusolverEigMode_t,
    cublasFillMode_t, int64_t, cudaDataType, void*, int64_t, cudaDataType,
    void*, cudaDataType, void*, size_t, void*, size_t, int*, int64_t);

template <typename F>
F lookup(const char* name) {
  return reinterpret_cast<F>(dlsym(RTLD_DEFAULT, name));
}

// worst = max(worst, |info[i]|) over the batch: one int per solve
__global__ void fold_info(const int* __restrict__ info, int n,
                          int* __restrict__ worst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && info[i] != 0) atomicMax(worst, abs(info[i]));
}

constexpr cusolverEigMode_t kJobz = CUSOLVER_EIG_MODE_VECTOR;
constexpr cublasFillMode_t kUplo = CUBLAS_FILL_MODE_LOWER;

// Device and host bytes of workspace XsyevBatched needs.
int workspace(Solver& s, cudaDataType t, int n, int batch, size_t* dev,
              size_t* host) {
  const auto fn =
      lookup<SyevBatchedSize>("cusolverDnXsyevBatched_bufferSize");
  if (fn == nullptr) return cudaErrorNotSupported;
  return status(fn(s.handle, s.params, kJobz, kUplo, n, t, nullptr, n, t,
                   nullptr, t, dev, host, batch));
}

int solve(Solver& s, cudaDataType t, void* a, void* w, void* work,
          size_t work_bytes, int* info, int n, int batch) {
  const auto fn = lookup<SyevBatched>("cusolverDnXsyevBatched");
  if (fn == nullptr) return cudaErrorNotSupported;
  size_t need = 0, host = 0;
  const int err = workspace(s, t, n, batch, &need, &host);
  if (err != 0) return err;
  if (need > work_bytes) return cudaErrorInvalidValue;
  if (host > s.host_work.size()) s.host_work.resize(host);
  return status(fn(s.handle, s.params, kJobz, kUplo, n, t, a, n, t, w, t,
                   work, work_bytes, host > 0 ? s.host_work.data() : nullptr,
                   host, info, batch));
}

// Device and host bytes of workspace Xgetrf needs for one (n, n) matrix.
int lu_workspace(Solver& s, cudaDataType t, int n, size_t* dev,
                 size_t* host) {
  return status(cusolverDnXgetrf_bufferSize(s.handle, s.params, n, n, t,
                                            nullptr, n, t, dev, host));
}

// LU factors of each column-major (n, n) matrix of `a`, in place, with
// its pivots (int64, (batch, n)) and info (batch ints)
int lu_factor(Solver& s, cudaDataType t, size_t elem, void* a,
              int64_t* ipiv, void* work, size_t work_bytes, int* info,
              int n, int batch) {
  size_t need = 0, host = 0;
  int err = lu_workspace(s, t, n, &need, &host);
  if (err != 0) return err;
  if (need > work_bytes) return cudaErrorInvalidValue;
  if (host > s.host_work.size()) s.host_work.resize(host);
  char* base = static_cast<char*>(a);
  for (int i = 0; i < batch && err == 0; ++i) {
    err = status(cusolverDnXgetrf(
        s.handle, s.params, n, n, t, base + elem * n * n * i, n,
        ipiv + static_cast<int64_t>(n) * i, t, work, work_bytes,
        host > 0 ? s.host_work.data() : nullptr, host, info + i));
  }
  return err;
}

// Solves op(A_i) X_i = B_i from A_i's LU factors, B_i column-major (n,
// nrhs), overwritten by X_i; trans 1 for A^T
int lu_solve(Solver& s, cudaDataType t, size_t elem, int trans,
             const void* lu, const int64_t* ipiv, void* b, int* info, int n,
             int nrhs, int batch) {
  const char* lu_base = static_cast<const char*>(lu);
  char* b_base = static_cast<char*>(b);
  int err = 0;
  for (int i = 0; i < batch && err == 0; ++i) {
    err = status(cusolverDnXgetrs(
        s.handle, s.params, trans ? CUBLAS_OP_T : CUBLAS_OP_N, n, nrhs, t,
        lu_base + elem * n * n * i, n, ipiv + static_cast<int64_t>(n) * i,
        t, b_base + elem * n * nrhs * i, n, info + i));
  }
  return err;
}

// Runs fn(solver) on `device` and leaves the calling thread's current
// device as it found it.
template <typename Fn>
int on_device(int device, Fn fn) {
  int prev = 0;
  int err = static_cast<int>(cudaGetDevice(&prev));
  if (err != 0) return err;
  if (prev != device) {
    err = static_cast<int>(cudaSetDevice(device));
    if (err != 0) return err;
  }
  Solver* s = nullptr;
  err = solver_for(device, s);
  if (err == 0) err = fn(*s);
  if (prev != device) {
    const int restore = static_cast<int>(cudaSetDevice(prev));
    if (err == 0) err = restore;
  }
  return err;
}

}  // namespace

extern "C" {

// Workspace bytes on the device and on the host at (batch, n); dtype 0
// float32, 1 float64.
int mqc_eigh_workspace(int dtype, int n, int batch, int device,
                       long long* device_bytes, long long* host_bytes) {
  return on_device(device, [&](Solver& s) {
    size_t dev = 0, host = 0;
    const int err = workspace(s, dtype == 1 ? CUDA_R_64F : CUDA_R_32F, n,
                              batch, &dev, &host);
    *device_bytes = static_cast<long long>(dev);
    *host_bytes = static_cast<long long>(host);
    return err;
  });
}

// a: (batch, n, n) column-major matrices, overwritten with the
// eigenvectors in columns; w: (batch, n) eigenvalues, ascending; info:
// (batch) ints written by cuSOLVER; worst: one int, raised to the largest
// |info| of this call.
int mqc_eigh(int dtype, void* a, void* w, void* work, long long work_bytes,
             int* info, int* worst, int n, int batch, int device,
             void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return on_device(device, [&](Solver& s) {
    const auto st = static_cast<cudaStream_t>(stream);
    int err = status(cusolverDnSetStream(s.handle, st));
    if (err == 0)
      err = solve(s, dtype == 1 ? CUDA_R_64F : CUDA_R_32F, a, w, work,
                  static_cast<size_t>(work_bytes), info, n, batch);
    if (err != 0) return err;
    fold_info<<<(batch + 255) / 256, 256, 0, st>>>(info, batch, worst);
    return static_cast<int>(cudaGetLastError());
  });
}

// Workspace bytes on the device for one (n, n) LU factorization.
int mqc_lu_workspace(int dtype, int n, int device, long long* device_bytes,
                     long long* host_bytes) {
  return on_device(device, [&](Solver& s) {
    size_t dev = 0, host = 0;
    const int err = lu_workspace(s, dtype == 1 ? CUDA_R_64F : CUDA_R_32F, n,
                                 &dev, &host);
    *device_bytes = static_cast<long long>(dev);
    *host_bytes = static_cast<long long>(host);
    return err;
  });
}

// a: (batch, n, n) column-major, overwritten with its LU factors; ipiv:
// int64 (batch, n); info: (batch) ints; worst raised to the largest |info|.
int mqc_lu_factor(int dtype, void* a, long long* ipiv, void* work,
                  long long work_bytes, int* info, int* worst, int n,
                  int batch, int device, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  return on_device(device, [&](Solver& s) {
    const auto st = static_cast<cudaStream_t>(stream);
    int err = status(cusolverDnSetStream(s.handle, st));
    const bool f64 = dtype == 1;
    if (err == 0)
      err = lu_factor(s, f64 ? CUDA_R_64F : CUDA_R_32F,
                      f64 ? sizeof(double) : sizeof(float), a,
                      reinterpret_cast<int64_t*>(ipiv), work,
                      static_cast<size_t>(work_bytes), info, n, batch);
    if (err != 0) return err;
    fold_info<<<(batch + 255) / 256, 256, 0, st>>>(info, batch, worst);
    return static_cast<int>(cudaGetLastError());
  });
}

// lu, ipiv: mqc_lu_factor's; b: (batch, nrhs, n) rows, i.e. each B_i
// column-major (n, nrhs), overwritten by X_i; trans 1 solves A^T X = B.
int mqc_lu_solve(int dtype, int trans, const void* lu, const long long* ipiv,
                 void* b, int* info, int* worst, int n, int nrhs, int batch,
                 int device, void* stream) {
  if (batch <= 0 || n <= 0 || nrhs <= 0) return 0;
  return on_device(device, [&](Solver& s) {
    const auto st = static_cast<cudaStream_t>(stream);
    int err = status(cusolverDnSetStream(s.handle, st));
    const bool f64 = dtype == 1;
    if (err == 0)
      err = lu_solve(s, f64 ? CUDA_R_64F : CUDA_R_32F,
                     f64 ? sizeof(double) : sizeof(float), trans, lu,
                     reinterpret_cast<const int64_t*>(ipiv), b, info, n,
                     nrhs, batch);
    if (err != 0) return err;
    fold_info<<<(batch + 255) / 256, 256, 0, st>>>(info, batch, worst);
    return static_cast<int>(cudaGetLastError());
  });
}

// the version of the cuSOLVER this binding runs against (major * 1000 +
// minor * 100 + patch)
int mqc_eigh_solver_version(int* version) {
  return status(cusolverGetVersion(version));
}

const char* mqc_cuda_error_string(int code) {
  if (code >= kSolverBase) {
    switch (code - kSolverBase) {
      case CUSOLVER_STATUS_NOT_INITIALIZED: return "cusolver: not initialized";
      case CUSOLVER_STATUS_ALLOC_FAILED: return "cusolver: allocation failed";
      case CUSOLVER_STATUS_INVALID_VALUE: return "cusolver: invalid value";
      case CUSOLVER_STATUS_ARCH_MISMATCH: return "cusolver: arch mismatch";
      case CUSOLVER_STATUS_EXECUTION_FAILED:
        return "cusolver: execution failed";
      case CUSOLVER_STATUS_INTERNAL_ERROR: return "cusolver: internal error";
      case CUSOLVER_STATUS_NOT_SUPPORTED: return "cusolver: not supported";
      default: return "cusolver: error";
    }
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
