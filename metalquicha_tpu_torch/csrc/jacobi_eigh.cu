// Batched symmetric eigensolver: parallel-order two-sided Jacobi sweeps.
//
// Replaces metalquicha_tpu/ops/jacobi_eigh.py:_jacobi_kernel (:37, launched
// by batched_jacobi_eigh through pallas_call at :112), the one Pallas
// kernel of the JAX package. It diagonalizes the many small Fock matrices
// (N <= 64 AOs) of an MBE fragment batch inside every SCC iteration.
//
// Rotations: each sweep runs the N-1 rounds of the round-robin (Brent-Luk)
// ordering (N rounds with a phantom index when N is odd). A round applies
// N/2 disjoint rotations. Each is the JAX kernel's
//   tau = (a_qq - a_pp) / (2 a_pq), t = sgn(tau) / (|tau| + sqrt(1 + tau^2)),
//   c = rsqrt(1 + t^2), s = t c,
// skipped (c = 1, s = 0) when |2 a_pq| <= 1e-12 (|a_pp| + |a_qq| + 1), as
// there. It is evaluated without a division: with d = a_qq - a_pp,
// e = 2 a_pq, r = sqrt(d^2 + e^2) and u = |d| + r, 1 + t^2 = 2r / u, so
//   c = u g, s = sgn(tau) |e| g, g = rsqrt(2 r u).
// sgn(0) is +1: the JAX kernel's jnp.sign(0) = 0 leaves a pair with equal
// diagonal entries unrotated (a fault of the reference, ROADMAP C6). The
// plain torch version (ops/jacobi_eigh.py) applies the same rotations in
// the same order, rows of A first, then columns of A and of V.
//
// Bound on this card: a rotation needs 12N FLOP (6 per pair of updated
// elements: the N-2 off-diagonal pairs of rows p, q of A, mirrored into
// the columns, and the N pairs of V's columns p, q) plus ~20 for (c, s)
// and the 2x2 diagonal block; N(N-1)/2 rotations per sweep. At 10 sweeps
// that is 130 MFLOP at (B, N) = (512, 16) and 12.0 GFLOP at (5985, 32),
// i.e. 1.9 us and 180 us at the H100's FP64 peak of 67 TFLOP/s (through
// the tensor cores; twice that outside them); A, w and V move 2.2 MB and
// 100 MB through device memory, 0.65 us and 30 us at 3.35 TB/s. Every
// shape is bound by operations. This kernel rotates every 2x2 block of A
// (18N FLOP per rotation). In practice a large batch is bound by
// shared-memory traffic (an 8-byte access per two FMAs) and a small one
// by the latency of each round's chain of dependent steps.
//
// Design (a kernel that gives each matrix a block, with three block
// barriers per round and N/2 threads computing (c, s) while the rest
// wait, runs at about half this speed):
// - A team of threads owns one matrix; A and V live in its slice of
//   dynamic shared memory. For 16 < N <= 32 the team is one warp and a
//   block holds several matrices (the launcher picks the number that
//   holds the batch in the fewest waves); its barriers are __syncwarp.
//   For N <= 16 the team is two warps, one matrix per block: a round's
//   chain is then shorter than with one warp. For 32 < N <= 64 the team
//   is a 256-thread block. Occupancy is queried once per device, not per
//   launch.
// - For N <= 32 the rows are unpadded and the lanes of each access cover
//   both columns of every slot, so shared memory has no bank conflicts
//   (`kCoverBoth`); for 32 < N <= 64 rows are padded to NP + 1.
// - The width NP (16, 32 or 64) is a template parameter: every index is
//   a shift or a mask of a compile-time power of two, masked up to the
//   matrix's N, and the round-robin pair comes from one conditional
//   subtraction, with no runtime division.
// - Rows-then-columns is applied per 2x2 block: the rows {p_k, q_k} and
//   columns {p_l, q_l} of two rotations k, l of a round form a block whose
//   new values depend on its old values and on (c, s) of k and l only. So
//   each thread rotates whole blocks (the plain version's arithmetic, in
//   the same order) and each element of A is read and written once per
//   round. A round has two team barriers: after (c, s) of every slot has
//   been computed from the A the round starts from (each thread evaluates
//   one slot's, so no thread waits on a divergent branch), and after the
//   update of A. V feeds nothing inside the loop, so its rotations by a
//   round's (c, s) (kept for two rounds) run beside the next round's
//   (c, s) chain. Each thread issues all the loads of a phase before its
//   stores, so they are in flight together.
// - An odd N is padded with a zero row and column (the phantom index):
//   its pairs then fall under the skip rule and leave A and V as they are.
//
// The kernel launches on the caller's stream, allocates nothing, and the
// C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

template <int X>
struct Log2 {
  static constexpr int value = 1 + Log2<X / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <int TS>
__device__ __forceinline__ void team_sync() {
  if constexpr (TS == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Pair of slot k in round r of the round-robin ordering over m (even)
// indices: index m-1 stays put, the others rotate. Returns p < q.
// r < m-1 and k < m/2, so one conditional step replaces the modulo.
__device__ __forceinline__ void round_robin_pair(int r, int k, int m, int& p,
                                                 int& q) {
  int a, b;
  if (k == 0) {
    a = m - 1;
    b = r;
  } else {
    a = r + k;
    if (a >= m - 1) a -= m - 1;
    b = r - k;
    if (b < 0) b += m - 1;
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  c = T(1);
  s = T(0);
  const T e = T(2) * apq;
  if (abs_t(e) > T(1e-12) * (abs_t(app) + abs_t(aqq) + T(1))) {
    const T d = aqq - app;
    const T r = sqrt_t(d * d + e * e);
    const T u = abs_t(d) + r;
    const T g = rsqrt_t(T(2) * r * u);
    // sgn(tau) with tau = d / e and sgn(0) = +1
    const bool neg = d != T(0) && ((d < T(0)) != (e < T(0)));
    c = u * g;
    s = (neg ? -abs_t(e) : abs_t(e)) * g;
  }
}

// Whether a team's A and V rows are unpadded, with the lanes of each
// warp-wide access covering both columns of every slot (see `flip`
// below). With NP a multiple of 16 and unpadded rows, the bank of (i, j)
// depends on j only (an 8-byte word spans two of the 32 four-byte banks,
// so j and j + 16 share a pair), so no two lanes collide beyond the two
// wavefronts an 8-byte access takes. For NP <= 32 a warp spans several
// row groups k0; timed against rows padded to NP + 1 (PERF.md) this
// is faster at the main path's shapes (by up to 13%, f32 N = 32). For
// NP = 64 all lanes of a warp share k0, so rows are padded to NP + 1.
template <int NP>
constexpr bool kCoverBoth = NP <= 32;

// Row stride and size of a team's A and V.
template <int NP, int TS>
struct Team {
  static constexpr int ld = kCoverBoth<NP> ? NP : NP + 1;
  // A and V, and (c, s) per slot for two rounds
  static constexpr int elems = 2 * NP * ld + 2 * NP;
};

// V <- V J for the column pair (pl, ql) of one rotation, on the rows
// i = i0 + STEP * it < n. All loads come before all stores, so they issue
// together (a store could alias a later load).
template <typename T, int LD, int STEP, int ITEMS>
__device__ __forceinline__ void rotate_v_columns(T* Vs, int i0, int n, int pl,
                                                 int ql, T c, T s) {
  T vp[ITEMS], vq[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = i0 + STEP * it;
    if (i < n) {
      vp[it] = Vs[i * LD + pl];
      vq[it] = Vs[i * LD + ql];
    }
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = i0 + STEP * it;
    if (i < n) {
      Vs[i * LD + pl] = c * vp[it] - s * vq[it];
      Vs[i * LD + ql] = s * vp[it] + c * vq[it];
    }
  }
}

template <typename T, int NP, int TS>
__global__ void __launch_bounds__(kMaxThreads)
    jacobi_eigh_kernel(const T* __restrict__ a, T* __restrict__ w,
                       T* __restrict__ v, int batch, int n, int sweeps) {
  constexpr int H = NP / 2;  // rotation slots per round
  constexpr int LD = Team<NP, TS>::ld;
  constexpr int LOG_NP = Log2<NP>::value;
  constexpr int LOG_H = Log2<H>::value;
  constexpr int LOG_TS = Log2<TS>::value;
  constexpr int KSTEP = TS / H;  // stride of a thread's row slots / V rows
  constexpr int A_ITEMS = H / KSTEP;
  constexpr int V_ITEMS = NP / KSTEP;
  static_assert(TS % H == 0 && H % KSTEP == 0, "team too small for NP");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x & (TS - 1);
  const int team = threadIdx.x >> LOG_TS;
  const long long mat =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> LOG_TS) + team;
  if (mat >= batch) return;  // a whole team leaves together
  T* As = reinterpret_cast<T*>(smem_raw) + team * Team<NP, TS>::elems;
  T* Vs = As + NP * LD;
  T* cs = Vs + NP * LD;  // [2][H], by round parity
  T* sn = cs + 2 * H;

  const int m = n + (n & 1);  // with the phantom index of an odd N
  const int half = m >> 1;
  const T* am = a + mat * n * n;
  for (int idx = tid; idx < NP * NP; idx += TS) {
    const int i = idx >> LOG_NP, j = idx & (NP - 1);
    if (i < m && j < m) {
      As[i * LD + j] = (i < n && j < n) ? am[i * n + j] : T(0);
      Vs[i * LD + j] = i == j ? T(1) : T(0);
    }
  }
  team_sync<TS>();

  // this thread's column slot l, and its first row slot (A) / row (V)
  const int l = tid & (H - 1);
  const int k0 = tid >> LOG_H;
  const bool active = l < half;
  // Threads with an odd k0 take a slot's two columns in the other order
  // (q first), which is the same rotation with s negated.
  const bool flip = kCoverBoth<NP> && (k0 & 1);
  // this thread's (c, s) slot: every thread evaluates one, so the chain
  // runs beside the V rotations with no divergent branch
  const int cs_slot = l < half ? l : half - 1;
  int pl = 0, ql = 0;  // slot l's columns in the previous round, as taken
  const int total = sweeps * (m - 1);
  int r = 0;  // round within the sweep
  for (int g = 0; g < total; ++g) {
    const int buf = (g & 1) * H, prev = H - buf;
    // (c, s) of this round from the A it starts from; meanwhile V takes
    // the previous round's rotations (V feeds nothing inside the loop)
    int p, q;
    round_robin_pair(r, cs_slot, m, p, q);
    const T app = As[p * LD + p], aqq = As[q * LD + q], apq = As[p * LD + q];
    if (g > 0 && active) {
      const T sv = sn[prev + l];
      rotate_v_columns<T, LD, KSTEP, V_ITEMS>(Vs, k0, n, pl, ql, cs[prev + l],
                                              flip ? -sv : sv);
    }
    T c, s;
    rotation(app, aqq, apq, c, s);
    if (tid < half) {
      cs[buf + tid] = c;
      sn[buf + tid] = s;
    }
    team_sync<TS>();

    // the 2x2 blocks (rows of slot k, columns of slot l): rows, then
    // columns, as the plain version; all loads first
    if (active) {
      round_robin_pair(r, l, m, pl, ql);
      if (flip) {
        const int t = pl;
        pl = ql;
        ql = t;
      }
      const T cl = cs[buf + l], sl = flip ? -sn[buf + l] : sn[buf + l];
      T x[A_ITEMS][4], ck[A_ITEMS], sk[A_ITEMS];
      int pk[A_ITEMS], qk[A_ITEMS];
#pragma unroll
      for (int it = 0; it < A_ITEMS; ++it) {
        const int k = k0 + KSTEP * it;
        if (k < half) {
          round_robin_pair(r, k, m, pk[it], qk[it]);
          ck[it] = cs[buf + k];
          sk[it] = sn[buf + k];
          x[it][0] = As[pk[it] * LD + pl];
          x[it][1] = As[pk[it] * LD + ql];
          x[it][2] = As[qk[it] * LD + pl];
          x[it][3] = As[qk[it] * LD + ql];
        }
      }
#pragma unroll
      for (int it = 0; it < A_ITEMS; ++it) {
        if (k0 + KSTEP * it < half) {
          const T y00 = ck[it] * x[it][0] - sk[it] * x[it][2];
          const T y01 = ck[it] * x[it][1] - sk[it] * x[it][3];
          const T y10 = sk[it] * x[it][0] + ck[it] * x[it][2];
          const T y11 = sk[it] * x[it][1] + ck[it] * x[it][3];
          As[pk[it] * LD + pl] = cl * y00 - sl * y01;
          As[pk[it] * LD + ql] = sl * y00 + cl * y01;
          As[qk[it] * LD + pl] = cl * y10 - sl * y11;
          As[qk[it] * LD + ql] = sl * y10 + cl * y11;
        }
      }
    }
    team_sync<TS>();
    if (++r == m - 1) r = 0;
  }
  if (total > 0 && active) {
    const int last = ((total - 1) & 1) * H;
    const T sv = sn[last + l];
    rotate_v_columns<T, LD, KSTEP, V_ITEMS>(Vs, k0, n, pl, ql, cs[last + l],
                                            flip ? -sv : sv);
  }
  team_sync<TS>();

  T* vm = v + mat * n * n;
  for (int idx = tid; idx < NP * NP; idx += TS) {
    const int i = idx >> LOG_NP, j = idx & (NP - 1);
    if (i < n && j < n) vm[i * n + j] = Vs[i * LD + j];
  }
  for (int i = tid; i < n; i += TS) w[mat * n + i] = As[i * LD + i];
}

constexpr int kMaxDevices = 64;

// Per device: the SM count and, for a block of 1, 2, 4, 8 teams of TS
// threads, the blocks each SM holds (0: the block does not fit). Queried
// once per device, when the kernel's dynamic shared-memory limit is also
// raised to its largest block, so a launch makes no attribute calls.
struct Residency {
  bool ready = false;
  int sms = 0;
  int per_sm[4] = {0, 0, 0, 0};
};

template <typename T, int NP, int TS>
cudaError_t residency(int device, const Residency*& out) {
  static Residency cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Residency& r = cache[device];
  out = &r;
  if (r.ready) return cudaSuccess;
  auto kernel = jacobi_eigh_kernel<T, NP, TS>;
  const size_t team_bytes = Team<NP, TS>::elems * sizeof(T);
  // a team of more than a warp syncs the whole block: one team per block
  const int max_teams = TS == 32 ? kMaxThreads / 32 : 1;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  int teams = 1;
  while (err == cudaSuccess && teams * 2 <= max_teams &&
         teams * 2 * team_bytes <= static_cast<size_t>(optin))
    teams *= 2;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(teams * team_bytes));
  for (int i = 0; err == cudaSuccess && (1 << i) <= teams; ++i)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &r.per_sm[i], kernel, (1 << i) * TS, (1 << i) * team_bytes);
  if (err != cudaSuccess) return err;
  if (r.per_sm[0] == 0) return cudaErrorInvalidConfiguration;
  r.ready = true;
  return cudaSuccess;
}

// `teams` matrices per block, one team of TS threads each.
template <typename T, int NP, int TS>
cudaError_t launch_teams(const T* a, T* w, T* v, int batch, int n, int sweeps,
                         int teams, cudaStream_t stream) {
  const size_t smem = teams * Team<NP, TS>::elems * sizeof(T);
  const int blocks = (batch + teams - 1) / teams;
  jacobi_eigh_kernel<T, NP, TS>
      <<<blocks, teams * TS, smem, stream>>>(a, w, v, batch, n, sweeps);
  return cudaGetLastError();
}

// One warp per matrix, with the number of warps per block that holds the
// batch in the fewest waves (ties to the fewest warps, which spreads a
// batch over more SMs).
template <typename T, int NP>
cudaError_t launch_warps(const T* a, T* w, T* v, int batch, int n, int sweeps,
                         int device, cudaStream_t stream) {
  const Residency* r = nullptr;
  const cudaError_t err = residency<T, NP, 32>(device, r);
  if (err != cudaSuccess) return err;
  int best = 1;
  long long best_waves = -1;
  for (int i = 0; i < 4 && r->per_sm[i] > 0; ++i) {
    const long long blocks = (batch + (1 << i) - 1) >> i;
    const long long slots = static_cast<long long>(r->sms) * r->per_sm[i];
    const long long waves = (blocks + slots - 1) / slots;
    if (best_waves < 0 || waves < best_waves) {
      best = 1 << i;
      best_waves = waves;
    }
  }
  return launch_teams<T, NP, 32>(a, w, v, batch, n, sweeps, best, stream);
}

// One team of TS threads per block.
template <typename T, int NP, int TS>
cudaError_t launch_blocks(const T* a, T* w, T* v, int batch, int n,
                          int sweeps, int device, cudaStream_t stream) {
  const Residency* r = nullptr;
  const cudaError_t err = residency<T, NP, TS>(device, r);
  if (err != cudaSuccess) return err;
  return launch_teams<T, NP, TS>(a, w, v, batch, n, sweeps, 1, stream);
}

// N <= 16: two warps per matrix. 16 < N <= 32: one warp per matrix.
// 32 < N <= 64: one 256-thread block per matrix.
template <typename T>
cudaError_t launch_on_current_device(const T* a, T* w, T* v, int batch, int n,
                                     int sweeps, int device,
                                     cudaStream_t stream) {
  if (n <= 16)
    return launch_blocks<T, 16, 64>(a, w, v, batch, n, sweeps, device, stream);
  if (n <= 32)
    return launch_warps<T, 32>(a, w, v, batch, n, sweeps, device, stream);
  if (n <= 64)
    return launch_blocks<T, 64, kMaxThreads>(a, w, v, batch, n, sweeps, device,
                                             stream);
  return cudaErrorInvalidValue;
}

// Launches on `device` and leaves the calling thread's current device as
// it found it.
template <typename T>
int launch(const T* a, T* w, T* v, int batch, int n, int sweeps, int device,
           void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch_on_current_device(a, w, v, batch, n, sweeps, device,
                                 static_cast<cudaStream_t>(stream));
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int mqc_jacobi_eigh_f32(const float* a, float* w, float* v, int batch, int n,
                        int sweeps, int device, void* stream) {
  return launch<float>(a, w, v, batch, n, sweeps, device, stream);
}

int mqc_jacobi_eigh_f64(const double* a, double* w, double* v, int batch,
                        int n, int sweeps, int device, void* stream) {
  return launch<double>(a, w, v, batch, n, sweeps, device, stream);
}

const char* mqc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
