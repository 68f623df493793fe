// Fused backward Riccati recursion for the shapes past the wide plan: any
// (n, m) with n <= 32 and m <= 16 that riccati.cu (n, m <= 5) and
// riccati_wide.cu (padded to at most (24, 12)) do not serve, built at first
// use with -DRICCATI_N/-DRICCATI_M/-DRICCATI_SCALAR (ops/_build.py).  The
// shape that needs it in the repo is al_solve of the 6-DoF arm: the
// augmented Lagrangian carries the step index as a state coordinate, so the
// arm's (24, 12) runs at (25, 12).  One launch for a whole scenario batch and
// horizon; one lane a block of NT = 256 threads.
//
// Replaces the same TPU kernel as riccati.cu and riccati_wide.cu:
// ilqr_tpu/ops/pallas_riccati.py::_riccati_kernel (launched by
// _riccati_pallas_call, fed by riccati_scan_pallas_bl and, batch-first, by
// riccati_scan_pallas_batched).  It computes what that kernel computes; the
// algebra is spelled out at the top of riccati.cu (g, G, H, Cholesky of
// H + reg I with one rsqrt per pivot, duff, K, the value update with the raw
// H, the optional symmetrize, dv1, dv2), with the subtractions of the
// Cholesky and of the substitutions in the reference's order.  Two layouts,
// a template argument: batch-LAST (element e of lane b at step t at
// (t*E + e)*B + b) and batch-FIRST (at (b*T + t)*E + e), both read in place;
// a lane's arithmetic is the same code in both, so the two agree bit for
// bit.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores,
// 67 TFLOP/s float64 on the FP64 tensor cores).  A lane and step reads
// 2n^2 + 2nm + m^2 + n + m values (2,031 at (25, 12), 3,376 at (32, 16)) and
// writes m + mn (312, 528); at B = 256, T = 100, float32 that is 0.24 GB,
// 0.072 ms, at (25, 12) and 0.40 GB, 0.120 ms, at (32, 16), twice that in
// float64.  Its arithmetic, about 74 k and 160 k multiply-adds a lane and
// step (chip_smoke.riccati_bound_ms counts them), is 0.057 and 0.122 ms in
// either type: bytes bound everywhere but (32, 16) float32, which is bound
// by operations by a little.  The dependent chain of a step (below) holds
// the kernel above that bound, as it does the other two designs.
//
// Why another plan.  riccati_wide.cu cannot reach N = 32, for two reasons of
// its plan: two lanes share a block, so that its lanes' regions and a ring of
// three steps of TMA boxes come to 241,544 bytes at the padded (32, 12) in
// float32, past the 232,448 a Hopper block may use; and one warp solves the
// N + 1 columns of [G | g].  The simplest plan that reaches (32, 16) in both
// types keeps a whole block for one lane:
//  * The lane's matrices live in shared memory at the LOGICAL shape, dense
//    and row-major: the step's inputs twice (this step's and the next
//    one's), the carry S, S A, P = Qxx + A'(S A), B'S, [G | g], [K | duff],
//    [W | H duff], H, its Cholesky factor L and the reciprocal pivots, s and
//    qx + A's.  At (32, 16) in float64 that is 100,096 bytes (Plan::BYTES),
//    so a block fits in either type with room to spare.
//  * Nothing is padded.  Every product is one output entry a thread (the
//    block's threads loop over the entries), so no tile asks for a dimension
//    that is a multiple of 4 or 8: every entry read, computed and written is
//    a logical one.  The padding rules of riccati_wide.cu (zeros in the pad,
//    1 on the padded pivots, only logical duff and K written) hold because
//    there is no pad.
//  * The inputs of the next step come in while this step computes: every
//    thread issues cp.async copies of a few of its values (one value a copy,
//    from either layout; batch-first a lane's step is contiguous, so a warp's
//    copies are too) into the other half of the double buffer and waits for
//    them at the end of the step.  No TMA: a batch-last box is 16 bytes of
//    lanes, of which a block of one lane would use one value.
//  * Six barriers a step (__syncthreads over the lane's block):
//      1. SA = S A, B'S, g = ru + B's, ys = qx + A's              [barrier]
//      2. G = Pux + B'S A, H = Ruu + B'S B, P = Qxx + A'(SA)       [barrier]
//      3. warp 0: Cholesky-Crout of H + reg I into L: lane i computes row
//         i of column j; every lane computes the pivot itself, so a column
//         costs one __syncwarp                                   [barrier]
//      4. threads 0..N: column c of [G | g] by the reference's forward and
//         back substitutions into [K | duff], written out: the N + 1
//         columns spread over two warps                          [barrier]
//      5. [W | H duff] = [G | 0] + H [K | duff]                   [barrier]
//      6. S = P + K'W + G'K, written symmetrized from the pair (i, j),
//         (j, i); s = ys + K'(H duff + g) + G'duff; dv1, dv2 by thread 0;
//         the next step's copies waited for                      [barrier]
//  * float64 products by FMA outside the tensor cores (riccati_wide.cu puts
//    its N x N x N products on the FP64 tensor core); float32 by FFMA: no
//    TF32 anywhere (reduced-precision products NaN the recursion at
//    T >= 300, ilqr_tpu/precision.py).
// A simple plan: right first, fast later (PERF.md has its times).
//
// The limits: n <= 32 and m <= 16 (static_asserts below; cuda_riccati.route
// refuses a larger shape before any nvcc run), N + 1 <= NT for the column
// solves and Plan::BYTES <= 232,448.  The plan's bytes would allow larger
// shapes (about (48, 24) in float64), which no model of the repo has and no
// check holds on the card.
//
// Built with -DRICCATI_STAGE_CLOCKS (a second library, never on the main
// path) thread 0 adds the clock64() cycles of each stage of a step into a
// buffer of [B, kStages] counters.

#include <cuda_runtime.h>

#include <cstdint>

namespace riccati_large {

constexpr int NT = 256;               // threads a block, one lane a block
constexpr int NIN = 7;                // A, B, qx, ru, Qxx, Pux, Ruu
constexpr int kMaxSharedBytes = 232448;
constexpr int kStages = 6;            // see STAGES in cuda_riccati.py
constexpr int kMaxN = 32, kMaxM = 16;

enum { BATCH_LAST = 0, BATCH_FIRST = 1 };

template <typename T> struct Args {
  const T* in[NIN];
  const T* qxN;
  const T* QN;
  const T* reg;
  T* duffs;
  T* Ks;
  T* dv1;
  T* dv2;
  long long* clocks;
};

// ---- device primitives ----------------------------------------------------
template <typename T> __device__ __forceinline__ T rsqrt_(T x);
template <> __device__ __forceinline__ float rsqrt_<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_<double>(double x) { return rsqrt(x); }

// One value, asynchronously.
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"(sizeof(T)) : "memory");
}

// This thread's copies have landed.
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void block_sync() { __syncthreads(); }
__device__ __forceinline__ void warp_sync() { __syncwarp(); }
__device__ __forceinline__ long long clock_now() { return clock64(); }
// ---- end of device primitives ---------------------------------------------

// Element offsets of the block's shared memory, in units of T, at the
// logical (N, M).
template <typename T, int N, int M> struct Plan {
  // Input k is a d1(k) x d2(k) matrix a step (vectors are 1 x len).
  __host__ __device__ static constexpr int d1(int k) {
    return k == 0 || k == 1 || k == 4 ? N : k == 5 || k == 6 ? M : 1;
  }
  __host__ __device__ static constexpr int d2(int k) {
    return k == 1 || k == 3 || k == 6 ? M : N;
  }
  __host__ __device__ static constexpr int E(int k) { return d1(k) * d2(k); }
  // A step's inputs, densely: A, B, qx, ru, Qxx, Pux, Ruu.
  __host__ __device__ static constexpr int dense(int k) {
    return k == 0 ? 0 : dense(k - 1) + E(k - 1);
  }
  static constexpr int IN = dense(NIN);
  // Columns of [G | g], [K | duff] and [W | H duff]: N, then the vector.
  static constexpr int NA = N + 1;
  static constexpr int S = 2 * IN;        // after the double buffer
  static constexpr int SA = S + N * N;
  static constexpr int P = SA + N * N;
  static constexpr int BtS = P + N * N;   // [M][N]
  static constexpr int GA = BtS + M * N;
  static constexpr int KA = GA + M * NA;
  static constexpr int WA = KA + M * NA;
  static constexpr int H = WA + M * NA;
  static constexpr int L = H + M * M;
  static constexpr int invd = L + M * M;
  static constexpr int s = invd + M;
  static constexpr int ys = s + N;
  static constexpr int ELEMS = ys + N;
  static constexpr int BYTES = ELEMS * (int)sizeof(T);
  static_assert(0 < N && N <= kMaxN && 0 < M && M <= kMaxM,
                "the plan serves n <= 32 and m <= 16");
  static_assert(N + 1 <= NT, "a thread a column of [G | g]");
  static_assert(BYTES <= kMaxSharedBytes, "the lane does not fit a block");
};

template <typename T, int N, int M, int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
riccati_large_kernel(const Args<T> args, int T_steps, long long B, int symmetrize) {
  using P = Plan<T, N, M>;
  constexpr int NA = P::NA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, wl = tid % 32;
  const long long b = blockIdx.x;

  // Copy step t's inputs into half `h` of the double buffer.
  auto issue = [&](int t, int h) {
    T* dst = smem + h * P::IN;
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      const int E = P::E(k);
      const T* src = args.in[k];
      for (int e = tid; e < E; e += NT) {
        const long long at = LAYOUT == BATCH_LAST ? ((long long)t * E + e) * B + b
                                                  : ((long long)b * T_steps + t) * E + e;
        copy_elem(dst + P::dense(k) + e, src + at);
      }
    }
  };

  // The carry, seeded from the terminal cost.
  for (int i = tid; i < N * N; i += NT)
    smem[P::S + i] = LAYOUT == BATCH_LAST ? args.QN[(long long)i * B + b]
                                        : args.QN[b * N * N + i];
  for (int i = tid; i < N; i += NT)
    smem[P::s + i] = LAYOUT == BATCH_LAST ? args.qxN[(long long)i * B + b]
                                        : args.qxN[b * N + i];
  const T reg_b = args.reg[b];
  const T half = T(0.5);
  T dv1_acc = T(0), dv2_acc = T(0);   // kept by thread 0
#ifdef RICCATI_STAGE_CLOCKS
  long long clk[kStages] = {};
  long long c_prev = 0;
  auto tick = [&](int stage) {
    const long long now = clock_now();
    clk[stage] += now - c_prev;
    c_prev = now;
  };
#else
  auto tick = [](int) {};
#endif

  if (T_steps > 0) issue(T_steps - 1, 0);
  copies_wait();
  block_sync();

  for (int it = 0; it < T_steps; ++it) {
    const int t = T_steps - 1 - it;
    const T* in = smem + (it & 1) * P::IN;
    const T* A = in + P::dense(0);
    const T* Bm = in + P::dense(1);
    const T* qx = in + P::dense(2);
    const T* ru = in + P::dense(3);
    const T* Qxx = in + P::dense(4);
    const T* Pux = in + P::dense(5);
    const T* Ruu = in + P::dense(6);
    const T* S = smem + P::S;
    const T* s = smem + P::s;
    T* SA = smem + P::SA;
    T* Pm = smem + P::P;
    T* BtS = smem + P::BtS;
    T* GA = smem + P::GA;
    T* KA = smem + P::KA;
    T* WA = smem + P::WA;
    T* H = smem + P::H;
    T* L = smem + P::L;
    T* invd = smem + P::invd;
    T* ys = smem + P::ys;
#ifdef RICCATI_STAGE_CLOCKS
    c_prev = clock_now();
#endif
    // The other half was last read in the step before, which ended on a
    // barrier: the next step's inputs go there now.
    if (it + 1 < T_steps) issue(t - 1, (it + 1) & 1);

    // 1. SA = S A;  B'S;  g = ru + B's (column N of [G | g]);  ys = qx + A's.
    for (int job = tid; job < N * N + M * N + M + N; job += NT) {
      if (job < N * N) {
        const int i = job / N, j = job % N;
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += S[i * N + k] * A[k * N + j];
        SA[i * N + j] = acc;
      } else if (job < N * N + M * N) {
        const int a = (job - N * N) / N, j = (job - N * N) % N;
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc += Bm[k * M + a] * S[k * N + j];
        BtS[a * N + j] = acc;
      } else if (job < N * N + M * N + M) {
        const int a = job - N * N - M * N;
        T acc = ru[a];
#pragma unroll
        for (int k = 0; k < N; ++k) acc += Bm[k * M + a] * s[k];
        GA[a * NA + N] = acc;
      } else {
        const int i = job - N * N - M * N - M;
        T acc = qx[i];
#pragma unroll
        for (int k = 0; k < N; ++k) acc += A[k * N + i] * s[k];
        ys[i] = acc;
      }
    }
    block_sync();
    tick(0);

    // 2. G = Pux + B'S A;  H = Ruu + B'S B;  P = Qxx + A'(SA).
    for (int job = tid; job < M * N + M * M + N * N; job += NT) {
      if (job < M * N) {
        const int a = job / N, j = job % N;
        T acc = Pux[a * N + j];
#pragma unroll
        for (int k = 0; k < N; ++k) acc += BtS[a * N + k] * A[k * N + j];
        GA[a * NA + j] = acc;
      } else if (job < M * N + M * M) {
        const int a = (job - M * N) / M, c = (job - M * N) % M;
        T acc = Ruu[a * M + c];
#pragma unroll
        for (int k = 0; k < N; ++k) acc += BtS[a * N + k] * Bm[k * M + c];
        H[a * M + c] = acc;
      } else {
        const int i = (job - M * N - M * M) / N, j = (job - M * N - M * M) % N;
        T acc = Qxx[i * N + j];
#pragma unroll
        for (int k = 0; k < N; ++k) acc += A[k * N + i] * SA[k * N + j];
        Pm[i * N + j] = acc;
      }
    }
    block_sync();
    tick(1);

    // 3. Warp 0: Cholesky-Crout of H + reg I, one rsqrt a pivot, L_jj =
    //    piv * rsqrt(piv), the subtractions in the reference's order.
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        T piv = H[j * M + j] + reg_b;
#pragma unroll
        for (int k = 0; k < j; ++k) piv -= L[j * M + k] * L[j * M + k];
        const T r = rsqrt_<T>(piv);
        if (wl > j && wl < M) {
          T acc = H[wl * M + j];
#pragma unroll
          for (int k = 0; k < j; ++k) acc -= L[wl * M + k] * L[j * M + k];
          L[wl * M + j] = acc * r;
        } else if (wl == j) {
          L[j * M + j] = piv * r;
          invd[j] = r;
        }
        warp_sync();
      }
    }
    block_sync();
    tick(2);

    // 4. [K | duff] = -(H + reg I)^-1 [G | g], column c by thread c: x =
    //    L^-1 b, then x = L^-T x, multiplying by the reciprocal pivots.
    if (tid <= N) {
      const int c = tid;
      T x[M];
#pragma unroll
      for (int i = 0; i < M; ++i) x[i] = GA[i * NA + c];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        T acc = x[i];
#pragma unroll
        for (int j = 0; j < i; ++j) acc -= L[i * M + j] * x[j];
        x[i] = acc * invd[i];
      }
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
        T acc = x[i];
#pragma unroll
        for (int j = i + 1; j < M; ++j) acc -= L[j * M + i] * x[j];
        x[i] = acc * invd[i];
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const T v = -x[i];
        KA[i * NA + c] = v;
        if (c < N) {
          if (LAYOUT == BATCH_LAST)
            args.Ks[(((long long)t * M + i) * N + c) * B + b] = v;
          else
            args.Ks[(((long long)b * T_steps + t) * M + i) * N + c] = v;
        } else if (LAYOUT == BATCH_LAST) {
          args.duffs[((long long)t * M + i) * B + b] = v;
        } else {
          args.duffs[((long long)b * T_steps + t) * M + i] = v;
        }
      }
    }
    block_sync();
    tick(3);

    // 5. [W | Hd] = [G | 0] + H [K | duff]: K'HK + K'G = K'W and Hd =
    //    H duff, with the raw H.
    for (int job = tid; job < M * NA; job += NT) {
      const int i = job / NA, c = job % NA;
      T acc = c < N ? GA[i * NA + c] : T(0);
#pragma unroll
      for (int k = 0; k < M; ++k) acc += H[i * M + k] * KA[k * NA + c];
      WA[i * NA + c] = acc;
    }
    block_sync();
    tick(4);

    // 6. Sn = P + K'W + G'K from the pair (i, j), (j, i), i <= j, written
    //    symmetrized;  s = ys + K'(H duff + g) + G'duff;  dv1, dv2.
    for (int job = tid; job < N * N; job += NT) {
      const int i = job / N, j = job % N;
      if (i > j) continue;
      T sn = Pm[i * N + j], sm = Pm[j * N + i];
#pragma unroll
      for (int a = 0; a < M; ++a) {
        sn += KA[a * NA + i] * WA[a * NA + j];
        sm += KA[a * NA + j] * WA[a * NA + i];
      }
#pragma unroll
      for (int a = 0; a < M; ++a) {
        sn += GA[a * NA + i] * KA[a * NA + j];
        sm += GA[a * NA + j] * KA[a * NA + i];
      }
      const T vij = symmetrize ? half * (sn + sm) : sn;
      const T vji = symmetrize ? vij : sm;
      smem[P::S + i * N + j] = vij;
      smem[P::S + j * N + i] = vji;
    }
    for (int i = tid; i < N; i += NT) {
      T acc = ys[i];
#pragma unroll
      for (int a = 0; a < M; ++a)
        acc += KA[a * NA + i] * (WA[a * NA + N] + GA[a * NA + N]) +
               GA[a * NA + i] * KA[a * NA + N];
      smem[P::s + i] = acc;
    }
    if (tid == 0) {
      T dg = T(0), dHd = T(0);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const T d = KA[i * NA + N];
        dg += d * GA[i * NA + N];
        dHd += d * WA[i * NA + N];
      }
      dv1_acc += dg;
      dv2_acc += half * dHd;
    }
    copies_wait();
    block_sync();
    tick(5);
  }

  if (tid == 0) {
    args.dv1[b] = dv1_acc;
    args.dv2[b] = dv2_acc;
  }
#ifdef RICCATI_STAGE_CLOCKS
  if (tid == 0 && args.clocks != nullptr) {
    for (int k = 0; k < kStages; ++k) args.clocks[b * kStages + k] = clk[k];
  }
#endif
}

}  // namespace riccati_large

namespace {

using namespace riccati_large;

template <typename T, int N, int M>
int launch(const void* const* in, const void* qxN, const void* QN, const void* reg,
           void* duffs, void* Ks, void* dv1, void* dv2, int T_steps, long long B,
           int symmetrize, int layout, int* path, void* clocks, void* stream) {
  using P = Plan<T, N, M>;
#ifndef RICCATI_STAGE_CLOCKS
  if (clocks != nullptr) return (int)cudaErrorInvalidValue;
#endif
  // One block a lane: the grid's x dimension holds 2^31 - 1 blocks.
  if (B <= 0 || B > 0x7fffffffLL || T_steps < 0 ||
      (layout != BATCH_LAST && layout != BATCH_FIRST))
    return (int)cudaErrorInvalidValue;
  if (path != nullptr) *path = 0;   // a value a copy
  Args<T> args;
  for (int k = 0; k < NIN; ++k) args.in[k] = static_cast<const T*>(in[k]);
  args.qxN = static_cast<const T*>(qxN);
  args.QN = static_cast<const T*>(QN);
  args.reg = static_cast<const T*>(reg);
  args.duffs = static_cast<T*>(duffs);
  args.Ks = static_cast<T*>(Ks);
  args.dv1 = static_cast<T*>(dv1);
  args.dv2 = static_cast<T*>(dv2);
  args.clocks = static_cast<long long*>(clocks);
  auto kernel = layout == BATCH_LAST ? riccati_large_kernel<T, N, M, BATCH_LAST>
                                     : riccati_large_kernel<T, N, M, BATCH_FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)B), dim3(NT), P::BYTES, static_cast<cudaStream_t>(stream)>>>(
      args, T_steps, B, symmetrize);
  return (int)cudaGetLastError();
}

}  // namespace

#if defined(RICCATI_N) && defined(RICCATI_M) && defined(RICCATI_SCALAR)
// The one instantiation of a build (ops/_build.py), behind the generic
// launcher with the C interface of riccati.cu and riccati_wide.cu: the seven
// step inputs as an array of device pointers, then qxN, QN, reg, the four
// outputs, T, B, symmetrize (0/1), layout (0 batch-last, 1 batch-first),
// where to write the copy path taken (always 0: a value a copy; may be
// null), a [B, kStages] int64 buffer of stage clocks (null unless built with
// -DRICCATI_STAGE_CLOCKS) and the CUDA stream; returns a cudaError_t.
extern "C" int riccati_cuda_instance(const void* const* in, const void* qxN,
                                     const void* QN, const void* reg, void* duffs,
                                     void* Ks, void* dv1, void* dv2, int T,
                                     long long B, int symmetrize, int layout,
                                     int* path, void* clocks, void* stream) {
  return launch<RICCATI_SCALAR, RICCATI_N, RICCATI_M>(
      in, qxN, QN, reg, duffs, Ks, dv1, dv2, T, B, symmetrize, layout, path,
      clocks, stream);
}
// The shared memory a block of the instantiation takes (its Plan::BYTES).
extern "C" int riccati_cuda_instance_shared_bytes() {
  return riccati_large::Plan<RICCATI_SCALAR, RICCATI_N, RICCATI_M>::BYTES;
}
#else
#error "riccati_large.cu has no fixed instantiation: build it with \
-DRICCATI_N, -DRICCATI_M and -DRICCATI_SCALAR (ops/_build.py)"
#endif
