// Fused backward Riccati recursion of a scenario batch, one launch.
//
// Replaces the TPU kernel ilqr_tpu/ops/pallas_riccati.py::_riccati_kernel
// (launched by _riccati_pallas_call, fed by riccati_scan_pallas_bl and,
// batch-first, by riccati_scan_pallas_batched).  It computes what that kernel
// computes; it is not a block-by-block copy.
//
// What it computes, per scenario lane b, with the carry (S [N,N], s [N])
// seeded from (QN, qxN), for t = T-1 ... 0:
//     g = ru + B's          G = Pux + B'SA          H = Ruu + B'SB
//     L L' = H + reg I      (unrolled Cholesky, one rsqrt per pivot)
//     duff = -(H+reg I)^-1 g            K = -(H+reg I)^-1 G
//     s <- qx + A's + K'H duff + K'g + G'duff
//     S <- Qxx + A'SA + K'HK + K'G + G'K      (raw H: the reference's
//                                              mixed regularization)
//     S <- (S + S')/2                         if SYMMETRIZE
// and writes duff, K, dv1 = sum_t duff.g [B], dv2 = 1/2 sum_t duff.H.duff [B].
//
// Two layouts, a template argument (the wrapper's layout argument):
// batch-LAST, element (t, i, j, b) of As at ((t*N + i)*N + j)*B + b, duffs
// [T,M,B], Ks [T,M,N,B]; and batch-FIRST, at ((b*T + t)*N + i)*N + j, duffs
// [B,T,M], Ks [B,T,M,N].  The arithmetic of a lane is the same code in both,
// so the two agree bit for bit.
//
// Bound on an H100 (3.35 TB/s): a lane and step reads
// N*N+N*M+N+M+N*N+M*N+M*M values (58 for N=4, M=2) and writes M+M*N (10), so
// at B=4096, T=100, float32 the launch moves about 111 MB: 33 us.  Its
// arithmetic (about 750 flops a lane and step, 0.3 GFLOP) needs under 5 us at
// the card's 67 TFLOP/s float32 rate, so bytes bound it.
//
// Design.
//  * One thread a lane; the carry, every intermediate and the dv1/dv2 sums
//    live in registers (N=4: 16+4 carry values).  The time loop runs inside
//    the kernel and takes the place of the TPU kernel's sequential grid
//    dimension.
//  * Prefetch.  The first version issued a step's 58 loads only when the
//    loop reached the step, so every one of the T steps paid a memory round
//    trip (2.3 us a step against 0.33 us at the byte bound).  Now each lane
//    copies its inputs RING - 1 = 5 steps ahead (cp.async, completed by
//    cp.async.wait_group) into a ring of RING steps in shared memory and
//    reads a step from there: a step costs its arithmetic, not a round trip.
//    Each thread reads only what it copied itself, so no barrier is needed.
//    Batch-last, a copy is one value and a warp's copies of it are 32
//    consecutive values; batch-first, a lane's step is a contiguous block of
//    each input and goes in 16-byte copies (8 bytes for ru in float32), into
//    a row of 60 (float32) or 62 (float64) values a lane, read back 16 bytes
//    at a time: the rows' 16-byte stride is odd, so a quarter warp's reads
//    fall on distinct banks.  Batch-last copies of 16-byte chunks of four
//    lanes, shared out over the warp's threads, measured twice as slow as a
//    value a copy and were dropped (PERF.md).
//  * One warp a block, as before: 4096 lanes make 128 warps, one an SM.  A
//    warp's time is T times the dependent chain of its step whatever the
//    number of warps beside it on the SM, so more, smaller blocks would not
//    shorten it, and spreading a lane over several threads would add
//    shuffles to a step of some 600 instructions.
//  * The ragged edge is `if (b >= B) return;`: no padding of the batch.
//  * Instantiated at (4, 2), the 2-link arm, and (5, 2), the 2-link arm with
//    the augmented Lagrangian's step-index coordinate (al.py).  A lane's
//    batch-first blocks at (5, 2) are not whole 16-byte chunks (25 values
//    of A), so there the ring takes one value a copy and a read (Row::VEC).
//    Any other (n, m) with n, m <= 5 is built at first use with
//    -DRICCATI_N/-DRICCATI_M/-DRICCATI_SCALAR behind the generic launcher
//    riccati_cuda_instance (ops/_build.py); larger shapes go to
//    riccati_wide.cu, since a lane's registers are nearly spent at (5, 2)
//    (127 of 128 in float32, 252 of 254 in float64: PERF.md).
//
// Built with -DRICCATI_STAGE_CLOCKS (a second library, never on the main
// path) every lane adds the clock64() cycles of each stage of a step into a
// buffer of [B, kStages] counters.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 32;
constexpr int RING = 6;       // steps in the ring of inputs
constexpr int kStages = 4;    // wait, load, gains, value
constexpr int kMaxSharedBytes = 232448;

enum { BATCH_LAST = 0, BATCH_FIRST = 1 };

// Where a lane's values of a step lie in its row of the ring: A, Qxx, B, Pux,
// qx, Ruu, ru.  VEC: every block but ru is whole 16-byte chunks and ru one
// chunk of 8 or 16 bytes, so that every block starts on 16 bytes (ru on 8 in
// float32), in global memory batch-first and in the row; then batch-first
// copies and reads move 16 bytes at a time, else one value at a time.
template <typename T> constexpr bool whole_chunks(int count) {
  return (count * (int)sizeof(T)) % 16 == 0;
}
template <typename T, int N, int M> struct Row {
  static constexpr int A = 0;
  static constexpr int Qxx = A + N * N;
  static constexpr int Bm = Qxx + N * N;
  static constexpr int Pux = Bm + N * M;
  static constexpr int qx = Pux + M * N;
  static constexpr int Ruu = qx + N;
  static constexpr int ru = Ruu + M * M;
  static constexpr int USED = ru + M;
  static constexpr bool VEC =
      whole_chunks<T>(N * N) && whole_chunks<T>(N * M) && whole_chunks<T>(N) &&
      whole_chunks<T>(M * M) && (whole_chunks<T>(M) || M * sizeof(T) == 8);
  // An odd number of 16-byte units (VEC) or of values, so that a quarter
  // warp's reads of a step fall on distinct banks: 15 units in float32, 31
  // in float64, or the least odd count that holds a larger step.
  static constexpr int PER = 16 / (int)sizeof(T);
  static constexpr int UNITS = (USED + PER - 1) / PER;
  static constexpr int ODD = UNITS | 1;
  static constexpr int LEN = VEC ? (USED <= (sizeof(T) == 4 ? 60 : 62)
                                        ? (sizeof(T) == 4 ? 60 : 62)
                                        : ODD * PER)
                                 : (USED | 1);
  static constexpr int SLOT = LEN * kThreads;
  static constexpr int BYTES = RING * SLOT * (int)sizeof(T);
  static_assert(USED <= LEN, "a step does not fit a row");
  static_assert(BYTES <= kMaxSharedBytes, "the ring does not fit a block");
};

// ---- device primitives ----------------------------------------------------
template <typename T> __device__ __forceinline__ T rsqrt_(T x);
template <> __device__ __forceinline__ float rsqrt_<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_<double>(double x) { return rsqrt(x); }

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
                 "n"(BYTES) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ long long clock_now() { return clock64(); }
// ---- end of device primitives ---------------------------------------------

// COUNT values of one lane's step into the ring: batch-last one value a
// copy (into element e of the step, the warp's lanes side by side; slot is
// the step's slot), batch-first in chunks of up to 16 bytes (slot is the
// lane's row), or one value a copy where the row is not VEC.
template <typename T, int COUNT, int LAYOUT, bool VEC>
__device__ __forceinline__ void copy_in(T* slot, int off, const T* src,
                                        long long B, int lane) {
  if constexpr (LAYOUT == BATCH_LAST) {
#pragma unroll
    for (int e = 0; e < COUNT; ++e)
      cp_async<sizeof(T)>(slot + (off + e) * kThreads + lane, src + (long long)e * B);
  } else if constexpr (!VEC) {
#pragma unroll
    for (int e = 0; e < COUNT; ++e) cp_async<sizeof(T)>(slot + off + e, src + e);
  } else {
    constexpr int BYTES = (COUNT * sizeof(T)) % 16 == 0 ? 16 : (int)(COUNT * sizeof(T)) % 16;
    constexpr int PER = BYTES / sizeof(T);
    static_assert(BYTES == 16 || COUNT * sizeof(T) < 16, "a block of 16-byte chunks");
#pragma unroll
    for (int e = 0; e < COUNT; e += PER)
      cp_async<BYTES>(slot + off + e, src + e);
  }
}

// COUNT values of one lane's step out of the ring into registers: batch-last
// one value a load (element e of the warp's lanes side by side), batch-first
// 16 bytes a load from the lane's row (8 for ru in float32), whose 16-byte
// stride is odd, so that a quarter warp's loads fall on distinct banks; one
// value a load where the row is not VEC.
template <typename T, int COUNT, int LAYOUT, bool VEC>
__device__ __forceinline__ void read_block(const T* slot, int off, int lane, int len,
                                           T* v) {
  if constexpr (LAYOUT == BATCH_LAST) {
#pragma unroll
    for (int e = 0; e < COUNT; ++e) v[e] = slot[(off + e) * kThreads + lane];
  } else if constexpr (!VEC) {
    const T* row = slot + lane * len + off;
#pragma unroll
    for (int e = 0; e < COUNT; ++e) v[e] = row[e];
  } else {
    const T* row = slot + lane * len + off;
    if constexpr (sizeof(T) == 4 && COUNT % 4 == 0) {
#pragma unroll
      for (int e = 0; e < COUNT; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + e);
        v[e] = x.x; v[e + 1] = x.y; v[e + 2] = x.z; v[e + 3] = x.w;
      }
    } else {
      using V2 = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
      static_assert(COUNT % 2 == 0, "pairs");
#pragma unroll
      for (int e = 0; e < COUNT; e += 2) {
        const V2 x = *reinterpret_cast<const V2*>(row + e);
        v[e] = x.x; v[e + 1] = x.y;
      }
    }
  }
}

// COUNT values of a register array to contiguous memory, 16 bytes a store
// where COUNT values make whole 16-byte chunks.
template <typename T, int COUNT>
__device__ __forceinline__ void store_block(T* dst, const T* v) {
  if constexpr ((COUNT * sizeof(T)) % 16 == 0) {
    using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int e = 0; e < COUNT; e += PER) {
      V x;
      T* xp = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int k = 0; k < PER; ++k) xp[k] = v[e + k];
      *reinterpret_cast<V*>(dst + e) = x;
    }
  } else {
#pragma unroll
    for (int e = 0; e < COUNT; ++e) dst[e] = v[e];
  }
}

// Solve (L L') x = b in place, L lower with reciprocal diagonal inv_d.
template <typename scalar_t, int M>
__device__ __forceinline__ void cho_solve(const scalar_t (&L)[M][M],
                                          const scalar_t (&inv_d)[M],
                                          scalar_t (&x)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    scalar_t acc = x[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc -= L[i][j] * x[j];
    x[i] = acc * inv_d[i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    scalar_t acc = x[i];
#pragma unroll
    for (int j = i + 1; j < M; ++j) acc -= L[j][i] * x[j];
    x[i] = acc * inv_d[i];
  }
}

template <typename scalar_t, int N, int M, int LAYOUT, bool SYMMETRIZE>
__global__ void __launch_bounds__(kThreads)
riccati_kernel(const scalar_t* __restrict__ As, const scalar_t* __restrict__ Bs,
               const scalar_t* __restrict__ qx, const scalar_t* __restrict__ ru,
               const scalar_t* __restrict__ Qxx, const scalar_t* __restrict__ Pux,
               const scalar_t* __restrict__ Ruu, const scalar_t* __restrict__ qxN,
               const scalar_t* __restrict__ QN, const scalar_t* __restrict__ reg,
               scalar_t* __restrict__ duffs, scalar_t* __restrict__ Ks,
               scalar_t* __restrict__ dv1, scalar_t* __restrict__ dv2,
               long long* __restrict__ clocks, int T, long long B) {
  using R = Row<scalar_t, N, M>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* ring = reinterpret_cast<scalar_t*>(smem_raw);

  const int lane = threadIdx.x;
  const long long b = (long long)blockIdx.x * kThreads + lane;
  if (b >= B) return;

  const scalar_t half = scalar_t(0.5);
  const scalar_t reg_b = reg[b];

  // Copy iteration it (step T-1-it) into its slot.
  auto issue = [&](int it) {
    const long long t = T - 1 - it;
    scalar_t* slot = ring + (it % RING) * R::SLOT;
    if (LAYOUT == BATCH_LAST) {
      copy_in<scalar_t, N * N, LAYOUT, R::VEC>(slot, R::A, As + t * N * N * B + b, B, lane);
      copy_in<scalar_t, N * N, LAYOUT, R::VEC>(slot, R::Qxx, Qxx + t * N * N * B + b, B, lane);
      copy_in<scalar_t, N * M, LAYOUT, R::VEC>(slot, R::Bm, Bs + t * N * M * B + b, B, lane);
      copy_in<scalar_t, M * N, LAYOUT, R::VEC>(slot, R::Pux, Pux + t * M * N * B + b, B, lane);
      copy_in<scalar_t, N, LAYOUT, R::VEC>(slot, R::qx, qx + t * N * B + b, B, lane);
      copy_in<scalar_t, M * M, LAYOUT, R::VEC>(slot, R::Ruu, Ruu + t * M * M * B + b, B, lane);
      copy_in<scalar_t, M, LAYOUT, R::VEC>(slot, R::ru, ru + t * M * B + b, B, lane);
    } else {
      const long long bt = b * T + t;
      scalar_t* row = slot + lane * R::LEN;
      copy_in<scalar_t, N * N, LAYOUT, R::VEC>(row, R::A, As + bt * N * N, B, lane);
      copy_in<scalar_t, N * N, LAYOUT, R::VEC>(row, R::Qxx, Qxx + bt * N * N, B, lane);
      copy_in<scalar_t, N * M, LAYOUT, R::VEC>(row, R::Bm, Bs + bt * N * M, B, lane);
      copy_in<scalar_t, M * N, LAYOUT, R::VEC>(row, R::Pux, Pux + bt * M * N, B, lane);
      copy_in<scalar_t, N, LAYOUT, R::VEC>(row, R::qx, qx + bt * N, B, lane);
      copy_in<scalar_t, M * M, LAYOUT, R::VEC>(row, R::Ruu, Ruu + bt * M * M, B, lane);
      copy_in<scalar_t, M, LAYOUT, R::VEC>(row, R::ru, ru + bt * M, B, lane);
    }
  };

  scalar_t S[N][N], s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = LAYOUT == BATCH_LAST ? qxN[i * B + b] : qxN[b * N + i];
#pragma unroll
    for (int j = 0; j < N; ++j)
      S[i][j] = LAYOUT == BATCH_LAST ? QN[(i * N + j) * B + b] : QN[(b * N + i) * N + j];
  }
  scalar_t dv1_acc = scalar_t(0), dv2_acc = scalar_t(0);
#ifdef RICCATI_STAGE_CLOCKS
  long long clk[kStages] = {0, 0, 0, 0};
  long long c_prev = clock_now();
  auto tick = [&](int stage) {
    const long long now = clock_now();
    clk[stage] += now - c_prev;
    c_prev = now;
  };
#else
  auto tick = [](int) {};
#endif

  for (int it = 0; it < RING - 1; ++it) {
    if (it < T) issue(it);
    cp_async_commit();
  }

  for (int it = 0; it < T; ++it) {
    const int t = T - 1 - it;
    // The slot of iteration it-1 is free: this thread has read it.
    if (it + RING - 1 < T) issue(it + RING - 1);
    cp_async_commit();
    cp_async_wait<RING - 1>();
    tick(0);

    // This step's local model, lane b.
    const scalar_t* slot = ring + (it % RING) * R::SLOT;
    scalar_t A[N][N], Bm[N][M], G[M][N], H[M][M], g[M], s_next[N], S_next[N][N];
    read_block<scalar_t, N * N, LAYOUT, R::VEC>(slot, R::A, lane, R::LEN, &A[0][0]);
    read_block<scalar_t, N * N, LAYOUT, R::VEC>(slot, R::Qxx, lane, R::LEN, &S_next[0][0]);
    read_block<scalar_t, N * M, LAYOUT, R::VEC>(slot, R::Bm, lane, R::LEN, &Bm[0][0]);
    read_block<scalar_t, M * N, LAYOUT, R::VEC>(slot, R::Pux, lane, R::LEN, &G[0][0]);
    read_block<scalar_t, N, LAYOUT, R::VEC>(slot, R::qx, lane, R::LEN, s_next);
    read_block<scalar_t, M * M, LAYOUT, R::VEC>(slot, R::Ruu, lane, R::LEN, &H[0][0]);
    read_block<scalar_t, M, LAYOUT, R::VEC>(slot, R::ru, lane, R::LEN, g);
    tick(1);
    // BtS = B'S;  g += B's;  G += BtS A;  H += BtS B.
    scalar_t BtS[M][N];
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = Bm[0][a] * S[0][j];
#pragma unroll
        for (int k = 1; k < N; ++k) acc += Bm[k][a] * S[k][j];
        BtS[a][j] = acc;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) g[a] += Bm[k][a] * s[k];
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int k = 0; k < N; ++k) G[a][j] += BtS[a][k] * A[k][j];
      }
#pragma unroll
      for (int c = 0; c < M; ++c) {
#pragma unroll
        for (int k = 0; k < N; ++k) H[a][c] += BtS[a][k] * Bm[k][c];
      }
    }

    // Cholesky-Crout of H + reg I; every 1/L_jj is one rsqrt, L_jj itself
    // is s * rsqrt(s), and the solves multiply.
    scalar_t L[M][M], inv_d[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      scalar_t piv = H[j][j] + reg_b;
#pragma unroll
      for (int k = 0; k < j; ++k) piv -= L[j][k] * L[j][k];
      const scalar_t r = rsqrt_<scalar_t>(piv);
      L[j][j] = piv * r;
      inv_d[j] = r;
#pragma unroll
      for (int i = j + 1; i < M; ++i) {
        scalar_t acc = H[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc -= L[i][k] * L[j][k];
        L[i][j] = acc * r;
      }
    }

    // duff = -(H + reg I)^-1 g,  K = -(H + reg I)^-1 G (column by column).
    scalar_t duff[M], K[M][N];
#pragma unroll
    for (int a = 0; a < M; ++a) duff[a] = g[a];
    cho_solve<scalar_t, M>(L, inv_d, duff);
#pragma unroll
    for (int a = 0; a < M; ++a) duff[a] = -duff[a];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      scalar_t col[M];
#pragma unroll
      for (int a = 0; a < M; ++a) col[a] = G[a][j];
      cho_solve<scalar_t, M>(L, inv_d, col);
#pragma unroll
      for (int a = 0; a < M; ++a) K[a][j] = -col[a];
    }

    // Outputs of this step, in the caller's layout.
    if (LAYOUT == BATCH_LAST) {
      scalar_t* duff_t = duffs + (long long)t * M * B + b;
      scalar_t* K_t = Ks + (long long)t * M * N * B + b;
#pragma unroll
      for (int a = 0; a < M; ++a) {
        duff_t[a * B] = duff[a];
#pragma unroll
        for (int j = 0; j < N; ++j) K_t[(a * N + j) * B] = K[a][j];
      }
    } else {
      const long long bt = b * T + t;
      store_block<scalar_t, M>(duffs + bt * M, duff);
      store_block<scalar_t, M * N>(Ks + bt * M * N, &K[0][0]);
    }
    tick(2);

    // Expected-decrease terms, with the raw H.
    scalar_t Hd[M];
    scalar_t dHd = scalar_t(0), dg = scalar_t(0);
#pragma unroll
    for (int a = 0; a < M; ++a) {
      scalar_t acc = H[a][0] * duff[0];
#pragma unroll
      for (int c = 1; c < M; ++c) acc += H[a][c] * duff[c];
      Hd[a] = acc;
      dHd += duff[a] * acc;
      dg += duff[a] * g[a];
    }
    dv1_acc += dg;
    dv2_acc += half * dHd;

    // s <- qx + A's + K'(H duff) + K'g + G'duff.
#pragma unroll
    for (int i = 0; i < N; ++i) {
      scalar_t acc = s_next[i];
#pragma unroll
      for (int k = 0; k < N; ++k) acc += A[k][i] * s[k];
#pragma unroll
      for (int a = 0; a < M; ++a)
        acc += K[a][i] * Hd[a] + K[a][i] * g[a] + G[a][i] * duff[a];
      s_next[i] = acc;
    }

    // S <- Qxx + A'(SA) + K'(HK) + K'G + (K'G)'.
    scalar_t SA[N][N], HK[M][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = S[i][0] * A[0][j];
#pragma unroll
        for (int k = 1; k < N; ++k) acc += S[i][k] * A[k][j];
        SA[i][j] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = H[a][0] * K[0][j];
#pragma unroll
        for (int c = 1; c < M; ++c) acc += H[a][c] * K[c][j];
        HK[a][j] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        scalar_t acc = S_next[i][j];
#pragma unroll
        for (int k = 0; k < N; ++k) acc += A[k][i] * SA[k][j];
#pragma unroll
        for (int a = 0; a < M; ++a)
          acc += K[a][i] * HK[a][j] + K[a][i] * G[a][j] + K[a][j] * G[a][i];
        S_next[i][j] = acc;
      }
    }

#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = s_next[i];
#pragma unroll
      for (int j = 0; j < N; ++j)
        S[i][j] = SYMMETRIZE ? half * (S_next[i][j] + S_next[j][i]) : S_next[i][j];
    }
    tick(3);
  }

  dv1[b] = dv1_acc;
  dv2[b] = dv2_acc;
#ifdef RICCATI_STAGE_CLOCKS
  if (clocks != nullptr) {
    for (int k = 0; k < kStages; ++k) clocks[b * kStages + k] = clk[k];
  }
#endif
}

template <typename scalar_t, int N, int M, int LAYOUT, bool SYM>
int launch_one(const void* const* in, const void* qxN, const void* QN,
               const void* reg, void* duffs, void* Ks, void* dv1, void* dv2,
               int T, long long B, void* clocks, cudaStream_t st) {
  using R = Row<scalar_t, N, M>;
  auto kernel = riccati_kernel<scalar_t, N, M, LAYOUT, SYM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
  kernel<<<grid, dim3(kThreads), R::BYTES, st>>>(
      static_cast<const scalar_t*>(in[0]), static_cast<const scalar_t*>(in[1]),
      static_cast<const scalar_t*>(in[2]), static_cast<const scalar_t*>(in[3]),
      static_cast<const scalar_t*>(in[4]), static_cast<const scalar_t*>(in[5]),
      static_cast<const scalar_t*>(in[6]), static_cast<const scalar_t*>(qxN),
      static_cast<const scalar_t*>(QN), static_cast<const scalar_t*>(reg),
      static_cast<scalar_t*>(duffs), static_cast<scalar_t*>(Ks),
      static_cast<scalar_t*>(dv1), static_cast<scalar_t*>(dv2),
      static_cast<long long*>(clocks), T, B);
  return (int)cudaGetLastError();
}

template <typename scalar_t, int N, int M>
int launch(const void* const* in, const void* qxN, const void* QN,
           const void* reg, void* duffs, void* Ks, void* dv1, void* dv2, int T,
           long long B, int symmetrize, int layout, int* path, void* clocks,
           void* stream) {
#ifndef RICCATI_STAGE_CLOCKS
  if (clocks != nullptr) return (int)cudaErrorInvalidValue;
#endif
  if (B <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (path != nullptr)
    *path = layout == BATCH_FIRST && Row<scalar_t, N, M>::VEC ? 2 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RICCATI_LAUNCH(LAYOUT)                                                   \
  (symmetrize ? launch_one<scalar_t, N, M, LAYOUT, true>(                        \
                    in, qxN, QN, reg, duffs, Ks, dv1, dv2, T, B, clocks, st)     \
              : launch_one<scalar_t, N, M, LAYOUT, false>(                       \
                    in, qxN, QN, reg, duffs, Ks, dv1, dv2, T, B, clocks, st))
  if (layout == BATCH_LAST) return RICCATI_LAUNCH(BATCH_LAST);
  if (layout != BATCH_FIRST) return (int)cudaErrorInvalidValue;
  // 16-byte copies of each lane's blocks (VEC rows), 16-byte stores of its
  // gains where they are whole chunks.
  for (int k = 0; k < 7; ++k)
    if (Row<scalar_t, N, M>::VEC && reinterpret_cast<uintptr_t>(in[k]) % 16)
      return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(duffs) % 16 || reinterpret_cast<uintptr_t>(Ks) % 16)
    return (int)cudaErrorMisalignedAddress;
  return RICCATI_LAUNCH(BATCH_FIRST);
#undef RICCATI_LAUNCH
}

}  // namespace

// Plain C interface, one function per instantiation, the same as
// riccati_wide.cu's: the seven step inputs (A, B, qx, ru, Qxx, Pux, Ruu) as
// an array of device pointers, then qxN, QN, reg, the four outputs, T, B,
// symmetrize (0/1), layout (0 batch-last, 1 batch-first), where to write the
// copy path taken (0: a value a copy; 2: 16-byte copies, batch-first; may
// be null), a [B, 4] int64 buffer of stage clocks (null
// unless built with -DRICCATI_STAGE_CLOCKS) and the CUDA stream; returns a
// cudaError_t.
#define RICCATI_EXPORT(NAME, SCALAR, N, M)                                       \
  extern "C" int NAME(const void* const* in, const void* qxN, const void* QN,    \
                      const void* reg, void* duffs, void* Ks, void* dv1,         \
                      void* dv2, int T, long long B, int symmetrize, int layout, \
                      int* path, void* clocks, void* stream) {                   \
    return launch<SCALAR, N, M>(in, qxN, QN, reg, duffs, Ks, dv1, dv2, T, B,     \
                                symmetrize, layout, path, clocks, stream);       \
  }

#if defined(RICCATI_N) && defined(RICCATI_M) && defined(RICCATI_SCALAR)
// One instantiation built at first use (ops/_build.py).
RICCATI_EXPORT(riccati_cuda_instance, RICCATI_SCALAR, RICCATI_N, RICCATI_M)
#else
RICCATI_EXPORT(riccati_cuda_4x2_f32, float, 4, 2)
RICCATI_EXPORT(riccati_cuda_4x2_f64, double, 4, 2)
RICCATI_EXPORT(riccati_cuda_5x2_f32, float, 5, 2)
RICCATI_EXPORT(riccati_cuda_5x2_f64, double, 5, 2)
#endif
