// Fused backward Riccati recursion for the shapes past riccati_large.cu: any
// (n, m) with n <= 64 and m <= 32 that riccati.cu (n, m <= 5),
// riccati_wide.cu (padded to at most (24, 12)) and riccati_large.cu
// (n <= 32, m <= 16) do not serve, built at first use with
// -DRICCATI_N/-DRICCATI_M/-DRICCATI_SCALAR (ops/_build.py).  The floating-base
// arms with more than ten joints need it (state 2 nv, control nv, nv = 6 +
// joints): the free-flying dual 6-DoF arm (models/rbd/assets/
// dual_6Dof_arm.urdf) at (36, 18), and at (37, 18) under al_solve, whose
// state carries the step index; a humanoid reaches (64, 32).  One launch for
// a whole scenario batch and horizon; one lane a block of NT = 256 threads.
//
// Replaces the same TPU kernel as the other three sources:
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
// bit.  float32 and float64; no TF32 anywhere (reduced-precision products
// NaN the recursion at T >= 300, ilqr_tpu/precision.py).
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores,
// 67 TFLOP/s float64 on the FP64 tensor cores).  A lane and step reads
// 2n^2 + 2nm + m^2 + n + m values (4,266 at (36, 18), 13,408 at (64, 32)) and
// writes m + mn (666, 2,080); its arithmetic is about 227 k and 1.27 M
// multiply-adds (chip_smoke.riccati_bound_ms counts them).  At B = 256,
// T = 100 that is 0.151 ms of bytes against 0.174 ms of operations at
// (36, 18) float32 (0.302 against 0.174 in float64), and 0.473 against
// 0.967 ms at (64, 32) float32 (0.947 against 0.967 in float64): bound by
// operations but at (36, 18) float64.  The dependent chain of a step (three
// products, the factorization, two substitutions of up to 32 rows, the
// value update) holds the kernel above that bound, as it does the others.
//
// Why this plan.  riccati_large.cu keeps a lane's whole step in a block's
// shared memory: every input padded, in a staging ring, beside the
// intermediates.  At (64, 32) float64 the intermediates alone (S, S A, S'B,
// G, K, W, H, L, padded) take 159,232 bytes; the padded inputs another
// 115,456, past the 232,448 a block may use.  So:
//  * Shared memory holds the carry (S, s), the intermediates and, of the
//    inputs, only A and B, which three products read again and again
//    (212,480 bytes at (64, 32) float64, 123,648 in float32).  Qxx, Pux,
//    Ruu, qx and ru are each read once a step, as the first term of a sum,
//    from device memory where they lie (a lane's step of an input is one
//    contiguous run batch-first, a value in a row of B lanes batch-last).
//  * Padded tiles, as riccati_large.cu: NP = N rounded up to 8 in float64
//    (8 x 8 tensor-core tiles) and to 4 in float32, MP = M rounded up to 4,
//    rows of NP + 4 (NP + 8 where that is a multiple of 32) and MP + 4
//    values.  The pad holds zeros (zeroed once, only logical entries
//    written, the inputs read as zeros past their logical shape), so every
//    logical entry gets the sums of the unpadded recursion plus exact zeros.
//  * Products register-tiled as in riccati_large.cu: S'B, S A (float32: its
//    left factor is S itself once symmetrized, else a transposed copy), G =
//    Pux + BtS A, H = Ruu + BtS B, P = Qxx + A'(SA) into the buffer of S.
//    float64 S A and A'(SA) on the FP64 tensor core (mma.sync m8n8k4, exact
//    IEEE products); the rest by FFMA.
//  * The gains on four solver warps: warp 0 factors H + reg I, lane i
//    holding row i in registers (m <= 32: right-looking, one rsqrt a pivot,
//    the pivot and column j of L broadcast by __shfl_sync, the subtractions
//    in the reference's order), writes L and the reciprocal pivots; after a
//    barrier of the four warps, each of their lanes solves one of the
//    N + 1 <= 65 columns of [G | g] (at most 17 a warp) by the reference's
//    substitutions, reading L as broadcasts, a __syncwarp after every row in
//    float64 and every two in float32 (without it ptxas hoists the loads of
//    L ahead of the chain and spills, riccati_large.cu's lesson); after a
//    second barrier, [W | H duff] = [G | 0] + H [K | duff].
//  * Warps 4-7 meanwhile form P, then load the next step's A and B into
//    their padded buffers (the last readers of A are theirs).
//  * Four block barriers a step:
//      1. BtSt = S'B, SA = S A, g = ru + B's, ys = qx + A's     [barrier]
//      2. G = Pux + BtS A, H = Ruu + BtS B                      [barrier]
//      3. warps 0-3: Cholesky, solves (K, duff written out), W;
//         warps 4-7: P = Qxx + A'(SA), then the next A and B      [barrier]
//      4. S = P + K'W + G'K by mirrored pairs, symmetrized;
//         s = ys + K'(H duff + g) + G'duff; dv1, dv2              [barrier]
//  * __launch_bounds__(NT, 1): up to 255 registers a thread (a solver holds
//    a column of 32 values, the factoring warp a row of 32).  At the largest
//    shapes one block fits an SM, so B = 256 lanes take two waves of 132
//    SMs.  A simple plan that is right; speed is later work.
//
// The limits: n <= 64, m <= 32 and the block's shared memory (static_asserts
// below; cuda_riccati.route refuses a larger shape before any nvcc run).
// Past them a lane outgrows one block: a cluster of two blocks splitting the
// rows of S and reading each other's through distributed shared memory.
//
// Built with -DRICCATI_STAGE_CLOCKS (a second library, never on the main
// path) thread 0 (the factoring warp) adds the clock64() cycles of each
// stage of a step into a buffer of [B, kStages] counters.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace riccati_xl {

constexpr int NT = 256;                    // threads a block, one lane a block
constexpr int SOLVERS = 4;                 // warps that factor and solve
constexpr int SOLVER_THREADS = 32 * SOLVERS;
constexpr int PACKERS = NT - SOLVER_THREADS;   // P, the next A and B
constexpr int NIN = 7;                     // A, B, qx, ru, Qxx, Pux, Ruu
constexpr int kMaxSharedBytes = 232448;    // what a Hopper block may use
constexpr int kStages = 7;                 // see STAGES in cuda_riccati.py
constexpr int kMaxN = 64, kMaxM = 32;
// Named barriers (0 is __syncthreads).
constexpr int BAR_SOLVERS = 1, BAR_PACKERS = 2;

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

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

__device__ __forceinline__ void block_sync() { __syncthreads(); }
__device__ __forceinline__ void warp_sync() { __syncwarp(); }

// The `count` threads of named barrier `id` meet.
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Lane `src`'s v, to every lane of the warp.
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) { return __shfl_sync(0xffffffffu, v, src); }

// D (8x8) += A (8x4) B (4x8) on the FP64 tensor core; a thread holds
// a(g, q), b(q, g) and d(g, 2q), d(g, 2q+1), g = lane/4, q = lane%4.
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d0), "+d"(d1) : "d"(a), "d"(b));
}

__device__ __forceinline__ long long clock_now() { return clock64(); }
// ---- end of device primitives ---------------------------------------------

// Loads and stores of 2 and 4 consecutive values (8 or 16 bytes in float32;
// 16, or two of 16, in float64).
template <typename T> struct V2 {
  using type = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
};

template <typename T>
__device__ __forceinline__ void ld2(const T* p, T& x0, T& x1) {
  const typename V2<T>::type v = *reinterpret_cast<const typename V2<T>::type*>(p);
  x0 = v.x;
  x1 = v.y;
}

template <typename T>
__device__ __forceinline__ void ld4(const T* p, T (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    ld2(p, x[0], x[1]);
    ld2(p + 2, x[2], x[3]);
  }
}

template <typename T>
__device__ __forceinline__ void st4(T* p, const T (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(x[2], x[3]);
  }
}

__host__ __device__ constexpr int up(int x, int to) { return (x + to - 1) / to * to; }

// Job counts rounded up to whole warps: each warp of a stage runs one kind
// of job, so no warp serializes two code paths.
__host__ __device__ constexpr int whole_warps(int jobs) { return up(jobs, 32); }

// Element offsets of the block's shared memory, in units of T.
template <typename T, int N, int M> struct Plan {
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr int NP = F64 ? up(N, 8) : up(N, 4);
  static constexpr int MP = up(M, 4);
  // Row stride of the NP-wide matrices: 16-byte rows, never a multiple of
  // 32 values (S is also read by columns).
  static constexpr int LDN = (NP + 4) % 32 == 0 ? NP + 8 : NP + 4;
  static constexpr int LDM = MP + 4;   // of the MP-wide ones
  // [G | g], [K | duff], [W | H duff]: [MP][NA], the N columns, then the
  // vector in column NP.
  static constexpr int NA = LDN;   // past NP + 1: zero pad columns
  static constexpr int LDL = M + 1;    // L, [M][LDL]
  // Values a step of input k (A, B, qx, ru, Qxx, Pux, Ruu) has.
  __host__ __device__ static constexpr int E(int k) {
    return k == 0 || k == 4 ? N * N : k == 1 || k == 5 ? N * M : k == 2 ? N
           : k == 3 ? M : M * M;
  }
  static constexpr int A = 0;                    // [NP][LDN]
  static constexpr int Bm = A + NP * LDN;        // [NP][LDM]
  static constexpr int S = Bm + NP * LDM;        // the carry; P in stage 3
  static constexpr int St = S + NP * LDN;        // S' (float32 only)
  static constexpr int SA = St + (F64 ? 0 : NP * LDN);
  static constexpr int BtSt = SA + NP * LDN;     // (B'S)' = S'B, [NP][LDM]
  static constexpr int WA = BtSt + NP * LDM;
  static constexpr int KA = WA + MP * NA;
  static constexpr int GA = KA + MP * NA;
  static constexpr int H = GA + MP * NA;         // [MP][LDM]
  static constexpr int L = H + MP * LDM;         // [M][LDL]
  static constexpr int invd = L + up(M * LDL, 4);   // [MP]
  static constexpr int s = invd + MP;
  static constexpr int ys = s + NP;
  static constexpr int ELEMS = ys + NP;
  static constexpr int BYTES = ELEMS * (int)sizeof(T);
  static_assert(0 < N && N <= kMaxN && 0 < M && M <= kMaxM,
                "the plan serves n <= 64 and m <= 32");
  static_assert((N + 1 + SOLVERS - 1) / SOLVERS <= 32, "a thread a column of [G | g]");
  static_assert(M <= 32, "a lane a row of H");
  static_assert(BYTES <= kMaxSharedBytes, "the lane does not fit a block");
  static_assert(Bm % 4 == 0 && S % 4 == 0 && St % 4 == 0 && SA % 4 == 0 &&
                    BtSt % 4 == 0 && WA % 4 == 0 && H % 4 == 0 && L % 4 == 0 &&
                    invd % 4 == 0 && s % 4 == 0 && ys % 4 == 0,
                "regions on 16 bytes");
};

// c[r][q] += sum_{k < KD} a(i0 + r, k) b(k, j0 + q) for the RT x 4 tile at
// (i0, j0), RT = 1 or 2: the left factor k-major (at[k * lda + i] =
// a(i, k)), the right one row-major (b[k * ldb + j]); every thread of a warp
// reads row k of both at the same k, so the loads are free of bank
// conflicts whatever the strides.
template <typename T, int RT, int KD>
__device__ __forceinline__ void tile_acc(const T* at, int lda, const T* b, int ldb,
                                         int i0, int j0, T (&c)[RT][4]) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    T a[RT], bb[4];
    if constexpr (RT == 1) {
      a[0] = at[k * lda + i0];
    } else {
      ld2(at + k * lda + i0, a[0], a[1]);
    }
    ld4(b + k * ldb + j0, bb);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) c[r][q] += a[r] * bb[q];
    }
  }
}

// Tile `job` (RT x 4, row-major over the tiles) of the result C = C0 + A B
// with J columns, the sum over KD: A k-major (at, lda), B row-major (b,
// ldb), C row-major; c0(i, j) the first term of entry (i, j).
template <typename T, int RT, int J, int KD, typename C0>
__device__ __forceinline__ void tile(int job, const T* at, int lda, const T* b, int ldb,
                                     const C0& c0, T* C, int ldc) {
  const int i0 = (job / (J / 4)) * RT, j0 = (job % (J / 4)) * 4;
  T c[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) c[r][q] = c0(i0 + r, j0 + q);
  }
  tile_acc<T, RT, KD>(at, lda, b, ldb, i0, j0, c);
#pragma unroll
  for (int r = 0; r < RT; ++r) st4(C + (i0 + r) * ldc + j0, c[r]);
}

// One 8 x 8 tile of C = C0 + A B on the FP64 tensor core, by a whole warp,
// the sum over KD (a multiple of 4): A k-major (a[k * lda + i]) if KMAJOR,
// else row-major (a[i * lda + k]); B and C row-major; c0 as in tile.
template <bool KMAJOR, int TJ, int KD, typename C0>
__device__ __forceinline__ void tile_mma(int job, const double* a, int lda, const double* b,
                                         int ldb, const C0& c0, double* C, int ldc, int wl) {
  const int g = wl >> 2, q = wl & 3;
  const int i = (job / TJ) * 8 + g;
  const int j0 = (job % TJ) * 8;
  double d0 = c0(i, j0 + 2 * q);
  double d1 = c0(i, j0 + 2 * q + 1);
#pragma unroll 4
  for (int k0 = 0; k0 < KD; k0 += 4) {
    const double av = KMAJOR ? a[(k0 + q) * lda + i] : a[i * lda + k0 + q];
    mma_f64(d0, d1, av, b[(k0 + q) * ldb + j0 + g]);
  }
  C[i * ldc + j0 + 2 * q] = d0;
  C[i * ldc + j0 + 2 * q + 1] = d1;
}

template <typename T, int N, int M, int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
riccati_xl_kernel(const Args<T> args, int T_steps, long long B, int symmetrize) {
  using P = Plan<T, N, M>;
  constexpr bool F64 = P::F64;
  constexpr int NP = P::NP, MP = P::MP, LDN = P::LDN, LDM = P::LDM, NA = P::NA;
  constexpr int LDL = P::LDL;
  // Columns of [G | g] a solver warp solves.
  constexpr int CW = (N + 1 + SOLVERS - 1) / SOLVERS;
  T* smem = reinterpret_cast<T*>(smem_base());

  const int tid = threadIdx.x;
  const int warp = tid / 32, wl = tid % 32;
  const long long b = blockIdx.x;

  T* const A = smem + P::A;
  T* const Bm = smem + P::Bm;
  T* const S = smem + P::S;
  T* const St = F64 ? nullptr : smem + P::St;
  T* const SA = smem + P::SA;
  T* const BtSt = smem + P::BtSt;
  T* const WA = smem + P::WA;
  T* const KA = smem + P::KA;
  T* const GA = smem + P::GA;
  T* const H = smem + P::H;
  T* const Lm = smem + P::L;
  T* const iv = smem + P::invd;
  T* const sv = smem + P::s;
  T* const ys = smem + P::ys;

  // Value e of input k at step t of this lane, where it lies.
  auto in_at = [&](int k, int t, int e) -> T {
    const long long E = P::E(k);
    return LAYOUT == BATCH_LAST ? args.in[k][((long long)t * E + e) * B + b]
                                : args.in[k][((long long)b * T_steps + t) * E + e];
  };
  // Step t's A and B into their padded buffers, by threads lt of `count`
  // (only logical entries: the pad stays zero).
  auto load_AB = [&](int t, int lt, int count) {
#pragma unroll 4
    for (int e = lt; e < N * N; e += count) A[(e / N) * LDN + e % N] = in_at(0, t, e);
#pragma unroll 4
    for (int e = lt; e < N * M; e += count) Bm[(e / M) * LDM + e % M] = in_at(1, t, e);
  };
  const auto zero = [](int, int) { return T(0); };

  for (int i = tid; i < P::ELEMS; i += NT) smem[i] = T(0);
  block_sync();

  // The carry, seeded from the terminal cost (S' too in float32: the first
  // step reads it even when symmetrizing, QN need not be symmetric).
  for (int i = tid; i < N * N; i += NT) {
    const T v = LAYOUT == BATCH_LAST ? args.QN[(long long)i * B + b]
                                     : args.QN[b * N * N + i];
    S[(i / N) * LDN + i % N] = v;
    if constexpr (!F64) St[(i % N) * LDN + i / N] = v;
  }
  for (int i = tid; i < N; i += NT)
    sv[i] = LAYOUT == BATCH_LAST ? args.qxN[(long long)i * B + b] : args.qxN[b * N + i];
  if (T_steps > 0) load_AB(T_steps - 1, tid, NT);
  const T reg_b = args.reg[b];
  const T half = T(0.5);
  T dv1_acc = T(0), dv2_acc = T(0);   // kept by thread NT - 1
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
  block_sync();

  for (int it = 0; it < T_steps; ++it) {
    const int t = T_steps - 1 - it;
#ifdef RICCATI_STAGE_CLOCKS
    c_prev = clock_now();
#endif
    // 1. BtSt = S'B;  g = ru + B's (column NP of GA);  ys = qx + A's;
    //    SA = S A (S' is S once symmetrized).
    {
      constexpr int BT_J = (NP / 2) * (MP / 4);
      constexpr int O1 = whole_warps(BT_J), O2 = O1 + whole_warps(M + N);
      constexpr int SA_J = F64 ? (NP / 8) * (NP / 8) * 32 : (NP / 2) * (NP / 4);
      constexpr int O3 = O2 + whole_warps(SA_J);
      for (int job = tid; job < O3; job += NT) {
        if (job < O1) {
          if (job < BT_J) tile<T, 2, MP, N>(job, S, LDN, Bm, LDM, zero, BtSt, LDM);
        } else if (job < O2) {
          const int v = job - O1;
          if (v < M) {
            T acc = in_at(3, t, v);
#pragma unroll 4
            for (int k = 0; k < N; ++k) acc += Bm[k * LDM + v] * sv[k];
            GA[v * NA + NP] = acc;
          } else if (v < M + N) {
            const int i = v - M;
            T acc = in_at(2, t, i);
#pragma unroll 4
            for (int k = 0; k < N; ++k) acc += A[k * LDN + i] * sv[k];
            ys[i] = acc;
          }
        } else {
          const int sa = job - O2;
          if constexpr (F64) {
            tile_mma<false, NP / 8, up(N, 4)>(sa / 32, S, LDN, A, LDN, zero, SA, LDN, wl);
          } else {
            if (sa < SA_J) {
              const T* Sl = symmetrize && it > 0 ? S : St;
              tile<T, 2, NP, N>(sa, Sl, LDN, A, LDN, zero, SA, LDN);
            }
          }
        }
      }
    }
    block_sync();
    tick(0);

    // 2. G = Pux + BtS A (into GA);  H = Ruu + BtS B.
    {
      constexpr int G_J = MP * (NP / 4);
      constexpr int H_J = MP * (MP / 4);
      constexpr int O1 = whole_warps(G_J);
      const auto pux = [&](int i, int j) {
        return i < M && j < N ? in_at(5, t, i * N + j) : T(0);
      };
      const auto ruu = [&](int i, int j) {
        return i < M && j < M ? in_at(6, t, i * M + j) : T(0);
      };
      for (int job = tid; job < O1 + H_J; job += NT) {
        if (job < O1) {
          if (job < G_J) tile<T, 1, NP, N>(job, BtSt, LDM, A, LDN, pux, GA, NA);
        } else {
          tile<T, 1, MP, N>(job - O1, BtSt, LDM, Bm, LDM, ruu, H, LDM);
        }
      }
    }
    block_sync();
    tick(1);

    // 3. Warps 0-3: the gains.  Warps 4-7: P, the next step's A and B.
    if (warp < SOLVERS) {
      // Cholesky of H + reg I on warp 0, lane i holding row i (a[k] =
      // H(i, k); lanes past M hold a copy of row 0, never read):
      // right-looking, one rsqrt a pivot, L_jj = piv * rsqrt(piv), the pivot
      // and column j of L broadcast by __shfl_sync, the subtractions of every
      // entry in the reference's order (j = 0, 1, ...).  Entries right of
      // the diagonal are computed and never read.
      if (warp == 0) {
        const int row = wl < M ? wl : 0;
        T a[M];
#pragma unroll
        for (int k = 0; k < M; ++k) {
          a[k] = H[row * LDM + k];
          if (k == wl) a[k] += reg_b;
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const T r = rsqrt_<T>(shfl(a[j], j));
          a[j] *= r;
          if (wl == 0) iv[j] = r;
#pragma unroll
          for (int k = j + 1; k < M; ++k) a[k] -= a[j] * shfl(a[j], k);
        }
        if (wl < M) {
#pragma unroll
          for (int k = 0; k < M; ++k) Lm[wl * LDL + k] = a[k];
        }
      }
      group_sync(BAR_SOLVERS, SOLVER_THREADS);
      tick(2);
      // [K | duff] = -(H + reg I)^-1 [G | g], column c by one thread, with
      // the reference's order: x = L^-1 b, then x = L^-T x, multiplying by
      // the reciprocal pivots.  Every lane of the four warps runs the
      // substitutions (lanes past the N + 1 columns on a zero pad column,
      // writing nothing), so that a __syncwarp can close each window of WIN
      // rows: the compiler keeps the loads of L behind it, where hoisting
      // them all ahead of the chain would spill x.
      constexpr int WIN = F64 ? 1 : 2;
      const int qc = warp * CW + wl;
      const bool solving = wl < CW && qc <= N;
      const int c = !solving ? NP + 1 : qc < N ? qc : NP;
      {
        T x[M];
#pragma unroll
        for (int i = 0; i < M; ++i) x[i] = GA[i * NA + c];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          T acc = x[i];
#pragma unroll
          for (int j = 0; j < i; ++j) acc -= Lm[i * LDL + j] * x[j];
          x[i] = acc * iv[i];
          if (i % WIN == WIN - 1) warp_sync();
        }
#pragma unroll
        for (int i = M - 1; i >= 0; --i) {
          T acc = x[i];
#pragma unroll
          for (int j = i + 1; j < M; ++j) acc -= Lm[j * LDL + i] * x[j];
          x[i] = acc * iv[i];
          if ((M - 1 - i) % WIN == WIN - 1) warp_sync();
        }
        if (solving) {
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
      }
      group_sync(BAR_SOLVERS, SOLVER_THREADS);
      tick(3);
      // [W | Hd] = [G | 0] + H [K | duff]: K'HK + K'G = K'W and Hd =
      // H duff, with the raw H.
      for (int job = tid; job < MP * (NA / 4); job += SOLVER_THREADS) {
        const int i = job / (NA / 4), c4 = (job % (NA / 4)) * 4;
        T w[1][4] = {{T(0), T(0), T(0), T(0)}};
        if (c4 < NP) ld4(GA + i * NA + c4, w[0]);
        tile_acc<T, 1, M>(H + i * LDM, 1, KA, NA, 0, c4, w);   // row i of H
        st4(WA + i * NA + c4, w[0]);
      }
      tick(4);
    } else {
      const int lt = tid - SOLVER_THREADS;
      // P = Qxx + A'(SA), into the buffer of S.
      const auto qxx = [&](int i, int j) {
        return i < N && j < N ? in_at(4, t, i * N + j) : T(0);
      };
      if constexpr (F64) {
        constexpr int TJ = NP / 8;
        for (int job = lt / 32; job < TJ * TJ; job += PACKERS / 32)
          tile_mma<true, TJ, up(N, 4)>(job, A, LDN, SA, LDN, qxx, S, LDN, wl);
      } else {
        for (int job = lt; job < (NP / 2) * (NP / 4); job += PACKERS)
          tile<T, 2, NP, N>(job, A, LDN, SA, LDN, qxx, S, LDN);
      }
      if (it + 1 < T_steps) {
        group_sync(BAR_PACKERS, PACKERS);   // every packer done with A
        load_AB(t - 1, lt, PACKERS);
      }
    }
    block_sync();
    tick(5);

    // 4. S = P + K'W + G'K by 2 x 2 blocks (i-block <= j-block) and their
    //    mirrors, written symmetrized (and transposed in float32 when not);
    //    s = ys + K'(H duff + g) + G'duff;  dv1, dv2.
    {
      constexpr int NB = (N + 1) / 2;
      constexpr int PAIRS = NB * (NB + 1) / 2;
      constexpr int O1 = whole_warps(PAIRS);
      for (int job = tid; job < O1 + N; job += NT) {
        if (job < PAIRS) {
          int I = 0, rest = job;
          while (rest >= NB - I) {
            rest -= NB - I;
            ++I;
          }
          const int i0 = 2 * I, j0 = 2 * (I + rest);
          T sn[2][2], sm[2][2];   // Sn(i0 + r, j0 + q) and Sn(j0 + q, i0 + r)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              sn[r][q] = S[(i0 + r) * LDN + j0 + q];
              sm[r][q] = S[(j0 + q) * LDN + i0 + r];
            }
          }
#pragma unroll 2
          for (int a = 0; a < M; ++a) {
            T ki[2], kj[2], wi[2], wj[2];
            ld2(KA + a * NA + i0, ki[0], ki[1]);
            ld2(KA + a * NA + j0, kj[0], kj[1]);
            ld2(WA + a * NA + i0, wi[0], wi[1]);
            ld2(WA + a * NA + j0, wj[0], wj[1]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                sn[r][q] += ki[r] * wj[q];
                sm[r][q] += kj[q] * wi[r];
              }
            }
          }
#pragma unroll 2
          for (int a = 0; a < M; ++a) {
            T gi[2], gj[2], ki[2], kj[2];
            ld2(GA + a * NA + i0, gi[0], gi[1]);
            ld2(GA + a * NA + j0, gj[0], gj[1]);
            ld2(KA + a * NA + i0, ki[0], ki[1]);
            ld2(KA + a * NA + j0, kj[0], kj[1]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                sn[r][q] += gi[r] * kj[q];
                sm[r][q] += gj[q] * ki[r];
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int i = i0 + r, j = j0 + q;
              const T vij = symmetrize ? half * (sn[r][q] + sm[r][q]) : sn[r][q];
              const T vji = symmetrize ? vij : sm[r][q];
              S[i * LDN + j] = vij;
              S[j * LDN + i] = vji;
              if constexpr (!F64) {
                if (!symmetrize) {
                  St[j * LDN + i] = vij;
                  St[i * LDN + j] = vji;
                }
              }
            }
          }
        } else if (job >= O1) {
          const int i = job - O1;
          T acc = ys[i];
#pragma unroll 4
          for (int a = 0; a < M; ++a)
            acc += KA[a * NA + i] * (WA[a * NA + NP] + GA[a * NA + NP]) +
                   GA[a * NA + i] * KA[a * NA + NP];
          sv[i] = acc;
        }
      }
      if (tid == NT - 1) {
        T dg = T(0), dHd = T(0);
#pragma unroll 4
        for (int i = 0; i < M; ++i) {
          const T d = KA[i * NA + NP];
          dg += d * GA[i * NA + NP];
          dHd += d * WA[i * NA + NP];
        }
        dv1_acc += dg;
        dv2_acc += half * dHd;
      }
    }
    block_sync();
    tick(6);
  }

  if (tid == NT - 1) {
    args.dv1[b] = dv1_acc;
    args.dv2[b] = dv2_acc;
  }
#ifdef RICCATI_STAGE_CLOCKS
  if (tid == 0 && args.clocks != nullptr) {
    for (int k = 0; k < kStages; ++k) args.clocks[b * kStages + k] = clk[k];
  }
#endif
}

}  // namespace riccati_xl

namespace {

using namespace riccati_xl;

// The kernel for `layout`, its shared memory allowed (past 48 KB only by
// this attribute) and the carveout set to the most shared memory.
template <typename T, int N, int M>
cudaError_t prepare(int layout, void (**out)(const Args<T>, int, long long, int)) {
  using P = Plan<T, N, M>;
  auto kernel = layout == BATCH_LAST ? riccati_xl_kernel<T, N, M, BATCH_LAST>
                                     : riccati_xl_kernel<T, N, M, BATCH_FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  *out = kernel;
  return cudaSuccess;
}

// The copy path this source reports (cuda_riccati.COPY_PATHS): plain loads
// from device memory where the inputs lie, in both layouts.
constexpr int kPathDirect = 3;

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
  if (path != nullptr) *path = kPathDirect;
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
  void (*kernel)(const Args<T>, int, long long, int) = nullptr;
  cudaError_t err = prepare<T, N, M>(layout, &kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)B), dim3(NT), P::BYTES, static_cast<cudaStream_t>(stream)>>>(
      args, T_steps, B, symmetrize);
  return (int)cudaGetLastError();
}

}  // namespace

#if defined(RICCATI_N) && defined(RICCATI_M) && defined(RICCATI_SCALAR)
// The one instantiation of a build (ops/_build.py), behind the generic
// launcher with the C interface of the other sources: the seven step inputs
// as an array of device pointers, then qxN, QN, reg, the four outputs, T, B,
// symmetrize (0/1), layout (0 batch-last, 1 batch-first), where to write the
// copy path taken (3: plain loads where the inputs lie; may be null), a
// [B, kStages] int64 buffer of stage clocks (null unless built with
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
  return riccati_xl::Plan<RICCATI_SCALAR, RICCATI_N, RICCATI_M>::BYTES;
}
// The blocks (lanes) of the instantiation resident on one SM of the
// current device in `layout`, as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// counts them; a negative cudaError_t on failure.
extern "C" int riccati_cuda_instance_blocks_per_sm(int layout) {
  using T = RICCATI_SCALAR;
  void (*kernel)(const riccati_xl::Args<T>, int, long long, int) = nullptr;
  cudaError_t err = prepare<T, RICCATI_N, RICCATI_M>(layout, &kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, riccati_xl::NT,
        riccati_xl::Plan<T, RICCATI_N, RICCATI_M>::BYTES);
  return err == cudaSuccess ? blocks : -(int)err;
}
#else
#error "riccati_xl.cu has no fixed instantiation: build it with \
-DRICCATI_N, -DRICCATI_M and -DRICCATI_SCALAR (ops/_build.py)"
#endif
