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
// by operations by a little.  The dependent chain of a step holds the kernel
// above that bound, as it does the other two designs.
//
// Why this plan.  riccati_wide.cu cannot reach N = 32 (two lanes a block and
// a ring of three TMA steps pass the 232,448 bytes a block may use at the
// padded (32, 12); one warp solves the N + 1 columns of [G | g]), so a lane
// has a block of its own.  The first plan of this file gave every thread one
// output entry a product (an N-long chain of two shared-memory loads and an
// FMA), factored H on one warp through shared memory, and took six block
// barriers a step: its stage clocks (PERF.md) showed a step of 21,133 cycles
// at (25, 12) float32, stage 1's products and the Cholesky leading, and at
// 124 to 254 registers a thread the float64 rows ran 256 lanes in two waves.
// This plan:
//  * Padded tiles.  The lane's matrices live in shared memory padded to
//    (NP, MP): NP = N rounded up to 8 in float64 (8 x 8 tensor-core tiles)
//    and to 4 in float32, MP = M rounded up to 4, rows of NP + 4 (NP + 8
//    where that is a multiple of 32: S is also read by columns) and MP + 4
//    values (16-byte rows; in float64 the four rows a tensor-core fragment
//    reads fall on distinct banks).  The pad holds zeros: it is zeroed once
//    and only logical entries are written to it, so every padded entry of
//    S, s, G, K and W stays an exact zero and every logical entry gets the
//    sums of the unpadded recursion plus exact zeros; the Cholesky and the
//    solves run at the logical M and N + 1 columns, and only logical duff
//    and K are written out.
//  * Products register-tiled: each thread keeps a 1 x 4 or 2 x 4 tile of
//    the result (2 x 2 pairs of mirrored blocks for S) and reads its
//    operands once a step of the sum from rows that every thread of the
//    warp reads at the same k, so a load feeds 4 to 8 multiply-adds without
//    bank conflicts.  The order of the products: BtSt = S'B (= (B'S)', the
//    left operand of G and H, with no transposed store), SA = S A (its left
//    operand S' is S itself once S is symmetrized; the first step and
//    symmetrize = 0 read a transposed copy), G = Pux + BtS A, H = Ruu +
//    BtS B, P = Qxx + A'(SA) into the buffer of S (dead after stage 1).
//    float64: S A and A'(SA) on the FP64 tensor core (mma.sync
//    m8n8k4, one 8 x 8 tile a warp, exact IEEE products); float32 by FFMA
//    only, no TF32 anywhere (reduced-precision products NaN the recursion
//    at T >= 300, ilqr_tpu/precision.py).
//  * The gains without a block barrier between factor and solve: each of
//    the two solver warps factors H + reg I itself, lane i holding row i in
//    registers (right-looking, one rsqrt a pivot, the pivot and column j of
//    L broadcast by __shfl_sync, the subtractions in the reference's
//    order), writes its L to its own shared rows, and its lanes solve
//    columns of [G | g] (about (N + 1) / 2 each) by the reference's
//    substitutions, reading L as broadcasts a row or two at a time (a
//    __syncwarp closes each window: hoisting every load of L ahead of the
//    chain spilled up to 1.2 KB a thread); [W | H duff] = [G | 0] +
//    H [K | duff] after a barrier of the two warps alone.  (A lane a
//    column of H, one shuffle fewer on a column's chain, measured slower.)
//  * Four block barriers a step:
//      1. BtSt = S'B, SA = S A, g = ru + B's, ys = qx + A's     [barrier]
//      2. G = Pux + BtS A, H = Ruu + BtS B                      [barrier]
//      3. warps 0-1: Cholesky, solves (K, duff written out), W;
//         warps 2-7: P = Qxx + A'(SA), then the next step's inputs out of
//         the staging ring into the padded buffer, then (per element) the
//         copies of a later step                                [barrier]
//      4. S = P + K'W + G'K by mirrored pairs, symmetrized;
//         s = ys + K'(H duff + g) + G'duff; dv1, dv2              [barrier]
//  * Inputs.  A step's inputs land in a staging ring of RING slots (two, or
//    one where two would keep a second block off the SM), densely, and are
//    repacked into the padded buffer by warps 2-7 during stage 3 of the step
//    before.  Batch-first (the launcher refuses an input that does not start
//    on 16 bytes; the entry hands it aligned ones), a lane's step of each
//    input is one contiguous block: one cp.async.bulk (1-D, no tensor map)
//    an input and step, completed on the slot's mbarrier with its byte
//    count, issued at the top of a step RING steps ahead.  The bulk copy
//    wants 16-byte aligned addresses and sizes, which a
//    block of E values need not have (A at (25, 12) float32 is 2,500 bytes a
//    step), so it copies the aligned superset (the block's first 16-byte
//    granule to its last) and the repack reads from the block's offset in
//    it; the granules past the block are in the same pages, so the copy
//    stays in mapped memory.  Batch-last (a lane's value of an element is
//    one value of a row of B lanes), warps 2-7 copy a value at a time with
//    cp.async into the same places and arrive on the same mbarrier
//    (cp.async.mbarrier.arrive.noinc), all of a step's copies from the end
//    of stage 3.  The launcher reports the path taken.
//  * Two lanes an SM: __launch_bounds__(NT, 2) holds a thread to 128
//    registers, and the plan keeps a block under half the SM's shared
//    memory where it can (Plan::BYTES, RING), so that B = 256 lanes run in
//    one wave on 132 SMs.
//
// The limits: n <= 32 and m <= 16 (static_asserts below; cuda_riccati.route
// refuses a larger shape before any nvcc run).
//
// Built with -DRICCATI_STAGE_CLOCKS (a second library, never on the main
// path) thread 0 (a solver) adds the clock64() cycles of each stage of a
// step into a buffer of [B, kStages] counters.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace riccati_large {

constexpr int NT = 256;                    // threads a block, one lane a block
constexpr int SOLVERS = 2;                 // warps that factor and solve
constexpr int SOLVER_THREADS = 32 * SOLVERS;
constexpr int PACKERS = NT - SOLVER_THREADS;   // P, the repack, the copies
constexpr int PRODUCER = SOLVER_THREADS;   // the packer that issues bulk copies
constexpr int NIN = 7;                     // A, B, qx, ru, Qxx, Pux, Ruu
constexpr int kMaxSharedBytes = 232448;    // what a Hopper block may use
// What a block may take so that two fit an SM: 228 KB a SM, 1 KB of it
// reserved a block.
constexpr int kTwoBlockBytes = 233472 / 2 - 1024;
constexpr int kStages = 7;                 // see STAGES in cuda_riccati.py
constexpr int kMaxN = 32, kMaxM = 16;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from `src` to `dst` (both on 16 bytes) by the
// bulk-copy engine, completing on `bar`.  The fence orders the generic
// reads of the slot before it (the repack) before the copy's writes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// One value, asynchronously.
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)),
               "l"(src), "n"(sizeof(T)) : "memory");
}

// `bar` counts one arrival of this thread once its cp.asyncs have landed.
__device__ __forceinline__ void copy_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

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
  static constexpr int LDL = M + 1;    // a solver warp's L, [M][LDL]
  static constexpr int VEC = 16 / (int)sizeof(T);   // values a 16-byte granule
  // Input k is a d1(k) x d2(k) matrix a step (vectors are 1 x len); padded,
  // prow(k) rows of pld(k).
  __host__ __device__ static constexpr int d1(int k) {
    return k == 0 || k == 1 || k == 4 ? N : k == 5 || k == 6 ? M : 1;
  }
  __host__ __device__ static constexpr int d2(int k) {
    return k == 1 || k == 3 || k == 6 ? M : N;
  }
  __host__ __device__ static constexpr int E(int k) { return d1(k) * d2(k); }
  __host__ __device__ static constexpr int prow(int k) {
    return k == 0 || k == 1 || k == 4 ? NP : k == 5 || k == 6 ? MP : 1;
  }
  __host__ __device__ static constexpr int pld(int k) {
    return k == 2 ? NP : k == 3 ? MP : k == 1 || k == 6 ? LDM : LDN;
  }
  // The padded inputs, then the working matrices.  (Sums by loops, not
  // recursion: a recursive call that is not folded would be a real call.)
  __host__ __device__ static constexpr int pin(int k) {
    int at = 0;
    for (int q = 0; q < k; ++q) at += prow(q) * pld(q);
    return at;
  }
  static constexpr int S = pin(NIN);             // the carry; P in stage 3
  static constexpr int St = S + NP * LDN;        // S' (float32 only)
  static constexpr int SA = St + (F64 ? 0 : NP * LDN);
  static constexpr int BtSt = SA + NP * LDN;     // (B'S)' = S'B, [NP][LDM]
  static constexpr int WA = BtSt + NP * LDM;
  static constexpr int KA = WA + MP * NA;
  static constexpr int GA = KA + MP * NA;
  static constexpr int H = GA + MP * NA;         // [MP][LDM]
  static constexpr int L = H + MP * LDM;         // SOLVERS x [M][LDL]
  static constexpr int LWARP = up(M * LDL, 4);
  static constexpr int invd = L + SOLVERS * LWARP;   // SOLVERS x [MP]
  static constexpr int s = invd + SOLVERS * MP;
  static constexpr int ys = s + NP;
  // The staging ring: input k of a step at sin(k) of its slot, room for
  // the 16-byte aligned superset of its block.
  __host__ __device__ static constexpr int sreg(int k) { return up(E(k) + 2 * VEC, VEC); }
  __host__ __device__ static constexpr int sin(int k) {
    int at = 0;
    for (int q = 0; q < k; ++q) at += sreg(q);
    return at;
  }
  static constexpr int SLOT = sin(NIN);
  static constexpr int STAGE = ys + NP;
  __host__ __device__ static constexpr int bytes_of(int ring) {
    return up((STAGE + ring * SLOT) * (int)sizeof(T), 8) + 8 * ring;
  }
  // Two slots, unless only one keeps the block within two an SM.
  static constexpr int RING =
      bytes_of(2) > kTwoBlockBytes && bytes_of(1) <= kTwoBlockBytes ? 1 : 2;
  static constexpr int ELEMS = STAGE + RING * SLOT;
  static constexpr int BAR = up(ELEMS * (int)sizeof(T), 8);   // byte offset of the mbarriers
  static constexpr int BYTES = bytes_of(RING);
  static_assert(0 < N && N <= kMaxN && 0 < M && M <= kMaxM,
                "the plan serves n <= 32 and m <= 16");
  static_assert((N + 1 + SOLVERS - 1) / SOLVERS <= 32, "a thread a column of [G | g]");
  static_assert(M <= 32, "a lane a row of H");
  static_assert(BYTES <= kMaxSharedBytes, "the lane does not fit a block");
  static_assert(S % 4 == 0 && St % 4 == 0 && SA % 4 == 0 && BtSt % 4 == 0 &&
                    WA % 4 == 0 && H % 4 == 0 && L % 4 == 0 && invd % 4 == 0 &&
                    s % 4 == 0 && STAGE % 4 == 0 && SLOT % VEC == 0,
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
// ldb), C0 (may be null: zero) and C row-major, or (C null) C transposed
// into Ct.
template <typename T, int RT, int J, int KD>
__device__ __forceinline__ void tile(int job, const T* at, int lda, const T* b, int ldb,
                                     const T* c0, int ldc0, T* C, int ldc, T* Ct,
                                     int ldct) {
  const int i0 = (job / (J / 4)) * RT, j0 = (job % (J / 4)) * 4;
  T c[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (c0 != nullptr) {
      ld4(c0 + (i0 + r) * ldc0 + j0, c[r]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) c[r][q] = T(0);
    }
  }
  tile_acc<T, RT, KD>(at, lda, b, ldb, i0, j0, c);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (C != nullptr) {
      st4(C + (i0 + r) * ldc + j0, c[r]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) Ct[(j0 + q) * ldct + i0 + r] = c[r][q];
    }
  }
}

// One 8 x 8 tile of C = C0 + A B on the FP64 tensor core, by a whole warp,
// the sum over KD (a multiple of 4): A k-major (a[k * lda + i]) if KMAJOR,
// else row-major (a[i * lda + k]); B and C row-major.
template <bool KMAJOR, int TJ, int KD>
__device__ __forceinline__ void tile_mma(int job, const double* a, int lda, const double* b,
                                         int ldb, const double* c0, int ldc0, double* C,
                                         int ldc, int wl) {
  const int g = wl >> 2, q = wl & 3;
  const int i = (job / TJ) * 8 + g;
  const int j0 = (job % TJ) * 8;
  double d0 = c0 ? c0[i * ldc0 + j0 + 2 * q] : 0.0;
  double d1 = c0 ? c0[i * ldc0 + j0 + 2 * q + 1] : 0.0;
#pragma unroll 4
  for (int k0 = 0; k0 < KD; k0 += 4) {
    const double av = KMAJOR ? a[(k0 + q) * lda + i] : a[i * lda + k0 + q];
    mma_f64(d0, d1, av, b[(k0 + q) * ldb + j0 + g]);
  }
  C[i * ldc + j0 + 2 * q] = d0;
  C[i * ldc + j0 + 2 * q + 1] = d1;
}

template <typename T, int N, int M, int LAYOUT>
__global__ void __launch_bounds__(NT, 2)
riccati_large_kernel(const Args<T> args, int T_steps, long long B, int symmetrize) {
  using P = Plan<T, N, M>;
  // Bulk copies batch-first, a value a copy batch-last.
  constexpr bool bulk = LAYOUT == BATCH_FIRST;
  constexpr bool F64 = P::F64;
  constexpr int NP = P::NP, MP = P::MP, LDN = P::LDN, LDM = P::LDM, NA = P::NA;
  constexpr int LDL = P::LDL, RING = P::RING;
  // Columns of [G | g] a solver warp solves.
  constexpr int CW = (N + 1 + SOLVERS - 1) / SOLVERS;
  unsigned char* raw = smem_base();
  T* smem = reinterpret_cast<T*>(raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + P::BAR);

  const int tid = threadIdx.x;
  const int warp = tid / 32, wl = tid % 32;
  const long long b = blockIdx.x;

  T* const S = smem + P::S;
  T* const St = F64 ? nullptr : smem + P::St;
  T* const SA = smem + P::SA;
  T* const BtSt = smem + P::BtSt;
  T* const WA = smem + P::WA;
  T* const KA = smem + P::KA;
  T* const GA = smem + P::GA;
  T* const H = smem + P::H;
  T* const sv = smem + P::s;
  T* const ys = smem + P::ys;
  const T* const A = smem + P::pin(0);
  const T* const Bm = smem + P::pin(1);
  const T* const qx = smem + P::pin(2);
  const T* const ru = smem + P::pin(3);
  const T* const Qxx = smem + P::pin(4);
  const T* const Pux = smem + P::pin(5);
  const T* const Ruu = smem + P::pin(6);

  // The 16-byte granule offset of lane b's block of input k at step t
  // (bulk copies only), in values.
  auto shift = [&](int k, int t) -> int {
    return bulk ? (int)((((long long)b * T_steps + t) * P::E(k)) % P::VEC) : 0;
  };

  // Packers: bring iteration it (step T-1-it) into its slot of the ring,
  // arriving on the slot's mbarrier.
  auto issue = [&](int it) {
    const int t = T_steps - 1 - it;
    const int r = it % RING;
    T* slot = smem + P::STAGE + r * P::SLOT;
    if constexpr (bulk) {
      if (tid != PRODUCER) return;
      uint32_t total = 0;
#pragma unroll
      for (int k = 0; k < NIN; ++k)
        total += (uint32_t)up((shift(k, t) + P::E(k)) * (int)sizeof(T), 16);
      mbar_arrive_expect_tx(&full[r], total);
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        const int sh = shift(k, t);
        bulk_load(slot + P::sin(k),
                  args.in[k] + ((long long)b * T_steps + t) * P::E(k) - sh,
                  (uint32_t)up((sh + P::E(k)) * (int)sizeof(T), 16), &full[r]);
      }
    } else {
      const int lt = tid - SOLVER_THREADS;
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        const int E = P::E(k);
        for (int e = lt; e < E; e += PACKERS)
          copy_elem(slot + P::sin(k) + e, args.in[k] + ((long long)t * E + e) * B + b);
      }
      copy_arrive(&full[r]);
    }
  };

  // Packers: wait for iteration it's slot, then copy it into the padded
  // buffer (only logical entries: the pad stays zero).
  auto repack = [&](int it) {
    const int t = T_steps - 1 - it;
    const int r = it % RING;
    mbar_wait(&full[r], (uint32_t)((it / RING) & 1));
    const T* slot = smem + P::STAGE + r * P::SLOT;
    const int lt = tid - SOLVER_THREADS;
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      const T* from = slot + P::sin(k) + shift(k, t);
      T* to = smem + P::pin(k);
      for (int e = lt; e < P::E(k); e += PACKERS)
        to[(e / P::d2(k)) * P::pld(k) + e % P::d2(k)] = from[e];
    }
  };

  for (int i = tid; i < P::ELEMS; i += NT) smem[i] = T(0);
  if (tid == 0) {
    for (int r = 0; r < RING; ++r) mbar_init(&full[r], bulk ? 1 : PACKERS);
  }
  mbar_init_fence();
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

  if (warp >= SOLVERS && T_steps > 0) {
    for (int it = 0; it < RING && it < T_steps; ++it) issue(it);
    repack(0);
    if (!bulk) {
      group_sync(BAR_PACKERS, PACKERS);
      if (RING < T_steps) issue(RING);
    }
  }
  block_sync();

  for (int it = 0; it < T_steps; ++it) {
    const int t = T_steps - 1 - it;
#ifdef RICCATI_STAGE_CLOCKS
    c_prev = clock_now();
#endif
    // Bulk copies: iteration it + RING into the slot iteration it left (its
    // repack ended before the last block barrier).
    if (bulk && tid == PRODUCER && it + RING < T_steps) issue(it + RING);
    // 1. BtSt = S'B;  g = ru + B's (column NP of GA);  ys = qx + A's;
    //    SA = S A (S' is S once symmetrized).
    {
      constexpr int BT_J = (NP / 2) * (MP / 4);
      constexpr int O1 = whole_warps(BT_J), O2 = O1 + whole_warps(M + N);
      constexpr int SA_J = F64 ? (NP / 8) * (NP / 8) * 32 : (NP / 2) * (NP / 4);
      constexpr int O3 = O2 + whole_warps(SA_J);
      for (int job = tid; job < O3; job += NT) {
        if (job < O1) {
          if (job < BT_J)
            tile<T, 2, MP, N>(job, S, LDN, Bm, LDM, nullptr, 0, BtSt, LDM, nullptr, 0);
        } else if (job < O2) {
          const int v = job - O1;
          if (v < M) {
            T acc = ru[v];
#pragma unroll 4
            for (int k = 0; k < N; ++k) acc += Bm[k * LDM + v] * sv[k];
            GA[v * NA + NP] = acc;
          } else if (v < M + N) {
            const int i = v - M;
            T acc = qx[i];
#pragma unroll 4
            for (int k = 0; k < N; ++k) acc += A[k * LDN + i] * sv[k];
            ys[i] = acc;
          }
        } else {
          const int sa = job - O2;
          if constexpr (F64) {
            tile_mma<false, NP / 8, up(N, 4)>(sa / 32, S, LDN, A, LDN, nullptr, 0, SA,
                                              LDN, wl);
          } else {
            if (sa < SA_J) {
              const T* Sl = symmetrize && it > 0 ? S : St;
              tile<T, 2, NP, N>(sa, Sl, LDN, A, LDN, nullptr, 0, SA, LDN, nullptr, 0);
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
      for (int job = tid; job < O1 + H_J; job += NT) {
        if (job < O1) {
          if (job < G_J)
            tile<T, 1, NP, N>(job, BtSt, LDM, A, LDN, Pux, LDN, GA, NA, nullptr, 0);
        } else {
          tile<T, 1, MP, N>(job - O1, BtSt, LDM, Bm, LDM, Ruu, LDM, H, LDM, nullptr, 0);
        }
      }
    }
    block_sync();
    tick(1);

    // 3. Warps 0-1: the gains.  Warps 2-7: P, the next step's inputs.
    if (warp < SOLVERS) {
      T* Lw = smem + P::L + warp * P::LWARP;
      T* iw = smem + P::invd + warp * MP;
      // Cholesky of H + reg I, lane i holding row i (a[k] = H(i, k); lanes
      // past M hold a copy of row 0, never read): right-looking, one rsqrt
      // a pivot, L_jj = piv * rsqrt(piv), the pivot and column j of L
      // broadcast by __shfl_sync, the subtractions of every entry in the
      // reference's order (j = 0, 1, ...).  Entries right of the diagonal
      // are computed and never read.
      {
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
          if (wl == 0) iw[j] = r;
#pragma unroll
          for (int k = j + 1; k < M; ++k) a[k] -= a[j] * shfl(a[j], k);
        }
        if (wl < M) {
#pragma unroll
          for (int k = 0; k < M; ++k) Lw[wl * LDL + k] = a[k];
        }
        warp_sync();
      }
      tick(2);
      // [K | duff] = -(H + reg I)^-1 [G | g], column c by one thread, with
      // the reference's order: x = L^-1 b, then x = L^-T x, multiplying by
      // the reciprocal pivots.
      // Every lane of the two warps runs the substitutions (lanes past the
      // N + 1 columns on a zero pad column, writing nothing), so that a
      // __syncwarp can close each window of WIN rows: the compiler keeps
      // the loads of L behind it, where hoisting them all ahead of the
      // chain would spill x.
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
          for (int j = 0; j < i; ++j) acc -= Lw[i * LDL + j] * x[j];
          x[i] = acc * iw[i];
          if (i % WIN == WIN - 1) warp_sync();
        }
#pragma unroll
        for (int i = M - 1; i >= 0; --i) {
          T acc = x[i];
#pragma unroll
          for (int j = i + 1; j < M; ++j) acc -= Lw[j * LDL + i] * x[j];
          x[i] = acc * iw[i];
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
        const int i = job / (NA / 4), c = (job % (NA / 4)) * 4;
        T w[1][4] = {{T(0), T(0), T(0), T(0)}};
        if (c < NP) ld4(GA + i * NA + c, w[0]);
        tile_acc<T, 1, M>(H + i * LDM, 1, KA, NA, 0, c, w);   // row i of H
        st4(WA + i * NA + c, w[0]);
      }
      tick(4);
    } else {
      const int lt = tid - SOLVER_THREADS;
      // P = Qxx + A'(SA), into the buffer of S.
      if constexpr (F64) {
        constexpr int TJ = NP / 8;
        for (int job = lt / 32; job < TJ * TJ; job += PACKERS / 32)
          tile_mma<true, TJ, up(N, 4)>(job, A, LDN, SA, LDN, Qxx, LDN, S, LDN, wl);
      } else {
        for (int job = lt; job < (NP / 2) * (NP / 4); job += PACKERS)
          tile<T, 2, NP, N>(job, A, LDN, SA, LDN, Qxx, LDN, S, LDN, nullptr, 0);
      }
      if (it + 1 < T_steps) {
        group_sync(BAR_PACKERS, PACKERS);   // A and Qxx read
        repack(it + 1);
        if (!bulk) {
          // Per-element copies: into the slot just read, once every packer
          // is past it.
          group_sync(BAR_PACKERS, PACKERS);
          if (it + 1 + RING < T_steps) issue(it + 1 + RING);
        }
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

}  // namespace riccati_large

namespace {

using namespace riccati_large;

// The kernel for `layout`, its shared memory allowed (past 48 KB only by
// this attribute) and the carveout set to the most shared memory, so that
// two blocks fit an SM where the plan allows.
template <typename T, int N, int M>
cudaError_t prepare(int layout, void (**out)(const Args<T>, int, long long, int)) {
  using P = Plan<T, N, M>;
  auto kernel = layout == BATCH_LAST ? riccati_large_kernel<T, N, M, BATCH_LAST>
                                     : riccati_large_kernel<T, N, M, BATCH_FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  *out = kernel;
  return cudaSuccess;
}

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
  // Bulk copies batch-first: every input must start on 16 bytes.
  if (layout == BATCH_FIRST)
    for (int k = 0; k < NIN; ++k)
      if (reinterpret_cast<uintptr_t>(in[k]) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
  if (path != nullptr) *path = layout;   // 1 bulk copies, 0 a value a copy
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
// launcher with the C interface of riccati.cu and riccati_wide.cu: the seven
// step inputs as an array of device pointers, then qxN, QN, reg, the four
// outputs, T, B, symmetrize (0/1), layout (0 batch-last, 1 batch-first),
// where to write the copy path taken (1: bulk copies, batch-first, whose
// inputs must start on 16 bytes; 0: a value a copy; may be null), a [B, kStages]
// int64 buffer of stage clocks (null unless built with
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
// The blocks (lanes) of the instantiation resident on one SM of the
// current device in `layout`, as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// counts them; a negative cudaError_t on failure.
extern "C" int riccati_cuda_instance_blocks_per_sm(int layout) {
  using T = RICCATI_SCALAR;
  void (*kernel)(const riccati_large::Args<T>, int, long long, int) = nullptr;
  cudaError_t err = prepare<T, RICCATI_N, RICCATI_M>(layout, &kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, riccati_large::NT,
        riccati_large::Plan<T, RICCATI_N, RICCATI_M>::BYTES);
  return err == cudaSuccess ? blocks : -(int)err;
}
#else
#error "riccati_large.cu has no fixed instantiation: build it with \
-DRICCATI_N, -DRICCATI_M and -DRICCATI_SCALAR (ops/_build.py)"
#endif
