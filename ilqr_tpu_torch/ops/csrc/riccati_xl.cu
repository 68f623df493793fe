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
// operations but at (36, 18) float64.  What holds a lane above that bound is
// the dependent chain of its step: rounds of products, the factorization,
// two substitutions of up to 32 rows, the value update.  The first plan of
// this file read a step's first terms from device memory as each sum began,
// ran stages in two or three rounds of their tiles, factored on one warp
// behind a barrier of four, and spent 6 to 40 times the bound.  This plan
// shortens the chain (every choice below was timed against its alternative
// on an H100 by scripts/time_xl_variants.py; PERF.md):
//
//  * No device-memory read on the chain.  A step's inputs are on their way
//    while the step before runs, by one of two copy paths (Policy below, at
//    compile time; the launcher reports the one it took):
//      - staged (path 1, "tma"): a ring of RING = 2 slots in shared memory
//        beside the plan.  Batch-first, one 1-D cp.async.bulk an input and
//        step (a lane's step of an input is one contiguous block; the 16-byte
//        aligned superset is copied, as riccati_large.cu does, and the
//        launcher refuses inputs that do not start on 16 bytes).  Batch-last,
//        one TMA box an input and step of 16 bytes of lanes (4-d tensor maps,
//        as riccati_wide.cu builds them), the lane's own column picked out
//        where it is read.  Both complete on the slot's mbarrier, issued at
//        the top of the step before.  The first terms of the sums (qx, ru,
//        Pux, Ruu, Qxx) are read from the slot; A and B are repacked from it
//        into their padded buffers by the packer warps in stage 3.
//      - register prefetch (path 4): where no ring fits.  The map from job
//        to thread is the same every step, so each thread loads the first
//        terms of its own jobs of step t - 1 into registers during step t
//        (stage 1's as the value update starts, the rest as it ends, so that
//        they are not live across the solvers' chain or the value update's
//        tiles); the packer warps load the next A and B in stage 3.
//    A box of 16 bytes of lanes holds four lanes' values in float32 and two
//    in float64, so a batch-last slot is that many times a lane's step; two
//    of them do not fit beside the plan at (64, 32), and take the second
//    block an SM at (36, 18) float32, where they still ran 1.12 times as
//    fast as registers at two blocks at B = 256 and 1.46 times at B = 64
//    (a 32-byte sector a value read, scripts/time_xl_variants.py).  So
//    batch-last takes TMA wherever a ring fits, batch-first the bulk copy
//    where it fits and costs no block; registers at (64, 32) batch-last,
//    float64 (64, 32) batch-first (204 KB of plan) and a batch-last row of
//    B lanes that is not whole 16-byte granules.
//  * One round a stage.  Each product's tile height (1, 2 or 4 rows of 4
//    columns) is the least that takes the fewest rounds of the block's
//    threads: at (36, 18) float32 stages 1, 2 and 4 each run one round
//    (stage 1: 2 x 4 tiles of S'B and 4 x 4 of S A; stage 2: 2 x 4 tiles of G
//    and H and 4 x 4 of P; the value update by mirrored 2 x 2 pairs, by
//    4 x 4 pairs where 2 x 2 would take more rounds, as at (64, 32)).  P =
//    Qxx + A'(SA) is formed in stage 2 beside G and H unless that costs
//    stage 2 a round in float32 (at (64, 32), where the packer warps form it
//    in stage 3 beside the solvers): products beside the solvers' chain
//    slowed its shuffles and broadcast loads 2 to 4 times.  Every entry is
//    still summed from its first term in the order of k, so the tile heights
//    do not move a bit: the outputs equal the first plan's.  float64 S A and P
//    stay on the FP64 tensor core (mma.sync m8n8k4, exact IEEE products), a
//    warp an 8-row strip of tiles (their products independent), the rest by
//    FMA.
//  * The gains without a barrier between factor and solve.  Each of the
//    SOLVERS = ceil((N + 1) / 32) solver warps factors H + reg I itself,
//    lane i holding row i in registers (right-looking, one rsqrt a pivot,
//    L_jj = piv * rsqrt(piv), the pivot and column j of L broadcast by
//    __shfl_sync, the subtractions of every entry in the reference's order,
//    the next pivot formed by its own lane so that a column's chain waits
//    for one shuffle), writes its L packed (row i at i (i + 1) / 2) into the
//    buffer of S'B, dead after stage 2, and its lanes solve the columns of
//    [G | g] by the reference's substitutions, reading L as broadcasts, a
//    __syncwarp after every row in float64 and every two in float32
//    (without it ptxas hoists the loads of L ahead of the chain and spills,
//    riccati_large.cu's lesson).  H is kept transposed, so that the factor
//    reads a column and [W | H duff] = [G | 0] + H [K | duff] takes 4-row
//    tiles of it.
//  * Four block barriers a step:
//      1. BtSt = S'B, SA = S A, g = ru + B's, ys = qx + A's     [barrier]
//      2. G = Pux + BtS A, Ht = (Ruu + BtS B)', P (most shapes)  [barrier]
//      3. solver warps: Cholesky, solves (K, duff written out), W;
//         packer warps: P (at (64, 32) float32), the next A, B  [barrier]
//      4. S = P + K'W + G'K by mirrored pairs, symmetrized;
//         s = ys + K'(H duff + g) + G'duff; dv1, dv2              [barrier]
//  * Two lanes an SM batch-first where shared memory allows and m <= 24 in
//    float32 (m <= 16 in float64): __launch_bounds__(NT, 2) holds a thread
//    to 128 registers; else (NT, 1), up to 255 (a solver holds a column of
//    up to 32 values, the factoring lane a row of 32).  No instantiation
//    spills: the thread and batch indices are taken anew at every step (an
//    opaque copy), so that ptxas recomputes the indices derived from them
//    instead of holding them across the step loop, and reg and the dv sums
//    live in shared memory.
//
// Measured on an H100 (PERF.md): 1.02 to 1.62 times as fast as the first
// plan batch-first and 1.16 to 1.94 times batch-last, with the same bits;
// 3.8 to 16 times the bound batch-first and 8.2 to 20 batch-last, the rest
// being the chain the reference's order fixes (the factor and the two
// substitutions, the whole step at (20, 32)) and, at a small batch, SMs left
// without a lane.
//
// The limits: n <= 64, m <= 32 and the block's shared memory (static_asserts
// below; cuda_riccati.route refuses a larger shape before any nvcc run).
// Past them a lane outgrows one block: a cluster of two blocks splitting the
// rows of S and reading each other's through distributed shared memory.
//
// Built with -DRICCATI_STAGE_CLOCKS (a second library, never on the main
// path) thread 0 (solver warp 0) adds the clock64() cycles of each stage of
// a step into a buffer of [B, kStages] counters.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace riccati_xl {

constexpr int NT = 256;                    // threads a block, one lane a block
constexpr int NIN = 7;                     // A, B, qx, ru, Qxx, Pux, Ruu
constexpr int kMaxSharedBytes = 232448;    // what a Hopper block may use
// What a block may take so that two fit an SM: 228 KB a SM, 1 KB of it
// reserved a block.
constexpr int kTwoBlockBytes = 233472 / 2 - 1024;
constexpr int kStages = 7;                 // see STAGES in cuda_riccati.py
constexpr int kMaxN = 64, kMaxM = 32;
constexpr int RING = 2;                    // slots of the staging ring
// Named barriers (0 is __syncthreads).
constexpr int BAR_SOLVERS = 1, BAR_PACKERS = 2;
// The copy paths the launcher reports (cuda_riccati.COPY_PATHS): the bulk
// copy or TMA engine into the staging ring, or registers.
constexpr int kPathTma = 1, kPathPrefetch = 4;

enum { BATCH_LAST = 0, BATCH_FIRST = 1 };

struct Maps {
  CUtensorMap m[NIN];
};

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
  extern __shared__ __align__(128) unsigned char smem_raw[];
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

// Orders the generic accesses to shared memory before it (the reads of a
// slot, made visible to this thread by a barrier) before the async proxy's
// writes after it.
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16) from `src` to `dst` (both on 16 bytes) by the
// bulk-copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar)) : "memory");
}

// D (8x8) += A (8x4) B (4x8) on the FP64 tensor core; a thread holds
// a(g, q), b(q, g) and d(g, 2q), d(g, 2q+1), g = lane/4, q = lane%4.
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d0), "+d"(d1) : "d"(a), "d"(b));
}

__device__ __forceinline__ long long clock_now() { return clock64(); }

// x, as a value the compiler cannot see through: the index arithmetic
// derived from it is redone where it is used, instead of being hoisted out
// of the step loop and kept live across it (which spilled).
__device__ __forceinline__ int opaque(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ long long opaque(long long x) {
  long long y;
  asm volatile("mov.b64 %0, %1;" : "=l"(y) : "l"(x));
  return y;
}
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

// R (1, 2 or 4) consecutive values.
template <typename T, int R>
__device__ __forceinline__ void ldr(const T* p, T (&x)[R]) {
  if constexpr (R == 1) {
    x[0] = p[0];
  } else if constexpr (R == 2) {
    ld2(p, x[0], x[1]);
  } else {
    ld4(p, x);
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
__host__ __device__ constexpr int rounds(int jobs, int threads) {
  return (jobs + threads - 1) / threads;
}
__host__ __device__ constexpr int max_(int a, int b) { return a > b ? a : b; }

// Input k as a type, so that its pointer and shape are constants where it
// is read.
template <int k> using In = std::integral_constant<int, k>;

// Element offsets of the block's shared memory, in units of T, and the
// shape of its work, for one layout and copy path (STAGED: the ring of
// slots; else the registers).
template <typename T, int N, int M, int LAYOUT, bool STAGED> struct Plan {
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
  static constexpr int VEC = 16 / (int)sizeof(T);   // values a 16-byte granule

  // The warps: solvers (a lane a column of [G | g]), then packers.
  static constexpr int SOLVERS = (N + 1 + 31) / 32;
  static constexpr int SOLVER_THREADS = 32 * SOLVERS;
  static constexpr int PACKERS = NT - SOLVER_THREADS;
  static constexpr int CW = (N + 1 + SOLVERS - 1) / SOLVERS;   // columns a solver warp
  static constexpr int PRODUCER = SOLVER_THREADS;   // the packer that issues copies

  // Input k is a d1(k) x d2(k) matrix a step (vectors are 1 x len).
  __host__ __device__ static constexpr int d1(int k) {
    return k == 0 || k == 1 || k == 4 ? N : k == 5 || k == 6 ? M : 1;
  }
  __host__ __device__ static constexpr int d2(int k) {
    return k == 1 || k == 3 || k == 6 ? M : N;
  }
  __host__ __device__ static constexpr int E(int k) { return d1(k) * d2(k); }

  static constexpr int TJ = NP / 8;   // float64: 8 x 8 tiles an 8-row strip

  // Tile heights, the least of 1, 2, 4 (rows of 4 columns) that takes the
  // fewest rounds: stage 1 (S'B over RB rows, S A over RS; float64 S A in
  // 8-row strips of tensor-core tiles, a warp each), stage 2 (G over RG, H
  // over RH, P over RP: float32; float64 P in strips), stage 3 (W over RW
  // by the solvers; P over RP by the packers where it is formed there).
  __host__ __device__ static constexpr int jobs1(int rb, int rs) {
    return whole_warps((NP / rb) * (MP / 4)) + whole_warps(M + N) +
           (F64 ? TJ * 32 : whole_warps((NP / rs) * (NP / 4)));
  }
  __host__ __device__ static constexpr int jobs2(int rg, int rh, int rp, bool with_p) {
    return whole_warps((MP / rg) * (NP / 4)) + whole_warps((MP / rh) * (MP / 4)) +
           (!with_p ? 0 : F64 ? TJ * 32 : whole_warps((NP / rp) * (NP / 4)));
  }
  // (rows of the first product) * 64 + (of the second) * 8 + (of the
  // third): the heights with the fewest rounds of NT threads, then the
  // least rows; stage 2 with P or without.
  __host__ __device__ static constexpr int pick(int stage, bool with_p) {
    int best = 0, cost = 1 << 30;
    for (int a = 1; a <= 4; a *= 2) {
      for (int b = 1; b <= 4; b *= 2) {
        for (int c = 1; c <= 4; c *= 2) {
          const int k =
              rounds(stage == 1 ? jobs1(a, b) : jobs2(a, b, c, with_p), NT) * 64 + a + b + c;
          if (k < cost) {
            cost = k;
            best = a * 64 + b * 8 + c;
          }
        }
      }
    }
    return best;
  }
  // The least rows of 1, 2, 4 whose tiles of a rows x cols result take the
  // fewest rounds of `threads`.
  __host__ __device__ static constexpr int pick1(int rows, int cols, int threads) {
    int best = 4;
    for (int a = 4; a >= 1; a /= 2)
      if (rounds((rows / a) * (cols / 4), threads) <=
          rounds((rows / 4) * (cols / 4), threads))
        best = a;
    return best;
  }
  // Where P = Qxx + A'(SA) is formed: in stage 2 beside G and H, by every
  // thread, unless that takes stage 2 another round in float32 (as at
  // (64, 32)); then in stage 3 by the packer warps, beside the solvers'
  // chain.  (float64 P in stage 3, on the tensor cores, slows the solvers'
  // shared-memory loads and shuffles more than the round costs.)
  static constexpr bool P_IN_G_H =
      F64 || rounds(jobs2(pick(2, true) / 64, pick(2, true) / 8 % 8, pick(2, true) % 8, true), NT) ==
                 rounds(jobs2(pick(2, false) / 64, pick(2, false) / 8 % 8, 1, false), NT);
  static constexpr int RB = pick(1, false) / 64, RS = pick(1, false) / 8 % 8;
  static constexpr int RG = pick(2, P_IN_G_H) / 64, RH = pick(2, P_IN_G_H) / 8 % 8;
  static constexpr int RP = P_IN_G_H ? pick(2, true) % 8 : pick1(NP, NP, PACKERS);
  static constexpr int RW = pick1(MP, NA, SOLVER_THREADS);
  static constexpr int R1 = rounds(jobs1(RB, RS), NT);
  static constexpr int R2 = rounds(jobs2(RG, RH, RP, P_IN_G_H), NT);
  // P's rounds in stage 3 (float32 RP x 4 tiles a packer), W's a solver.
  static constexpr int R3 = P_IN_G_H ? 0 : rounds((NP / RP) * (NP / 4), PACKERS);
  static constexpr int RWR = rounds((MP / RW) * (NA / 4), SOLVER_THREADS);
  // The first terms a thread holds for a job: an RT x 4 tile, or a float64
  // strip's 2 TJ.
  static constexpr int FTP = F64 ? 2 * TJ : 4 * RP;
  static constexpr int FT2 = max_(4 * max_(RG, RH), P_IN_G_H ? FTP : 0);
  // The value update: mirrored VB x VB pairs of blocks (i-block <= j-block),
  // 2 x 2 unless 4 x 4 takes fewer rounds.
  __host__ __device__ static constexpr int jobs4(int vb) {
    return whole_warps(((N + vb - 1) / vb) * ((N + vb - 1) / vb + 1) / 2) + N;
  }
  static constexpr int VB = rounds(jobs4(2), NT) <= rounds(jobs4(4), NT) ? 2 : 4;
  static constexpr int R4 = rounds(jobs4(VB), NT);

  // Shared memory: the plan, then the staging ring.
  static constexpr int A = 0;                    // [NP][LDN]
  static constexpr int Bm = A + NP * LDN;        // [NP][LDM]
  static constexpr int S = Bm + NP * LDM;        // the carry; P in stage 3
  static constexpr int St = S + NP * LDN;        // S' (float32 only)
  static constexpr int SA = St + (F64 ? 0 : NP * LDN);
  static constexpr int BtSt = SA + NP * LDN;     // (B'S)' = S'B, [NP][LDM]
  static constexpr int WA = BtSt + NP * LDM;
  static constexpr int KA = WA + MP * NA;
  static constexpr int GA = KA + MP * NA;
  static constexpr int Ht = GA + MP * NA;        // H', [MP][LDM]
  // Each solver warp's L, packed, in the buffer of S'B (dead in stage 3)
  // where it fits.
  static constexpr int LWARP = up(M * (M + 1) / 2, 4);
  static constexpr bool L_IN_BTST = SOLVERS * LWARP <= NP * LDM;
  static constexpr int L = L_IN_BTST ? BtSt : Ht + MP * LDM;
  static constexpr int invd = Ht + MP * LDM + (L_IN_BTST ? 0 : SOLVERS * LWARP);
  static constexpr int s = invd + SOLVERS * MP;  // SOLVERS x [MP], then s
  static constexpr int ys = s + NP;
  static constexpr int scal = ys + NP;   // reg, dv1, dv2 (not in registers)
  static constexpr int STAGE = up(scal + 4, 128 / (int)sizeof(T));
  // The ring: input k of a step at sin(k) of its slot, on 128 bytes.
  // Batch-first: room for the 16-byte aligned superset of the lane's block;
  // batch-last: a box of BOX lanes (16 bytes of them), the lane's value of
  // element e at e * BOX + its place in the box.
  static constexpr int BOX = LAYOUT == BATCH_LAST ? VEC : 1;
  __host__ __device__ static constexpr int sreg(int k) {
    return up(LAYOUT == BATCH_FIRST ? E(k) + 2 * VEC : E(k) * BOX, 128 / (int)sizeof(T));
  }
  __host__ __device__ static constexpr int sin(int k) {
    int at = 0;
    for (int q = 0; q < k; ++q) at += sreg(q);
    return at;
  }
  static constexpr int SLOT = sin(NIN);
  static constexpr int ELEMS = STAGE + (STAGED ? RING * SLOT : 0);
  static constexpr int BAR = ELEMS * (int)sizeof(T);   // byte offset of the mbarriers
  static constexpr int BYTES = BAR + (STAGED ? 8 * RING : 0);
  static constexpr bool FITS = BYTES <= kMaxSharedBytes;
  // Blocks an SM the launch bounds ask for: two batch-first where shared
  // memory allows and the registers suffice (batch-last takes TMA boxes at
  // one block an SM, below).
  static constexpr int MINB =
      LAYOUT == BATCH_FIRST && BYTES <= kTwoBlockBytes && M <= (F64 ? 16 : 24) ? 2 : 1;
  // Batch-last TMA moves BOX lanes' values: its expected bytes a step.
  static constexpr uint32_t BOX_BYTES = (uint32_t)(E(0) + E(1) + E(2) + E(3) + E(4) + E(5) + E(6)) * BOX * sizeof(T);

  static_assert(0 < N && N <= kMaxN && 0 < M && M <= kMaxM,
                "the plan serves n <= 64 and m <= 32");
  static_assert(CW <= 32 && M <= 32, "a lane a column of [G | g], a row of H");
  static_assert(A % 4 == 0 && Bm % 4 == 0 && S % 4 == 0 && St % 4 == 0 && SA % 4 == 0 &&
                    BtSt % 4 == 0 && WA % 4 == 0 && KA % 4 == 0 && GA % 4 == 0 &&
                    Ht % 4 == 0 && L % 4 == 0 && invd % 4 == 0 && s % 4 == 0 &&
                    ys % 4 == 0 && scal % 4 == 0 && BAR % 8 == 0,
                "regions on 16 bytes");
};

// The copy path of a layout: the staging ring where it fits (batch-first,
// where it also costs no block an SM), else registers.  Batch-last, the
// registers' loads (a 32-byte sector a value) cost more than the second
// block: TMA boxes at one block an SM ran (36, 18) float32 1.12 times as
// fast as the registers at two (1.46 times at B = 64; PERF.md).
template <typename T, int N, int M, int LAYOUT> struct Policy {
  using Staged = Plan<T, N, M, LAYOUT, true>;
  using Prefetch = Plan<T, N, M, LAYOUT, false>;
  static constexpr bool STAGED =
      Staged::FITS && (LAYOUT == BATCH_LAST || Staged::MINB >= Prefetch::MINB);
  using Default = typename std::conditional<STAGED, Staged, Prefetch>::type;
};

// c[r][q] += sum_{k < KD} a(i0 + r, k) b(k, j0 + q) for the RT x 4 tile at
// (i0, j0), RT = 1, 2 or 4: the left factor k-major (at[k * lda + i] =
// a(i, k)), the right one row-major (b[k * ldb + j]); every thread of a warp
// reads row k of both at the same k, so the loads are free of bank
// conflicts whatever the strides.  Each entry is summed in the order of k
// whatever RT is.
template <typename T, int RT, int KD>
__device__ __forceinline__ void tile_acc(const T* at, int lda, const T* b, int ldb,
                                         int i0, int j0, T (&c)[RT][4]) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    T a[RT], bb[4];
    ldr<T, RT>(at + k * lda + i0, a);
    ld4(b + k * ldb + j0, bb);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) c[r][q] += a[r] * bb[q];
    }
  }
}

// The RT x 4 tile `job` of a result with J columns (row-major over the
// tiles): its first row and column.
template <int RT, int J>
__device__ __forceinline__ void tile_at(int job, int& i0, int& j0) {
  i0 = (job / (J / 4)) * RT;
  j0 = (job % (J / 4)) * 4;
}

// One 8-row strip of C += A B (TJ tiles of 8 x 8) on the FP64 tensor core,
// by a whole warp, the sum over KD (a multiple of 4): A k-major
// (a[k * lda + i]) if KMAJOR, else row-major (a[i * lda + k]); B row-major.
// The TJ products of a step of k are independent, and each tile is summed
// in the order of k as a tile alone would be.  The thread's entries, at
// row i = strip * 8 + lane / 4 and columns 8 tj + 2 (lane % 4) + {0, 1},
// come in as their first terms d[tj] and go out as the sums.
template <bool KMAJOR, int TJ, int KD>
__device__ __forceinline__ void strip_mma(int strip, const double* a, int lda,
                                          const double* b, int ldb, double (&d)[TJ][2],
                                          int wl) {
  const int g = wl >> 2, q = wl & 3;
  const int i = strip * 8 + g;
#pragma unroll 2
  for (int k0 = 0; k0 < KD; k0 += 4) {
    const double av = KMAJOR ? a[(k0 + q) * lda + i] : a[i * lda + k0 + q];
#pragma unroll
    for (int tj = 0; tj < TJ; ++tj)
      mma_f64(d[tj][0], d[tj][1], av, b[(k0 + q) * ldb + tj * 8 + g]);
  }
}

template <typename T, int N, int M, int LAYOUT, bool STAGED>
__global__ void __launch_bounds__(NT, (Plan<T, N, M, LAYOUT, STAGED>::MINB))
riccati_xl_kernel(const __grid_constant__ Maps maps, const Args<T> args, int T_steps,
                  long long B, int symmetrize) {
  using P = Plan<T, N, M, LAYOUT, STAGED>;
  static_assert(P::FITS, "the lane does not fit a block");
  constexpr bool F64 = P::F64;
  constexpr int NP = P::NP, MP = P::MP, LDN = P::LDN, LDM = P::LDM, NA = P::NA;
  constexpr int SOLVERS = P::SOLVERS, SOLVER_THREADS = P::SOLVER_THREADS;
  constexpr int PACKERS = P::PACKERS, CW = P::CW, TJ = P::TJ;
  constexpr int RB = P::RB, RS = P::RS, RG = P::RG, RH = P::RH, RP = P::RP, RW = P::RW;
  constexpr int BOX = P::BOX;
  unsigned char* raw = smem_base();
  T* smem = reinterpret_cast<T*>(raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + P::BAR);

  // The thread, its warp and lane, the lane of the batch and its place in
  // a batch-last TMA box (which starts on 16 bytes of lanes): taken anew
  // (opaque) at every step, so that the indices derived from them are too.
  int tid = threadIdx.x;
  int warp = tid / 32, wl = tid % 32;
  long long b = blockIdx.x;
  int in_box = (int)(b % BOX);

  T* const A = smem + P::A;
  T* const Bm = smem + P::Bm;
  T* const S = smem + P::S;
  T* const St = F64 ? nullptr : smem + P::St;
  T* const SA = smem + P::SA;
  T* const BtSt = smem + P::BtSt;
  T* const WA = smem + P::WA;
  T* const KA = smem + P::KA;
  T* const GA = smem + P::GA;
  T* const Ht = smem + P::Ht;
  T* const sv = smem + P::s;
  T* const ys = smem + P::ys;
  // The lane's reg and its dv1, dv2 sums (thread NT - 1's), in shared
  // memory rather than in registers held across the step loop.
  T* const scal = smem + P::scal;

  // The 16-byte granule offset of lane b's block of input k at step t
  // (batch-first bulk copies only), in values.
  auto shift = [&](int k, int t) -> int {
    return STAGED && LAYOUT == BATCH_FIRST
               ? (int)((((long long)b * T_steps + t) * P::E(k)) % P::VEC)
               : 0;
  };
  // Value (i, j) of input k (a compile-time In<k>) at step t, zero past its
  // logical shape: staged, from iteration it's slot; else from device memory
  // where it lies.
  auto input = [&](auto kc, int t, int it, int i, int j) -> T {
    constexpr int k = decltype(kc)::value;
    if (i >= P::d1(k) || j >= P::d2(k)) return T(0);
    const int e = i * P::d2(k) + j;
    if constexpr (STAGED) {
      const T* slot = smem + P::STAGE + (it % RING) * P::SLOT + P::sin(k);
      return LAYOUT == BATCH_FIRST ? slot[shift(k, t) + e] : slot[e * BOX + in_box];
    } else {
      return LAYOUT == BATCH_LAST
                 ? args.in[k][((long long)t * P::E(k) + e) * B + b]
                 : args.in[k][((long long)b * T_steps + t) * P::E(k) + e];
    }
  };
  // Staged: bring iteration it (step T-1-it) into its slot, from thread
  // PRODUCER, completing on the slot's mbarrier.
  auto issue = [&](int it) {
    const int t = T_steps - 1 - it;
    const int r = it % RING;
    T* slot = smem + P::STAGE + r * P::SLOT;
    async_proxy_fence();
    if constexpr (LAYOUT == BATCH_FIRST) {
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
      mbar_arrive_expect_tx(&full[r], P::BOX_BYTES);
#pragma unroll
      for (int k = 0; k < NIN; ++k)
        tma_load(slot + P::sin(k), &maps.m[k], (int)(b - in_box), 0, 0, t, &full[r]);
    }
  };
  // Iteration it's A and B into their padded buffers, by threads lt of
  // `count` (only logical entries: the pad stays zero).
  auto load_AB = [&](int it, int lt, int count) {
    const int t = T_steps - 1 - it;
#pragma unroll 4
    for (int e = lt; e < N * N; e += count) A[(e / N) * LDN + e % N] = input(In<0>(), t, it, e / N, e % N);
#pragma unroll 4
    for (int e = lt; e < N * M; e += count) Bm[(e / M) * LDM + e % M] = input(In<1>(), t, it, e / M, e % M);
  };

  // The jobs of the stages, the same every step.  Stage 1: S'B tiles, then
  // the rows of g and ys, then S A (float32 tiles, float64 strips).
  constexpr int BT_J = (NP / RB) * (MP / 4);
  constexpr int O1B = whole_warps(BT_J), O1V = O1B + whole_warps(M + N);
  constexpr int SA_J = F64 ? TJ * 32 : (NP / RS) * (NP / 4);
  constexpr int O1S = O1V + whole_warps(SA_J);
  // Stage 2: G tiles, H tiles, then P where it is formed there.
  constexpr int G_J = (MP / RG) * (NP / 4), H_J = (MP / RH) * (MP / 4);
  constexpr int PT_J = (NP / RP) * (NP / 4);   // float32 P tiles
  constexpr int O2G = whole_warps(G_J), O2H = O2G + whole_warps(H_J);
  constexpr int O2P = O2H + (!P::P_IN_G_H ? 0 : F64 ? TJ * 32 : whole_warps(PT_J));
  // f(u, In<k>, i, j) for each first term u of P's job pj (a float32 tile,
  // a float64 strip): Qxx, input 4.
  auto visit_P = [&](int pj, auto&& f) {
    if constexpr (F64) {
      const int i = pj * 8 + (wl >> 2);
#pragma unroll
      for (int tj = 0; tj < TJ; ++tj) {
#pragma unroll
        for (int q = 0; q < 2; ++q) f(tj * 2 + q, In<4>(), i, tj * 8 + 2 * (wl & 3) + q);
      }
    } else {
      int i0, j0;
      tile_at<RP, NP>(pj, i0, j0);
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
#pragma unroll
        for (int q = 0; q < 4; ++q) f(rr * 4 + q, In<4>(), i0 + rr, j0 + q);
      }
    }
  };
  // The same for round r of stage 1 (ru or qx: one value) and of stage 2.
  auto visit1 = [&](int r, auto&& f) {
    const int v = tid + r * NT - O1B;
    if (v >= 0 && v < M + N) {
      if (v < M) f(0, In<3>(), 0, v); else f(0, In<2>(), 0, v - M);
    }
  };
  auto visit2 = [&](int r, auto&& f) {
    const int job = tid + r * NT;
    int i0, j0;
    if (job < G_J) {
      tile_at<RG, NP>(job, i0, j0);
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
#pragma unroll
        for (int q = 0; q < 4; ++q) f(rr * 4 + q, In<5>(), i0 + rr, j0 + q);
      }
    } else if (job >= O2G && job - O2G < H_J) {
      tile_at<RH, MP>(job - O2G, i0, j0);
#pragma unroll
      for (int rr = 0; rr < RH; ++rr) {
#pragma unroll
        for (int q = 0; q < 4; ++q) f(rr * 4 + q, In<6>(), i0 + rr, j0 + q);
      }
    } else if (job >= O2H && job < O2P) {
      if (F64 || job - O2H < PT_J) visit_P(F64 ? (job - O2H) / 32 : job - O2H, f);
    }
  };
  auto visit3 = [&](int r, auto&& f) {
    const int lt = tid - SOLVER_THREADS;
    if (lt >= 0 && lt + r * PACKERS < PT_J) visit_P(lt + r * PACKERS, f);
  };
  // Prefetch: the first terms of this thread's jobs of a step, loaded into
  // registers during the step before: those of stage 1 as it enters its
  // value update, the others as it leaves it (so that they are not live
  // across the value update's tiles).
  T pf1[P::R1], pf2[P::R2][P::FT2], pf3[P::R3 > 0 ? P::R3 : 1][P::FTP];
  auto prefetch1 = [&](int t, int it) {
#pragma unroll
    for (int r = 0; r < P::R1; ++r)
      visit1(r, [&](int, auto kc, int i, int j) { pf1[r] = input(kc, t, it, i, j); });
  };
  auto prefetch = [&](int t, int it) {
#pragma unroll
    for (int r = 0; r < P::R2; ++r)
      visit2(r, [&](int u, auto kc, int i, int j) { pf2[r][u] = input(kc, t, it, i, j); });
#pragma unroll
    for (int r = 0; r < P::R3; ++r)
      visit3(r, [&](int u, auto kc, int i, int j) { pf3[r][u] = input(kc, t, it, i, j); });
  };
  // P = Qxx + A'(SA) into the buffer of S, job pj, from its first terms.
  auto form_P = [&](int pj, const T (&c0)[P::FTP]) {
    if constexpr (F64) {
      double d[TJ][2];
#pragma unroll
      for (int tj = 0; tj < TJ; ++tj) {
        d[tj][0] = c0[2 * tj];
        d[tj][1] = c0[2 * tj + 1];
      }
      strip_mma<true, TJ, up(N, 4)>(pj, A, LDN, SA, LDN, d, wl);
      const int i = pj * 8 + (wl >> 2);
#pragma unroll
      for (int tj = 0; tj < TJ; ++tj) {
        const int j = tj * 8 + 2 * (wl & 3);
        S[i * LDN + j] = d[tj][0];
        S[i * LDN + j + 1] = d[tj][1];
      }
    } else {
      int i0, j0;
      tile_at<RP, NP>(pj, i0, j0);
      T c[RP][4];
#pragma unroll
      for (int rr = 0; rr < RP; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q) c[rr][q] = c0[rr * 4 + q];
      tile_acc<T, RP, N>(A, LDN, SA, LDN, i0, j0, c);
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) st4(S + (i0 + rr) * LDN + j0, c[rr]);
    }
  };

  for (int i = tid; i < P::STAGE; i += NT) smem[i] = T(0);
  if constexpr (STAGED) {
    if (tid == 0) {
      for (int r = 0; r < RING; ++r) mbar_init(&full[r], 1);
    }
    mbar_init_fence();
  }
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
  if (T_steps > 0) {
    if constexpr (STAGED) {
      if (tid == P::PRODUCER) {
        for (int it = 0; it + 1 < RING && it < T_steps; ++it) issue(it);
      }
      mbar_wait(&full[0], 0);
    } else {
      prefetch1(T_steps - 1, 0);
      prefetch(T_steps - 1, 0);
    }
    load_AB(0, tid, NT);
  }
  if (tid == 0) scal[0] = args.reg[b];
  const T half = T(0.5);
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
    const bool next = it + 1 < T_steps;
    tid = opaque(tid);
    warp = tid / 32;
    wl = tid % 32;
    b = opaque(b);
    in_box = (int)(b % BOX);
#ifdef RICCATI_STAGE_CLOCKS
    c_prev = clock_now();
#endif
    if constexpr (STAGED) {
      // Iteration it + RING - 1 into the slot iteration it - 1 left (its
      // last readers passed the block barrier that ended it); then this
      // step's slot, landed, for every reader.
      if (tid == P::PRODUCER && it + RING - 1 < T_steps) issue(it + RING - 1);
      mbar_wait(&full[it % RING], (uint32_t)((it / RING) & 1));
    }
    // The first term u of this thread's job in round r of a stage: from the
    // slot, or from the registers that carry it.
    auto first = [&](auto& pf, int r, int u, auto kc, int i, int j) -> T {
      if constexpr (STAGED) return input(kc, t, it, i, j);
      else return pf[r][u];
    };

    // 1. BtSt = S'B;  g = ru + B's (column NP of GA);  ys = qx + A's;
    //    SA = S A (S' is S once symmetrized).
#pragma unroll
    for (int r = 0; r < P::R1; ++r) {
      const int job = tid + r * NT;
      if (job < O1B) {
        if (job < BT_J) {
          int i0, j0;
          tile_at<RB, MP>(job, i0, j0);
          T c[RB][4] = {};
          tile_acc<T, RB, N>(S, LDN, Bm, LDM, i0, j0, c);
#pragma unroll
          for (int rr = 0; rr < RB; ++rr) st4(BtSt + (i0 + rr) * LDM + j0, c[rr]);
        }
      } else if (job < O1V) {
        const int v = job - O1B;
        if (v < M + N) {
          T acc = T(0);
          visit1(r, [&](int, auto kc, int i, int j) {
            if constexpr (STAGED) acc = input(kc, t, it, i, j);
            else acc = pf1[r];
          });
          // g: ru (input 3) + B's; ys: qx (input 2) + A's.
          const int i = v < M ? v : v - M;
          const T* col = v < M ? Bm + i : A + i;
          const int ld = v < M ? LDM : LDN;
#pragma unroll 4
          for (int q = 0; q < N; ++q) acc += col[q * ld] * sv[q];
          if (v < M) GA[i * NA + NP] = acc; else ys[i] = acc;
        }
      } else if (job < O1S) {
        const int sa = job - O1V;
        if constexpr (F64) {
          double d[TJ][2] = {};
          strip_mma<false, TJ, up(N, 4)>(sa / 32, S, LDN, A, LDN, d, wl);
          const int i = (sa / 32) * 8 + (wl >> 2);
#pragma unroll
          for (int tj = 0; tj < TJ; ++tj) {
            const int j = tj * 8 + 2 * (wl & 3);
            SA[i * LDN + j] = d[tj][0];
            SA[i * LDN + j + 1] = d[tj][1];
          }
        } else if (sa < SA_J) {
          const T* Sl = symmetrize && it > 0 ? S : St;
          int i0, j0;
          tile_at<RS, NP>(sa, i0, j0);
          T c[RS][4] = {};
          tile_acc<T, RS, N>(Sl, LDN, A, LDN, i0, j0, c);
#pragma unroll
          for (int rr = 0; rr < RS; ++rr) st4(SA + (i0 + rr) * LDN + j0, c[rr]);
        }
      }
    }
    block_sync();
    tick(0);

    // 2. G = Pux + BtS A (into GA);  Ht = (Ruu + BtS B)';  P = Qxx + A'(SA)
    //    into the buffer of S, where it is formed here.
#pragma unroll
    for (int r = 0; r < P::R2; ++r) {
      const int job = tid + r * NT;
      T c0[P::FT2];
      visit2(r, [&](int u, auto kc, int i, int j) { c0[u] = first(pf2, r, u, kc, i, j); });
      int i0, j0;
      if (job < G_J) {
        tile_at<RG, NP>(job, i0, j0);
        T c[RG][4];
#pragma unroll
        for (int rr = 0; rr < RG; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) c[rr][q] = c0[rr * 4 + q];
        tile_acc<T, RG, N>(BtSt, LDM, A, LDN, i0, j0, c);
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) st4(GA + (i0 + rr) * NA + j0, c[rr]);
      } else if (job >= O2G && job - O2G < H_J) {
        tile_at<RH, MP>(job - O2G, i0, j0);
        T c[RH][4];
#pragma unroll
        for (int rr = 0; rr < RH; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) c[rr][q] = c0[rr * 4 + q];
        tile_acc<T, RH, N>(BtSt, LDM, Bm, LDM, i0, j0, c);
#pragma unroll
        for (int rr = 0; rr < RH; ++rr)
#pragma unroll
          for (int q = 0; q < 4; ++q) Ht[(j0 + q) * LDM + i0 + rr] = c[rr][q];
      } else if (job >= O2H && job < O2P && (F64 || job - O2H < PT_J)) {
        T cp[P::FTP];
#pragma unroll
        for (int u = 0; u < P::FTP; ++u) cp[u] = c0[u];
        form_P(F64 ? (job - O2H) / 32 : job - O2H, cp);
      }
    }
    block_sync();
    tick(1);

    // 3. The solver warps: the gains.  The packer warps: P where it is
    //    formed here, then the next step's A and B.
    if (warp < SOLVERS) {
      T* const Lw = smem + P::L + warp * P::LWARP;   // L(i, j) at i (i + 1) / 2 + j
      T* const iw = smem + P::invd + warp * MP;
      // Cholesky of H + reg I, lane i holding row i (a[k] = H(i, k) =
      // Ht(k, i); lanes past M hold a copy of row 0, never read):
      // right-looking, one rsqrt a pivot, L_jj = piv * rsqrt(piv), the pivot
      // and column j of L broadcast by __shfl_sync, the subtractions of every
      // entry in the reference's order (j = 0, 1, ...).  Entries right of
      // the diagonal are computed and never read.  Lane j + 1 forms its next
      // pivot from its own L(j + 1, j) (d, the same multiply-add as its
      // update by the broadcast value), so that the pivot's chain waits for
      // one shuffle a column, not two.
      {
        const int row = wl < M ? wl : 0;
        T a[M];
#pragma unroll
        for (int k = 0; k < M; ++k) {
          a[k] = Ht[k * LDM + row];
          if (k == wl) a[k] += scal[0];
        }
        T d = a[0];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const T r = rsqrt_<T>(shfl(d, j));
          a[j] *= r;
          if (wl == 0) iw[j] = r;
          if (j + 1 < M) {
            d = a[j + 1];
            d -= a[j] * a[j];
          }
#pragma unroll
          for (int k = j + 1; k < M; ++k) a[k] -= a[j] * shfl(a[j], k);
        }
        if (wl < M) {
#pragma unroll
          for (int k = 0; k < M; ++k)
            if (k <= wl) Lw[wl * (wl + 1) / 2 + k] = a[k];
        }
        warp_sync();
      }
      tick(2);
      // [K | duff] = -(H + reg I)^-1 [G | g], column c by one thread, with
      // the reference's order: x = L^-1 b, then x = L^-T x, multiplying by
      // the reciprocal pivots.  Every lane of the solver warps runs the
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
          for (int j = 0; j < i; ++j) acc -= Lw[i * (i + 1) / 2 + j] * x[j];
          x[i] = acc * iw[i];
          if (i % WIN == WIN - 1) warp_sync();
        }
#pragma unroll
        for (int i = M - 1; i >= 0; --i) {
          T acc = x[i];
#pragma unroll
          for (int j = i + 1; j < M; ++j) acc -= Lw[j * (j + 1) / 2 + i] * x[j];
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
      // H duff, with the raw H (k-major: Ht).
#pragma unroll
      for (int r = 0; r < P::RWR; ++r) {
        const int job = tid + r * SOLVER_THREADS;
        if (job < (MP / RW) * (NA / 4)) {
          int i0, c4;
          tile_at<RW, NA>(job, i0, c4);
          T w[RW][4];
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) {
            if (c4 < NP) {
              ld4(GA + (i0 + rr) * NA + c4, w[rr]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) w[rr][q] = T(0);
            }
          }
          tile_acc<T, RW, M>(Ht, LDM, KA, NA, i0, c4, w);
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) st4(WA + (i0 + rr) * NA + c4, w[rr]);
        }
      }
      tick(4);
    } else {
      const int lt = tid - SOLVER_THREADS;
#pragma unroll
      for (int r = 0; r < P::R3; ++r) {
        const int pj = lt + r * PACKERS;
        if (pj < PT_J) {
          T cp[P::FTP];
          visit3(r, [&](int u, auto kc, int i, int j) { cp[u] = first(pf3, r, u, kc, i, j); });
          form_P(pj, cp);
        }
      }
      if (next) {
        if constexpr (STAGED) mbar_wait(&full[(it + 1) % RING], (uint32_t)(((it + 1) / RING) & 1));
        if constexpr (!P::P_IN_G_H) group_sync(BAR_PACKERS, PACKERS);   // every packer done with A
        load_AB(it + 1, lt, PACKERS);
      }
    }
    block_sync();
    tick(5);

    // 4. S = P + K'W + G'K by VB x VB blocks (i-block <= j-block) and their
    //    mirrors, written symmetrized (and transposed in float32 when not);
    //    s = ys + K'(H duff + g) + G'duff;  dv1, dv2.  Around it the next
    //    step's first terms set off to the registers.
    if constexpr (!STAGED) {
      if (next) prefetch1(t - 1, it + 1);
    }
    {
      constexpr int VB = P::VB;
      constexpr int NB = (N + VB - 1) / VB;
      constexpr int PAIRS = NB * (NB + 1) / 2;
      constexpr int O1 = whole_warps(PAIRS);
#pragma unroll
      for (int r = 0; r < P::R4; ++r) {
        const int job = tid + r * NT;
        if (job < PAIRS) {
          int I = 0, rest = job;
          while (rest >= NB - I) {
            rest -= NB - I;
            ++I;
          }
          const int i0 = VB * I, j0 = VB * (I + rest);
          T sn[VB][VB], sm[VB][VB];   // Sn(i0 + r, j0 + q) and Sn(j0 + q, i0 + r)
#pragma unroll
          for (int rr = 0; rr < VB; ++rr) {
#pragma unroll
            for (int q = 0; q < VB; ++q) {
              sn[rr][q] = S[(i0 + rr) * LDN + j0 + q];
              sm[rr][q] = S[(j0 + q) * LDN + i0 + rr];
            }
          }
#pragma unroll 2
          for (int a = 0; a < M; ++a) {
            T ki[VB], kj[VB], wi[VB], wj[VB];
            ldr<T, VB>(KA + a * NA + i0, ki);
            ldr<T, VB>(KA + a * NA + j0, kj);
            ldr<T, VB>(WA + a * NA + i0, wi);
            ldr<T, VB>(WA + a * NA + j0, wj);
#pragma unroll
            for (int rr = 0; rr < VB; ++rr) {
#pragma unroll
              for (int q = 0; q < VB; ++q) {
                sn[rr][q] += ki[rr] * wj[q];
                sm[rr][q] += kj[q] * wi[rr];
              }
            }
          }
#pragma unroll 2
          for (int a = 0; a < M; ++a) {
            T gi[VB], gj[VB], ki[VB], kj[VB];
            ldr<T, VB>(GA + a * NA + i0, gi);
            ldr<T, VB>(GA + a * NA + j0, gj);
            ldr<T, VB>(KA + a * NA + i0, ki);
            ldr<T, VB>(KA + a * NA + j0, kj);
#pragma unroll
            for (int rr = 0; rr < VB; ++rr) {
#pragma unroll
              for (int q = 0; q < VB; ++q) {
                sn[rr][q] += gi[rr] * kj[q];
                sm[rr][q] += gj[q] * ki[rr];
              }
            }
          }
#pragma unroll
          for (int rr = 0; rr < VB; ++rr) {
#pragma unroll
            for (int q = 0; q < VB; ++q) {
              const int i = i0 + rr, j = j0 + q;
              const T vij = symmetrize ? half * (sn[rr][q] + sm[rr][q]) : sn[rr][q];
              const T vji = symmetrize ? vij : sm[rr][q];
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
        } else if (job >= O1 && job < O1 + N) {
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
        scal[1] += dg;
        scal[2] += half * dHd;
      }
    }
    if constexpr (!STAGED) {
      if (next) prefetch(t - 1, it + 1);
    }
    block_sync();
    tick(6);
  }

  if (tid == NT - 1) {
    args.dv1[b] = scal[1];
    args.dv2[b] = scal[2];
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

template <typename T>
using Kernel = void (*)(const Maps, const Args<T>, int, long long, int);

// The kernel of a layout and copy path, its shared memory allowed (past
// 48 KB only by this attribute) and the carveout set to the most shared
// memory, so that two blocks fit an SM where the plan allows.
template <typename T, int N, int M, int LAYOUT, bool STAGED>
cudaError_t prepare(Kernel<T>* out, int* bytes) {
  using P = Plan<T, N, M, LAYOUT, STAGED>;
  Kernel<T> kernel = riccati_xl_kernel<T, N, M, LAYOUT, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  *out = kernel;
  *bytes = P::BYTES;
  return cudaSuccess;
}

// The kernel a layout takes when its inputs allow the policy's path.
template <typename T, int N, int M>
cudaError_t prepare_default(int layout, Kernel<T>* out, int* bytes) {
  return layout == BATCH_LAST
             ? prepare<T, N, M, BATCH_LAST, Policy<T, N, M, BATCH_LAST>::STAGED>(out, bytes)
             : prepare<T, N, M, BATCH_FIRST, Policy<T, N, M, BATCH_FIRST>::STAGED>(out, bytes);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; it is taken through the
// runtime, so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The batch-last tensor map of input k (a d1 x d2 matrix a step): dims
// (B, d2, d1, T), a box of one step of BOX lanes (16 bytes of them).
template <typename T, int N, int M>
bool encode(CUtensorMap* map, int k, const void* base, int T_steps, long long B) {
  using P = Plan<T, N, M, BATCH_LAST, true>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t s = sizeof(T), d1 = P::d1(k), d2 = P::d2(k);
  const cuuint64_t Bu = (cuuint64_t)B;
  const cuuint64_t dims[4] = {Bu, d2, d1, (cuuint64_t)T_steps};
  const cuuint64_t strides[3] = {Bu * s, d2 * Bu * s, d1 * d2 * Bu * s};
  const cuuint32_t box[4] = {(cuuint32_t)P::BOX, (cuuint32_t)d2, (cuuint32_t)d1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int N, int M>
int launch(const void* const* in, const void* qxN, const void* QN, const void* reg,
           void* duffs, void* Ks, void* dv1, void* dv2, int T_steps, long long B,
           int symmetrize, int layout, int* path, void* clocks, void* stream) {
#ifndef RICCATI_STAGE_CLOCKS
  if (clocks != nullptr) return (int)cudaErrorInvalidValue;
#endif
  // One block a lane: the grid's x dimension holds 2^31 - 1 blocks (and TMA
  // coordinates are 32-bit).
  if (B <= 0 || B > 0x7fffffffLL || T_steps < 0 ||
      (layout != BATCH_LAST && layout != BATCH_FIRST))
    return (int)cudaErrorInvalidValue;
  bool aligned = true;
  for (int k = 0; k < NIN; ++k)
    if (reinterpret_cast<uintptr_t>(in[k]) % 16 != 0) aligned = false;
  Kernel<T> kernel = nullptr;
  int bytes = 0;
  Maps maps = {};
  int taken = kPathPrefetch;
  cudaError_t err;
  if (layout == BATCH_FIRST) {
    constexpr bool staged = Policy<T, N, M, BATCH_FIRST>::STAGED;
    // Bulk copies: every input must start on 16 bytes.
    if (staged && !aligned) return (int)cudaErrorMisalignedAddress;
    if (staged) taken = kPathTma;
    err = prepare<T, N, M, BATCH_FIRST, staged>(&kernel, &bytes);
  } else {
    // TMA takes the inputs when each starts on 16 bytes and a row of B
    // lanes is whole 16-byte granules; else the registers carry them.
    const bool tma = Policy<T, N, M, BATCH_LAST>::STAGED && T_steps > 0 && aligned &&
                     (B * (long long)sizeof(T)) % 16 == 0;
    if (tma) {
      for (int k = 0; k < NIN; ++k)
        if (!encode<T, N, M>(&maps.m[k], k, in[k], T_steps, B))
          return (int)cudaErrorInvalidValue;
      taken = kPathTma;
      err = prepare<T, N, M, BATCH_LAST, Policy<T, N, M, BATCH_LAST>::STAGED>(&kernel, &bytes);
    } else {
      err = prepare<T, N, M, BATCH_LAST, false>(&kernel, &bytes);
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (path != nullptr) *path = taken;
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
  kernel<<<dim3((unsigned)B), dim3(NT), bytes, static_cast<cudaStream_t>(stream)>>>(
      maps, args, T_steps, B, symmetrize);
  return (int)cudaGetLastError();
}

}  // namespace

#if defined(RICCATI_N) && defined(RICCATI_M) && defined(RICCATI_SCALAR)
// The one instantiation of a build (ops/_build.py), behind the generic
// launcher with the C interface of the other sources: the seven step inputs
// as an array of device pointers, then qxN, QN, reg, the four outputs, T, B,
// symmetrize (0/1), layout (0 batch-last, 1 batch-first), where to write the
// copy path taken (1: the bulk-copy or TMA engine into the staging ring,
// whose batch-first inputs must start on 16 bytes; 4: registers; may be
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
// The shared memory a block of the instantiation takes: the larger of the
// two layouts' plans (on their policy's copy path).
extern "C" int riccati_cuda_instance_shared_bytes() {
  using T = RICCATI_SCALAR;
  constexpr int bl = riccati_xl::Policy<T, RICCATI_N, RICCATI_M, 0>::Default::BYTES;
  constexpr int bf = riccati_xl::Policy<T, RICCATI_N, RICCATI_M, 1>::Default::BYTES;
  return bl > bf ? bl : bf;
}
// The blocks (lanes) of the instantiation resident on one SM of the
// current device in `layout` (on its policy's copy path), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor counts them; a negative
// cudaError_t on failure.
extern "C" int riccati_cuda_instance_blocks_per_sm(int layout) {
  using T = RICCATI_SCALAR;
  Kernel<T> kernel = nullptr;
  int bytes = 0;
  cudaError_t err = prepare_default<T, RICCATI_N, RICCATI_M>(layout, &kernel, &bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, riccati_xl::NT,
                                                        bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}
#else
#error "riccati_xl.cu has no fixed instantiation: build it with \
-DRICCATI_N, -DRICCATI_M and -DRICCATI_SCALAR (ops/_build.py)"
#endif
