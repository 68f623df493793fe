// Fused backward Riccati recursion for the shapes past riccati_xl.cu: any
// (n, m) with n > 64 or m > 32, up to n <= 128 and m <= 64, built at first
// use with -DRICCATI_N/-DRICCATI_M/-DRICCATI_SCALAR (ops/_build.py).  The
// floating-base arms with more than 26 joints need it (state 2 nv, control
// nv, nv = 6 + joints): the free-flying five-arm (models/rbd/assets/
// five_6Dof_arm.urdf) at (72, 36), and at (73, 36) under al_solve, whose
// state carries the step index; a 26-joint humanoid under al_solve at
// (65, 32).  One launch for a whole scenario batch and horizon; one lane a
// thread-block cluster of C blocks of NT = 256 threads.
//
// Replaces the same TPU kernel as the other four sources:
// ilqr_tpu/ops/pallas_riccati.py::_riccati_kernel (launched by
// _riccati_pallas_call, fed by riccati_scan_pallas_bl and, batch-first, by
// riccati_scan_pallas_batched).  It computes what that kernel computes; the
// algebra is spelled out at the top of riccati.cu (g, G, H, Cholesky of
// H + reg I with one rsqrt per pivot, duff, K, the value update with the raw
// H, the optional symmetrize, dv1, dv2), with the subtractions of the
// Cholesky and of the substitutions in the reference's order, and every
// product entry summed by one thread from its first term in the order of k.
// Two layouts, a template argument: batch-LAST (element e of lane b at step
// t at (t*E + e)*B + b) and batch-FIRST (at (b*T + t)*E + e), both read in
// place; a lane's arithmetic is the same code in both, so the two agree bit
// for bit.  float32 and float64; no TF32 anywhere (reduced-precision
// products NaN the recursion at T >= 300, ilqr_tpu/precision.py).
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores,
// 67 TFLOP/s float64 on the FP64 tensor cores): a lane and step reads
// 2n^2 + 2nm + m^2 + n + m values (16,956 at (72, 36)) and writes m + mn
// (2,628); its arithmetic is about 1.8 M multiply-adds at (72, 36)
// (chip_smoke.riccati_bound_ms counts them): bound by operations.  What holds
// a lane above it is the step's dependent chain (products, the factor, two
// substitutions of m rows, the value update), the exchange of rows between
// the blocks of a cluster and, for a kernel this size, fetching its own
// code.  The first plan of this file read both operands of every
// product term as scalars through distributed shared memory, many from a
// peer block, read the first terms and the next A and B from device memory
// where they lie, factored with the whole block behind a barrier a column,
// solved a column a thread, summed every entry of the symmetrized value
// update twice, and ran at 34 to 156 times the bound.  This plan (each
// choice timed on an H100 against a build of the source with that choice
// undone; PERF.md):
//
//  * Rows split, operands local.  Block r owns the R rows (a multiple of 4)
//    [r R, r R + R) of the n index and the RM rows [r RM, r RM + RM) of the
//    m index.  It holds, k-major (a product's operand row k at k * ld):
//      Sk  = S(own rows, :)'   and  Sc = S(:, own rows)   (the carry; Sk
//            serves both once the carry is symmetrized),
//      SAp = (S A)(:, own rows),  SBp = (S'B)(:, own rows of m),
//      Pc  = P(:, own rows),      Gp, Kp, Wp = [G | g], [K | duff],
//            [W | H duff] (:, own rows and the vector in column R),
//      Ht  = H' whole, and the whole s.
//    A and B are inputs: every block reads them whole from device memory
//    (L2 holds a lane's step for its C blocks) into a ring in shared memory
//    beside the plan.  What a product computes for a peer it stores there
//    itself, 16-byte vectors through distributed shared memory, in the
//    epilogue of its tile (S A, S'B, G, H, s, the new S); before the pairs
//    across two blocks each block copies the peer's columns of G, K, W and
//    its rows of P into a local slot, 16 bytes a thread.  No inner loop of
//    a product reads a peer's shared memory.
//  * Register tiles.  Each product entry is summed by one thread in a 4 x 4
//    tile (1 x 4 for g and qx + A's), the left factor read by broadcast,
//    the right by 16-byte vectors, from its first term in the order of k:
//    the tiles change no bit (the outputs equal the first plan's).  S A and
//    S'B share one code path (their operands picked by the job), so that
//    stage 1 is one round where the block's threads suffice.
//  * A step's inputs ahead of its chain, by one of three copy paths (the
//    launcher reports the one it took):
//      - bulk (path 7, "bulk_copy"): batch-first where n and m are multiples
//        of 4, so that KP rows of A or B are one block in device memory and
//        in a slot.  One cp.async.bulk for the rows of A and one for B,
//        completing on the slot's mbarrier: resident, the whole of the next
//        step's, issued by the first packer in stage 3; streamed, a panel
//        ahead (after the last panel, the next step's first), issued as each
//        panel starts into the slot that the barrier ending the one before
//        freed.  The launcher refuses A and B that do not start on 16 bytes
//        (the batch-first entry aligns its inputs).
//      - packers (path 5, "packer_staged"): A and B resident, read by the
//        packer warps (those that do not factor or solve) in stage 3, a
//        value a load, while the step before factors and solves.
//      - panels (path 6, "panel_stream"): A and B streamed; the first panel
//        by the packers in stage 3, each later one loaded into registers by
//        every thread while the one before is summed, then stored into the
//        other slot.  These loads are on the chain: A and B are read from
//        device memory twice a step, inside stages 1 and 2.
//    A step's first terms (Qxx of the own columns, Pux and Ruu of the own
//    rows of m, qx, ru) are read by the packers in stage 3 on every path.
//    Batch-last takes no TMA box: a box is 16 bytes of lanes, four lanes'
//    values in float32 and two in float64, so that a slot would hold that
//    many lanes' panel; beside the streamed plans (96 to 9,696 bytes left
//    of a block) none fits.  Batch-last, a value costs a 32-byte sector, and
//    the packers' loads outlast the factor and solves they hide behind
//    (the loads' wait of the stage clocks).
//  * The gains without a barrier a column.  One solver warp factors
//    H + reg I in registers, a lane a row: the pivot and column j broadcast
//    by __shfl_sync, one rsqrt a pivot, L_jj = piv * rsqrt(piv), every
//    entry's subtractions in the reference's order (j = 0, 1, ...).  Past
//    m = 32, rows 32 ... m-1 take their columns below 32 by forward
//    substitution against rows 0-31 and their trailing entries less the
//    first 32 columns' terms, in rolled loops over blocks of SB columns,
//    then the trailing columns as rows 0-31 were.  ceil((R + 1) / 32)
//    solver warps then solve the block's columns of [G | g], a lane a
//    column held in registers, L read as broadcasts (a __syncwarp every
//    row or two, so that ptxas does not hoist the loads of L and spill).
//    Every block factors its own copy: it adds nothing to the chain, where
//    a multicast of L would add an exchange.
//  * The value update by mirrored pairs.  One thread sums a VB x VB block of
//    entries (i, j) and their mirrors (j, i) once (Sn = P + K'W + G'K in both
//    orders) and writes both, symmetrized or not, into the rows' owners' Sk
//    and Sc (a peer's through distributed shared memory): the symmetrized
//    update's work is halved and S stays symmetric to the bit.  The pairs
//    in the block's own rows need nothing of a peer and run between the
//    arrive and the wait of the cluster barrier that publishes K and W; the
//    pairs across two blocks (rows of the lower block against the columns
//    of the higher one, split in two, half to each) run after.
//  * Small code.  A step's code streams through the instruction cache: the
//    first version of this plan (about 15 k instructions a kernel at
//    (72, 36)) spent up to three times its arithmetic's time fetching it.
//    Hence the rolled loops of the factor past row 32, the resident plan's
//    rounds as a rolled loop (one copy of each tile's code), K stored to
//    device memory from shared memory by a rolled loop of every thread
//    after the solves, and input addresses from one base a step.
//  * Cluster barriers a step:
//      1. S A, S'B (own rows, pushed to their column owners)   [cluster]
//      2. G = Pux + (S'B)'A, H = Ruu + (S'B)'B (own rows of m, pushed),
//         P = Qxx + A'(S A) (own columns), qx + A's, g           [cluster]
//      3. solver warps: Cholesky, [K | duff]; packer warps: the next step's
//         first terms and A, B (or the bulk copy of A and B) [block]; K
//         out; W = G + H K [block]; s pushed; dv          [cluster arrive]
//      4. pairs in the own rows [cluster wait]; for each peer: its columns
//         copied in [block], the pairs across the two blocks      [cluster]
//    and, where A and B stream, a block barrier a panel in stages 1 and 2;
//    where they come in bulk, a wait on the slot's mbarrier before a
//    step's first product (resident) or each panel (streamed).
//  * C, the blocks a lane, is the fewest of 2, 4, 8 whose plan fits a
//    block's 232,448 bytes (A and B resident where they fit, else streamed
//    in panels of the most rows of 32, 16, 8, 4 that fit): (72, 36) float32
//    C = 2 (resident), float64 C = 2 (panels of 4); (128, 64) float32 C = 4
//    (panels of 32), float64 C = 8 (panels of 8).  Plan::BYTES is the
//    arithmetic (tests/test_torch_riccati_cluster.py writes it out again).
//
// Measured on an H100 (PERF.md, section 6; chip_smoke.py --cluster-times
// times this plan beside an older tree's in one call): 1.45 to 5.4 times as
// fast as the first plan, with the same bits in both types (the five-arm's
// launch, B = 64, T = 50, from 7.44 to 1.74 ms); 8 to 37 times the bound
// batch-first and 10 to 47 batch-last (55 to 59 at (20, 40), whose step is
// its factor and substitutions).  The bulk copies made the batch-first
// rows they serve 6 to 14 % faster than the packers' loads had (level at
// (20, 40); --cluster-times in a call before them and one after).  What
// is left: that chain (a third of a step at (72, 36)), batch-last the
// loads of A and B (a 32-byte sector a value; streamed, on the chain), and
// at C = 4 and 8 the pairs across blocks (a copy a peer).
//
// The limits: n <= 128, m <= 64 and a block's shared memory (static_asserts
// below; cuda_riccati.route refuses a larger shape before any nvcc run).
//
// Built with -DRICCATI_STAGE_CLOCKS (a second library, never on the main
// path) thread 0 of block 0 of each cluster (solver warp 0) adds the
// clock64() cycles of each stage of a step into a buffer of [B, kStages]
// counters.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace riccati_cluster {

constexpr int NT = 256;                    // threads a block
constexpr int NIN = 7;                     // A, B, qx, ru, Qxx, Pux, Ruu
constexpr int kMaxSharedBytes = 232448;    // what a Hopper block may use
constexpr int kMaxN = 128, kMaxM = 64;
constexpr int kStages = 8;                 // see STAGES in cuda_riccati.py
constexpr int SB = 8;                      // rows a block of the factor past 32
// Named barrier of the solver warps (0 is __syncthreads).
constexpr int BAR_SOLVERS = 1;
// The copy paths the launcher reports (cuda_riccati.COPY_PATHS): the next
// step's first terms and its whole A and B staged in shared memory by the
// packer warps, or A and B streamed in panels through registers; or A and B
// by the bulk-copy engine into the ring (batch-first, rows without a pad),
// the first terms by the packer warps.
constexpr int kPathPackers = 5, kPathPanels = 6;
constexpr int kPathBulk = 7;
// What the launcher returns when no cluster of the plan fits on the card
// (past every cudaError_t).
constexpr int kNoClusterFits = 10000;

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

// The block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() { return (int)cg::this_cluster().block_rank(); }

// The same place as `p` in block q's shared memory (a generic address
// through distributed shared memory; `p` itself for q = this block).  The
// rank goes through opaque() (below), so that the address is formed where
// it is used instead of being hoisted out of the step loop and held (with
// C peers and several buffers, that spilled).
__device__ __forceinline__ int opaque(int x);
template <typename T>
__device__ __forceinline__ T* peer(T* p, int q) {
  return cg::this_cluster().map_shared_rank(p, opaque(q));
}

// The cluster barrier, whole or split: the stores to shared memory (this
// block's and its peers') before the arrive are visible after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// A read-only load from device memory (the inputs).
template <typename T>
__device__ __forceinline__ T ldg(const T* p) { return __ldg(p); }

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

// The SM's cycle counter, read where it stands: the "memory" clobber keeps
// the compiler from moving the read across a barrier (a read hoisted above
// a __syncthreads puts the wait into the next stage's count).
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// x, as a value the compiler cannot see through: the index arithmetic
// derived from it is redone where it is used, instead of being hoisted out
// of the step loop and kept live across it (which spills).
__device__ __forceinline__ int opaque(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
// ---- end of device primitives ---------------------------------------------

// Loads and stores of 2 and 4 consecutive values (8 or 16 bytes in float32;
// 16, or two of 16, in float64), at any address of shared memory, this
// block's or a peer's.
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

// RT (1, 2 or 4) consecutive values.
template <typename T, int RT>
__device__ __forceinline__ void ldr(const T* p, T (&x)[RT]) {
  if constexpr (RT == 1) {
    x[0] = p[0];
  } else if constexpr (RT == 2) {
    ld2(p, x[0], x[1]);
  } else {
    ld4(p, x);
  }
}

template <typename T, int RT>
__device__ __forceinline__ void str(T* p, const T (&x)[RT]) {
  if constexpr (RT == 1) {
    p[0] = x[0];
  } else if constexpr (RT == 2) {
    *reinterpret_cast<typename V2<T>::type*>(p) = typename V2<T>::type{x[0], x[1]};
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(x[2], x[3]);
  }
}

__host__ __device__ constexpr int up(int x, int to) { return (x + to - 1) / to * to; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int max_(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int min_(int a, int b) { return a < b ? a : b; }
// Job counts rounded up to whole warps: each warp of a stage runs one kind
// of job, so no warp serializes two code paths.
__host__ __device__ constexpr int whole_warps(int jobs) { return up(jobs, 32); }

// Input k is a d1(k) x d2(k) matrix a step (vectors are 1 x len).
template <int N, int M> __host__ __device__ constexpr int d1(int k) {
  return k == 0 || k == 1 || k == 4 ? N : k == 5 || k == 6 ? M : 1;
}
template <int N, int M> __host__ __device__ constexpr int d2(int k) {
  return k == 1 || k == 3 || k == 6 ? M : N;
}
template <int N, int M> __host__ __device__ constexpr int E(int k) { return d1<N, M>(k) * d2<N, M>(k); }

// The shared memory of one block of a cluster of C, in values of T, and the
// shape of its work.  KP_ = 0: A and B resident (one slot of all their
// rows); else streamed in panels of KP_ rows through two slots.
template <typename T, int N, int M, int C, int KP_> struct Plan {
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr bool RES = KP_ == 0;
  static constexpr int VEC = 16 / (int)sizeof(T);      // values a 16-byte vector
  static constexpr int NP = up(N, 4), MP = up(M, 4);
  // Own rows of n and of m, multiples of 4 so that no 4-column group of a
  // tile straddles two blocks; blocks past the shape own nothing.
  static constexpr int R = up(cdiv(N, C), 4), RM = up(cdiv(M, C), 4);
  static constexpr int LR = R + VEC, LRM = RM + VEC;   // row strides
  static constexpr int LG = R + 4;                     // R columns, the vector, pad
  static constexpr int LHT = MP + VEC;
  static constexpr int KP = RES ? NP : KP_;            // rows of A and B a panel
  static constexpr int NPAN = NP / KP;                 // panels a stage
  static constexpr int LASTKD = N - (NPAN - 1) * KP;   // logical rows of the last
  static constexpr int SLOTS = RES ? 1 : 2;
  static constexpr int PANEL = KP * (NP + MP);         // A rows, then B rows
  static constexpr int PE = cdiv(PANEL, NT);           // a thread's share of a panel

  // The warps of stage 3: solvers (a lane a column of [G | g]; warp 0
  // factors), then packers.
  static constexpr int SOLVERS = cdiv(R + 1, 32);
  static constexpr int SOLVER_THREADS = 32 * SOLVERS;
  static constexpr int PACKERS = NT - SOLVER_THREADS;

  // Regions (offsets in values, each a multiple of 4).
  static constexpr int Sk = 0;                        // S(own, k) at [k][il]
  static constexpr int Sc = Sk + NP * LR;             // S(k, own) at [k][jl]
  static constexpr int SAp = Sc + NP * LR;            // (S A)(k, own)
  static constexpr int Pc = SAp + NP * LR;            // P(i, own) at [i][jl]
  static constexpr int SBp = Pc + NP * LR;            // (S'B)(k, own of m)
  static constexpr int Gp = SBp + NP * LRM;           // [G | g], [MP][LG]
  static constexpr int Kp = Gp + MP * LG;             // [K | duff]
  static constexpr int Wp = Kp + MP * LG;             // [W | H duff]
  // Stage 3: H' and the factor; stage 4: a peer's G, K, W and P rows.
  static constexpr int X = Wp + MP * LG;
  static constexpr int LPK = up(M * (M + 1) / 2, 4);  // L packed, row i at i(i+1)/2
  static constexpr int Ht = X, Lpk = Ht + MP * LHT, invd = Lpk + LPK;
  static constexpr int Gs = X, Ks = Gs + MP * LG, Ws = Ks + MP * LG, Ps = Ws + MP * LG;
  static constexpr int XS = max_(MP * LHT + LPK + MP, 3 * MP * LG + R * LR);
  // The first terms of a step: Qxx(:, own), Pux(own of m, :), Ruu(own of
  // m, :), qx(own), ru.
  static constexpr int FTq = X + XS;                  // [NP][LR]
  static constexpr int FTp = FTq + NP * LR;           // [RM][NP]
  static constexpr int FTr = FTp + RM * NP;           // [RM][MP]
  static constexpr int FT1 = FTr + RM * MP;           // [R] qx, then [MP] ru
  static constexpr int FTEND = FT1 + up(R + MP, 4);
  static constexpr int sv = FTEND;                    // s, whole
  static constexpr int ys = sv + NP;                  // qx + A's, own rows
  static constexpr int scal = ys + R;                 // reg, dv1, dv2
  static constexpr int ring = scal + 4;
  static constexpr int ELEMS = ring + SLOTS * PANEL;
  // Then an mbarrier a slot (the bulk-copy path's) and the stage clocks'
  // kStages + 1 counters and a spare, in every plan, so that the stage-clock
  // build runs the same plan (a static __shared__ array of the counters
  // beside the (96, 48) float64 plan, which fills a block, failed to
  // launch).
  static constexpr int MBAR_BYTE = ELEMS * (int)sizeof(T);
  static constexpr int CLK_BYTE = MBAR_BYTE + 16;
  static constexpr int BYTES = CLK_BYTE + 8 * (kStages + 2);
  // The rows of A and B have no pad (n and m multiples of 4): a panel is
  // one block of each in device memory, batch-first, and of the slot.
  static constexpr bool DENSE = N % 4 == 0 && M % 4 == 0;
  static constexpr bool FITS = BYTES <= kMaxSharedBytes && NP % KP == 0;

  // Jobs.  Stage 1: S A tiles (R x NP, 4 x 4) and S'B tiles (R x MP), one
  // code path for both.
  static constexpr int J_SA = (R / 4) * (NP / 4), J_SB = (R / 4) * (MP / 4);
  static constexpr int ROUNDS1 = cdiv(J_SA + J_SB, NT);
  // Stage 2: G tiles (RM x NP), H tiles (RM x MP), P tiles (NP x R), then
  // 1 x 4 tiles of qx + A's (R) and g (MP), each kind on whole warps.
  static constexpr int J_G = (RM / 4) * (NP / 4), J_H = (RM / 4) * (MP / 4);
  static constexpr int J_P = (NP / 4) * (R / 4), J_V = R / 4 + MP / 4;
  static constexpr int O2G = whole_warps(J_G), O2H = O2G + whole_warps(J_H);
  static constexpr int O2P = O2H + whole_warps(J_P), O2V = O2P + whole_warps(J_V);
  static constexpr int ROUNDS2 = cdiv(O2V, NT);
  // Stage 3: W tiles (MP x (R + 4)).
  static constexpr int J_W = (MP / 4) * (LG / 4);
  static constexpr int ROUNDSW = cdiv(J_W, NT);
  // Stage 4: VB x VB pairs; 2 x 2 unless 4 x 4 takes fewer rounds.  The
  // pairs across two blocks: the lower block's R rows against the first
  // SPLIT columns of the higher one (done by the lower block) or the rest
  // (by the higher one).
  __host__ __device__ static constexpr int split(int vb) { return up(R / 2, vb); }
  __host__ __device__ static constexpr int diag(int vb) { return (R / vb) * (R / vb + 1) / 2; }
  __host__ __device__ static constexpr int cross(int vb) {
    return (R / vb) * max_(split(vb), R - split(vb)) / vb;
  }
  __host__ __device__ static constexpr int rounds4(int vb) {
    return cdiv(diag(vb), NT) + (C > 1 ? cdiv(cross(vb), NT) : 0);
  }
  static constexpr int VB = rounds4(2) <= rounds4(4) ? 2 : 4;
  static constexpr int SPLIT = split(VB);
  static constexpr int ROUNDSD = cdiv(diag(VB), NT), ROUNDSX = cdiv(cross(VB), NT);

  static_assert(0 < N && N <= kMaxN && 0 < M && M <= kMaxM,
                "the plan serves n <= 128 and m <= 64");
  static_assert(R + 1 <= 96 && M <= 64, "three solver warps, a factor of two blocks of 32");
};

// The plan of a shape and type: the fewest blocks of 2, 4, 8 whose share
// fits a block, A and B resident if they fit beside it, else streamed in
// panels of the most rows of 32, 16, 8, 4 that fit.
template <typename T, int N, int M> struct Choice {
  template <int C> static constexpr int kp() {
    return Plan<T, N, M, C, 0>::FITS    ? 0
           : Plan<T, N, M, C, 32>::FITS ? 32
           : Plan<T, N, M, C, 16>::FITS ? 16
           : Plan<T, N, M, C, 8>::FITS  ? 8
           : Plan<T, N, M, C, 4>::FITS  ? 4
                                        : -1;
  }
  static constexpr int C = kp<2>() >= 0 ? 2 : kp<4>() >= 0 ? 4 : 8;
  static constexpr int KP = kp<C>();
  static_assert(KP >= 0, "a lane's share does not fit a block of a cluster of 8");
  using P = Plan<T, N, M, C, KP < 0 ? 0 : KP>;
};

// c[r][q] += sum_{k < KD} a(i0 + r, k) b(k, j0 + q) for the RT x 4 tile at
// (i0, j0): the left factor k-major (at[k * lda + i] = a(i, k)), the right
// one row-major (b[k * ldb + j]).  Each entry is summed in the order of k.
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

// c[q] += sum_{k < KD} s[k] b(k, j0 + q): a 1 x 4 tile whose left factor is
// the vector s (broadcast).
template <typename T, int KD>
__device__ __forceinline__ void vec_acc(const T* s, const T* b, int ldb, int j0, T (&c)[4]) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    const T sk = s[k];
    T bb[4];
    ld4(b + k * ldb + j0, bb);
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] += bb[q] * sk;
  }
}

// The VB x VB block of pairs at (il0, jl0) of two column sets X (i) and Y
// (j): Sn(i, j) and Sn(j, i), Sn = P + K'W + G'K, each summed once, in the
// order of the first plan; written symmetrized or not into the rows' owners'
// Sk and Sc.  Kx, Wx, Gx: columns of X at [a][il] (stride LG), Ky, Wy, Gy
// of Y; Pij[il * LR + jl] = P(i, j), Pji[jl * LR + il] = P(j, i); skx, scx
// (rows j at j * LR, columns il) and sky, scy (rows i, columns jl) the
// owners' buffers; x0, y0 the first global index of each set.
template <typename T, int N, int M, int VB, int LG, int LR>
__device__ __forceinline__ void pair_block(int il0, int jl0, const T* Kx, const T* Wx,
                                           const T* Gx, const T* Ky, const T* Wy,
                                           const T* Gy, const T* Pij, const T* Pji, T* skx,
                                           T* scx, T* sky, T* scy, int x0, int y0,
                                           bool symmetrize, bool write_sc) {
  T sn[VB][VB], sm[VB][VB];   // Sn(i0 + r, j0 + q) and Sn(j0 + q, i0 + r)
#pragma unroll
  for (int r = 0; r < VB; ++r) {
#pragma unroll
    for (int q = 0; q < VB; ++q) {
      sn[r][q] = Pij[(il0 + r) * LR + jl0 + q];
      sm[r][q] = Pji[(jl0 + q) * LR + il0 + r];
    }
  }
#pragma unroll 2
  for (int a = 0; a < M; ++a) {
    T ki[VB], kj[VB], wi[VB], wj[VB];
    ldr<T, VB>(Kx + a * LG + il0, ki);
    ldr<T, VB>(Ky + a * LG + jl0, kj);
    ldr<T, VB>(Wx + a * LG + il0, wi);
    ldr<T, VB>(Wy + a * LG + jl0, wj);
#pragma unroll
    for (int r = 0; r < VB; ++r) {
#pragma unroll
      for (int q = 0; q < VB; ++q) {
        sn[r][q] += ki[r] * wj[q];
        sm[r][q] += kj[q] * wi[r];
      }
    }
  }
#pragma unroll 2
  for (int a = 0; a < M; ++a) {
    T gi[VB], gj[VB], ki[VB], kj[VB];
    ldr<T, VB>(Gx + a * LG + il0, gi);
    ldr<T, VB>(Gy + a * LG + jl0, gj);
    ldr<T, VB>(Kx + a * LG + il0, ki);
    ldr<T, VB>(Ky + a * LG + jl0, kj);
#pragma unroll
    for (int r = 0; r < VB; ++r) {
#pragma unroll
      for (int q = 0; q < VB; ++q) {
        sn[r][q] += gi[r] * kj[q];
        sm[r][q] += gj[q] * ki[r];
      }
    }
  }
  const T half = T(0.5);
#pragma unroll
  for (int r = 0; r < VB; ++r) {
#pragma unroll
    for (int q = 0; q < VB; ++q) {
      if (symmetrize) {
        sn[r][q] = half * (sn[r][q] + sm[r][q]);
        sm[r][q] = sn[r][q];
      }
    }
  }
  // S(i, j) = sn: Sk of X's owner [j][il], Sc of Y's owner [i][jl];
  // S(j, i) = sm: Sk of Y's owner [i][jl], Sc of X's owner [j][il].
#pragma unroll
  for (int q = 0; q < VB; ++q) {
    const int j = y0 + jl0 + q;
    if (j < N) {
      T vn[VB], vm[VB];
#pragma unroll
      for (int r = 0; r < VB; ++r) {
        vn[r] = sn[r][q];
        vm[r] = sm[r][q];
      }
      str<T, VB>(skx + j * LR + il0, vn);
      if (write_sc) str<T, VB>(scx + j * LR + il0, vm);
    }
  }
#pragma unroll
  for (int r = 0; r < VB; ++r) {
    const int i = x0 + il0 + r;
    if (i < N) {
      T vn[VB], vm[VB];
#pragma unroll
      for (int q = 0; q < VB; ++q) {
        vn[q] = sn[r][q];
        vm[q] = sm[r][q];
      }
      str<T, VB>(sky + i * LR + jl0, vm);
      if (write_sc) str<T, VB>(scy + i * LR + jl0, vn);
    }
  }
}

template <typename T, int N, int M, int C, int KP_, int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
riccati_cluster_kernel(const Args<T> args, int T_steps, long long B, int symmetrize) {
  using P = Plan<T, N, M, C, KP_>;
  static_assert(P::FITS, "the lane's share does not fit a block");
  constexpr int NP = P::NP, MP = P::MP, R = P::R, RM = P::RM;
  constexpr int LR = P::LR, LRM = P::LRM, LG = P::LG, LHT = P::LHT;
  constexpr int KP = P::KP, NPAN = P::NPAN, PANEL = P::PANEL, VB = P::VB;
  constexpr int SOLVERS = P::SOLVERS, SOLVER_THREADS = P::SOLVER_THREADS;
  T* const smem = reinterpret_cast<T*>(smem_base());
  int rank = cluster_rank();
  int r0 = rank * R, h0 = rank * RM;

  // The thread, its warp and lane, the lane of the batch and the block's
  // rank: taken anew (opaque) at every step, so that the indices derived
  // from them are too (held across the step loop, they spilled).
  int tid = threadIdx.x;
  int warp = tid / 32, wl = tid % 32;
  long long b = blockIdx.x / C;

  T* const Sk = smem + P::Sk;
  T* const Sc = smem + P::Sc;
  T* const SAp = smem + P::SAp;
  T* const Pc = smem + P::Pc;
  T* const SBp = smem + P::SBp;
  T* const Gp = smem + P::Gp;
  T* const Kp = smem + P::Kp;
  T* const Wp = smem + P::Wp;
  T* const Ht = smem + P::Ht;
  T* const sv = smem + P::sv;
  T* const ys = smem + P::ys;
  T* const scal = smem + P::scal;   // reg, dv1, dv2 (not in registers)
  T* const ring = smem + P::ring;
  // Batch-first at a shape whose rows have no pad, A and B come by the
  // bulk-copy engine (copy path 7): a slot's mbarrier completes when its
  // bytes have landed.
  constexpr bool BULK = LAYOUT == BATCH_FIRST && P::DENSE;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_base() + P::MBAR_BYTE);

  // Input k of this lane at step t: element e at in_at(k, t)[e * step].
  const long long step = LAYOUT == BATCH_LAST ? B : 1;
  auto in_at = [&](int k, int t) -> const T* {
    return LAYOUT == BATCH_LAST ? args.in[k] + (long long)t * E<N, M>(k) * B + b
                                : args.in[k] + ((long long)b * T_steps + t) * E<N, M>(k);
  };
  // Value e of panel p of step t (a slot holds KP rows of A, NP wide, then
  // KP rows of B, MP wide; zero past the logical shape).
  auto panel_value = [&](const T* A_t, const T* B_t, int p, int e) -> T {
    if (e < KP * NP) {
      const int k = p * KP + e / NP, j = e % NP;
      return k < N && j < N ? ldg(A_t + (k * N + j) * step) : T(0);
    }
    const int f = e - KP * NP;
    const int k = p * KP + f / MP, a = f % MP;
    return k < N && a < M ? ldg(B_t + (k * M + a) * step) : T(0);
  };
  // Values e = lt, lt + count, ... < n of one region of a step's inputs into
  // shared memory: src(e) is the element's index in input `in`, or -1 past
  // the logical shape; dst(e) its place.  Every load is issued (of element 0
  // where there is none) and the value zeroed after, so that no branch keeps
  // the unrolled loads from being in flight together (with one, a load
  // waited for the one before: about 650 cycles each).
  auto gather = [&](const T* in, int n, int lt, int count, auto&& src, auto&& dst) {
#pragma unroll 4
    for (int e = lt; e < n; e += count) {
      const int i = src(e);
      const T v = ldg(in + (long long)max_(i, 0) * step);
      dst(e) = i >= 0 ? v : T(0);
    }
  };
  // Bulk: panel p of step t (all of A and B where they are resident) into
  // slot sl, by one thread: KP rows of A, then KP rows of B, each one block
  // in device memory and in the slot.
  auto issue = [&](int t, int p, int sl) {
    T* const dst = ring + sl * PANEL;
    async_proxy_fence();
    mbar_arrive_expect_tx(&full[sl], (uint32_t)(KP * (N + M) * (int)sizeof(T)));
    bulk_load(dst, in_at(0, t) + p * KP * N, (uint32_t)(KP * N * (int)sizeof(T)), &full[sl]);
    bulk_load(dst + KP * NP, in_at(1, t) + p * KP * M, (uint32_t)(KP * M * (int)sizeof(T)),
              &full[sl]);
  };
  // Step t's first terms (Qxx(:, own), Pux and Ruu of the own rows of m,
  // qx(own), ru) and, unless they come in bulk, its first panel (all of A
  // and B where they are resident) into shared memory, by threads lt of
  // `count`.
  auto load_step = [&](int t, int lt, int count) {
    gather(in_at(4, t), NP * R, lt, count,
           [&](int e) { const int i = e / R, j = r0 + e % R; return i < N && j < N ? i * N + j : -1; },
           [&](int e) -> T& { return smem[P::FTq + (e / R) * LR + e % R]; });
    gather(in_at(5, t), RM * NP, lt, count,
           [&](int e) { const int a = h0 + e / NP, j = e % NP; return a < M && j < N ? a * N + j : -1; },
           [&](int e) -> T& { return smem[P::FTp + e]; });
    gather(in_at(6, t), RM * MP, lt, count,
           [&](int e) { const int a = h0 + e / MP, c = e % MP; return a < M && c < M ? a * M + c : -1; },
           [&](int e) -> T& { return smem[P::FTr + e]; });
    gather(in_at(2, t), R, lt, count, [&](int e) { return r0 + e < N ? r0 + e : -1; },
           [&](int e) -> T& { return smem[P::FT1 + e]; });
    gather(in_at(3, t), MP, lt, count, [&](int e) { return e < M ? e : -1; },
           [&](int e) -> T& { return smem[P::FT1 + R + e]; });
    if constexpr (!BULK) {
      gather(in_at(0, t), KP * NP, lt, count,
             [&](int e) { const int k = e / NP, j = e % NP; return k < N && j < N ? k * N + j : -1; },
             [&](int e) -> T& { return ring[e]; });
      gather(in_at(1, t), KP * MP, lt, count,
             [&](int e) { const int k = e / MP, a = e % MP; return k < N && a < M ? k * M + a : -1; },
             [&](int e) -> T& { return ring[KP * NP + e]; });
    }
  };

  if constexpr (BULK) {
    if (tid == 0) {
      mbar_init(&full[0], 1);
      mbar_init(&full[1], 1);
    }
    mbar_init_fence();
  }
  for (int i = tid; i < P::ELEMS; i += NT) smem[i] = T(0);
  block_sync();
  // The carry, seeded from the terminal cost: Sk(k, il) = QN(r0 + il, k),
  // Sc(k, jl) = QN(k, r0 + jl); the whole s.
  for (int e = tid; e < R * N; e += NT) {
    const int il = e / N, k = e % N, i = r0 + il;
    if (i < N) {
      const long long ik = (long long)i * N + k, ki = (long long)k * N + i;
      Sk[k * LR + il] = LAYOUT == BATCH_LAST ? args.QN[ik * B + b] : args.QN[b * N * N + ik];
      Sc[k * LR + il] = LAYOUT == BATCH_LAST ? args.QN[ki * B + b] : args.QN[b * N * N + ki];
    }
  }
  for (int i = tid; i < N; i += NT)
    sv[i] = LAYOUT == BATCH_LAST ? args.qxN[(long long)i * B + b] : args.qxN[b * N + i];
  if (tid == 0) scal[0] = args.reg[b];
  if (T_steps > 0) {
    load_step(T_steps - 1, tid, NT);
    if constexpr (BULK) {
      if (tid == 0) issue(T_steps - 1, 0, 0);
    }
  }
  const T half = T(0.5);
#ifdef RICCATI_STAGE_CLOCKS
  // Thread 0's counters, in shared memory (held in every thread's
  // registers across the step loop, they spilled): the stages, then the
  // last read.
  long long* const clk = reinterpret_cast<long long*>(smem_base() + P::CLK_BYTE);
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) clk[k] = 0;
  }
  auto tick = [&](int stage) {
    if (threadIdx.x == 0) {
      const long long now = clock_now();
      clk[stage] += now - clk[kStages];
      clk[kStages] = now;
    }
  };
#else
  auto tick = [](int) {};
#endif
  // Every block of the cluster has started and holds its first step.
  cluster_sync();

  for (int it = 0; it < T_steps; ++it) {
    const int t = T_steps - 1 - it;
    tid = opaque(tid);
    warp = tid / 32;
    wl = tid % 32;
    b = blockIdx.x / C;
    rank = opaque(rank);
    r0 = rank * R;
    h0 = rank * RM;
#ifdef RICCATI_STAGE_CLOCKS
    if (threadIdx.x == 0) clk[kStages] = clock_now();
#endif
    // S'B reads S(k, j): Sc, or Sk once the carry is symmetrized.
    const T* const Sl = symmetrize && it > 0 ? Sk : Sc;

    // The products of stages 1 and 2 over the panels of a step (stage 1
    // sums panels 0 .. NPAN-1 of A and B, stage 2 the same again; where A
    // and B are resident, the one slot).  A stage's jobs run in ROUNDS
    // rounds of the block's threads: first(r, c) sets round r's tile to its
    // first terms, acc(r, c, sl, k0, kd) adds the terms of the panel at `sl`
    // (A at sl, B at sl + KP * NP) of rows k0 .. k0 + kd - 1 (kd
    // compile-time: KP, LASTKD for the last panel, N for the resident slot),
    // out(r, c) stores the tile.  Resident, the rounds are a rolled loop,
    // each summing all of k (one copy of the code a kind of tile); streamed,
    // every round's tile stays in registers across the panels.
    auto stage = [&](int which, auto rounds, auto&& first, auto&& acc, auto&& out) {
      constexpr int ROUNDS = decltype(rounds)::value;
      if constexpr (P::RES) {
        // Bulk: the step's A and B, landed (stage 2 reads the same slot).
        if constexpr (BULK) {
          if (which == 1) mbar_wait(&full[0], (uint32_t)(it & 1));
        }
#pragma unroll 1
        for (int r = 0; r < ROUNDS; ++r) {
          T c[4][4];
          first(r, c);
          acc(r, c, ring, 0, std::integral_constant<int, N>());
          out(r, c);
        }
      } else {
        T c[ROUNDS][4][4];
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) first(r, c[r]);
#pragma unroll 1
        for (int p = 0; p < NPAN; ++p) {
          // Taken anew every panel: the indices of the loads and tiles are
          // recomputed, not held across the loop (they spilled).
          tid = opaque(tid);
          const int s = (which - 1) * NPAN + p;   // place in the step's sequence
          const bool more = s + 1 < 2 * NPAN;
          // The next panel (after the last, the next step's first) into the
          // slot that the barrier ending the panel before freed; then this
          // one, landed.  Slot s % 2's use it * NPAN + s / 2 completes its
          // mbarrier's phase of that parity.
          if constexpr (BULK) {
            if (tid == NT - 1) {
              if (more) issue(t, (s + 1) % NPAN, (s + 1) % 2);
              else if (t > 0) issue(t - 1, 0, 0);
            }
            mbar_wait(&full[s % 2], (uint32_t)((it * NPAN + s / 2) & 1));
          }
          // Else the next panel into registers while this one is summed.
          T v[BULK ? 1 : P::PE];
          if (!BULK && more) {
            const int pn = (s + 1) % NPAN;
            const T* const A_t = in_at(0, t);
            const T* const B_t = in_at(1, t);
#pragma unroll
            for (int u = 0; u < P::PE; ++u) {
              const int e = tid + u * NT;
              v[u] = e < PANEL ? panel_value(A_t, B_t, pn, e) : T(0);
            }
          }
          const T* sl = ring + (s % 2) * PANEL;
#pragma unroll
          for (int r = 0; r < ROUNDS; ++r) {
            if (p + 1 < NPAN) acc(r, c[r], sl, p * KP, std::integral_constant<int, KP>());
            else acc(r, c[r], sl, p * KP, std::integral_constant<int, P::LASTKD>());
          }
          if (!BULK && more) {
            T* dst = ring + ((s + 1) % 2) * PANEL;
#pragma unroll
            for (int u = 0; u < P::PE; ++u) {
              const int e = tid + u * NT;
              if (e < PANEL) dst[e] = v[u];
            }
          }
          block_sync();
        }
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) out(r, c[r]);
      }
    };

    // 1. S A and S'B (own rows), pushed to their column owners.  Both kinds
    //    of tile run one code path, their operands picked by the job, so
    //    that a warp holding both runs one tile loop; where the block's
    //    threads suffice (as at (72, 36)) the stage is one round.
    {
      // Job u's kind, first row and column of its tile.
      auto job1 = [&](int r, bool& sa, int& i0, int& j0) -> bool {
        const int job = tid + r * NT;
        sa = job < P::J_SA;
        const int u = sa ? job : job - P::J_SA;
        const int w = sa ? NP / 4 : MP / 4;
        i0 = (u / w) * 4;
        j0 = (u % w) * 4;
        return job < P::J_SA + P::J_SB;
      };
      stage(1, std::integral_constant<int, P::ROUNDS1>(),
            [&](int, T (&c)[4][4]) {
#pragma unroll
              for (int rr = 0; rr < 4; ++rr)
#pragma unroll
                for (int q = 0; q < 4; ++q) c[rr][q] = T(0);
            },
            [&](int r, T (&c)[4][4], const T* sl, int k0, auto kd) {
              constexpr int KD = decltype(kd)::value;
              bool sa;
              int i0, j0;
              if (job1(r, sa, i0, j0))
                tile_acc<T, 4, KD>((sa ? Sk : Sl) + k0 * LR, LR, sa ? sl : sl + KP * NP,
                                   sa ? NP : MP, i0, j0, c);
            },
            [&](int r, const T (&c)[4][4]) {
              bool sa;
              int i0, j0;
              if (job1(r, sa, i0, j0)) {
                // S A (i, j0..) to SAp of j's owner; S'B (j, a0..) to SBp of
                // a's owner; row r0 + i0 + rr of either.
                const int q = j0 / (sa ? R : RM);
                T* dst = sa ? peer(SAp, q) + (j0 - q * R) : peer(SBp, q) + (j0 - q * RM);
                const int ld = sa ? LR : LRM;
#pragma unroll
                for (int rr = 0; rr < 4; ++rr)
                  if (r0 + i0 + rr < N) str<T, 4>(dst + (r0 + i0 + rr) * ld, c[rr]);
              }
            });
    }
    cluster_sync();
    tick(0);

    // 2. G = Pux + (S'B)'A and H = Ruu + (S'B)'B (own rows of m, pushed to
    //    the owners of G's columns and to every block's H'), P = Qxx + A'(S A)
    //    (own columns); 1 x 4 tiles of qx + A's (own rows) and of g = ru + B's
    //    (whole, in every block), whose s and inputs stage 1 left alone.
    {
      // Round r's job: kind (0 G, 1 H, 2 P, 3 qx + A's, 4 g, -1 none) and
      // the first row and column of its tile.
      auto job2 = [&](int r, int& i0, int& j0) -> int {
        const int job = tid + r * NT;
        int u = job, kind = -1;
        if (job < P::O2G) {
          if (u < P::J_G) kind = 0, i0 = (u / (NP / 4)) * 4, j0 = (u % (NP / 4)) * 4;
        } else if (job < P::O2H) {
          u = job - P::O2G;
          if (u < P::J_H) kind = 1, i0 = (u / (MP / 4)) * 4, j0 = (u % (MP / 4)) * 4;
        } else if (job < P::O2P) {
          u = job - P::O2H;
          if (u < P::J_P) kind = 2, i0 = (u / (R / 4)) * 4, j0 = (u % (R / 4)) * 4;
        } else {
          u = job - P::O2P;
          if (u < R / 4) kind = 3, i0 = 0, j0 = 4 * u;
          else if (u < P::J_V) kind = 4, i0 = 0, j0 = 4 * (u - R / 4);
        }
        return kind;
      };
      stage(2, std::integral_constant<int, P::ROUNDS2>(),
            [&](int r, T (&c)[4][4]) {
              int i0 = 0, j0 = 0;
              const int kind = job2(r, i0, j0);
              const T* f = kind == 0 ? smem + P::FTp : kind == 1 ? smem + P::FTr
                         : kind == 2 ? smem + P::FTq : smem + P::FT1 + (kind == 4 ? R : 0);
              const int ld = kind == 0 ? NP : kind == 1 ? MP : LR;
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                if (kind >= 0 && kind <= 2) {
                  ld4(f + (i0 + rr) * ld + j0, c[rr]);
                } else {
#pragma unroll
                  for (int q = 0; q < 4; ++q) c[rr][q] = kind > 2 && rr == 0 ? f[j0 + q] : T(0);
                }
              }
            },
            [&](int r, T (&c)[4][4], const T* sl, int k0, auto kd) {
              constexpr int KD = decltype(kd)::value;
              int i0 = 0, j0 = 0;
              const int kind = job2(r, i0, j0);
              const T* sA = sl;
              const T* sB = sl + KP * NP;
              if (kind == 0 || kind == 1) {
                tile_acc<T, 4, KD>(SBp + k0 * LRM, LRM, kind == 0 ? sA : sB,
                                   kind == 0 ? NP : MP, i0, j0, c);
              } else if (kind == 2) {
                tile_acc<T, 4, KD>(sA, NP, SAp + k0 * LR, LR, i0, j0, c);
              } else if (kind == 3) {
                if (r0 + j0 < NP) vec_acc<T, KD>(sv + k0, sA, NP, r0 + j0, c[0]);
              } else if (kind == 4) {
                vec_acc<T, KD>(sv + k0, sB, MP, j0, c[0]);
              }
            },
            [&](int r, const T (&c)[4][4]) {
              int i0 = 0, j0 = 0;
              const int kind = job2(r, i0, j0);
              if (kind == 0) {
                const int q = j0 / R;
                T* dst = peer(Gp, q) + (j0 - q * R);
#pragma unroll
                for (int rr = 0; rr < 4; ++rr)
                  if (h0 + i0 + rr < M) str<T, 4>(dst + (h0 + i0 + rr) * LG, c[rr]);
              } else if (kind == 1) {
                // H(a, j0 + q) for the four rows a: H'(j0 + q, a), in every
                // block.
                if (h0 + i0 < MP) {
#pragma unroll 1
                  for (int p = 0; p < C; ++p) {
                    T* const h = peer(Ht, p) + j0 * LHT + h0 + i0;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                      const T col[4] = {c[0][q], c[1][q], c[2][q], c[3][q]};
                      str<T, 4>(h + q * LHT, col);
                    }
                  }
                }
              } else if (kind == 2) {
#pragma unroll
                for (int rr = 0; rr < 4; ++rr) str<T, 4>(Pc + (i0 + rr) * LR + j0, c[rr]);
              } else if (kind == 3) {
                str<T, 4>(ys + j0, c[0]);
              } else if (kind == 4) {
#pragma unroll
                for (int q = 0; q < 4; ++q) Gp[(j0 + q) * LG + R] = c[0][q];
              }
            });
    }
    cluster_sync();
    tick(1);

    // 3. Solver warps: the Cholesky of H + reg I and [K | duff] = -(H +
    //    reg I)^-1 [G | g] for the own columns and g.  Packer warps: the
    //    next step's first terms and A, B.
    if (warp < SOLVERS) {
      T* const Lpk = smem + P::Lpk;   // L(i, k) at i (i + 1) / 2 + k
      T* const iv = smem + P::invd;
      if (warp == 0) {
        // Rows 0 .. K1-1, lane i holding row i (a[k] = H(i, k) = H'(k, i);
        // lanes past them hold a copy of row 0, never read): right-looking,
        // one rsqrt a pivot, the pivot and column j of L broadcast by
        // __shfl_sync, every entry's subtractions in the reference's order;
        // lane j + 1 forms its next pivot from its own L(j + 1, j), so that
        // a column's chain waits for one shuffle.
        constexpr int K1 = min_(M, 32);
        {
          const int row = wl < K1 ? wl : 0;
          T a[K1];
#pragma unroll
          for (int k = 0; k < K1; ++k) {
            a[k] = Ht[k * LHT + row];
            if (k == wl) a[k] += scal[0];
          }
          T d = a[0];
#pragma unroll
          for (int j = 0; j < K1; ++j) {
            const T r = rsqrt_<T>(shfl(d, j));
            a[j] *= r;
            if (wl == 0) iv[j] = r;
            if (j + 1 < K1) {
              d = a[j + 1];
              d -= a[j] * a[j];
            }
#pragma unroll
            for (int k = j + 1; k < K1; ++k) a[k] -= a[j] * shfl(a[j], k);
          }
          if (wl < K1) {
#pragma unroll
            for (int k = 0; k < K1; ++k)
              if (k <= wl) Lpk[wl * (wl + 1) / 2 + k] = a[k];
          }
          warp_sync();
        }
        if constexpr (M > 32) {
          // Rows 32 .. M-1, lane l holding row i = 32 + l (lanes past them a
          // copy of row 32, writing the same values).  Each entry's
          // subtractions stay in the order of j; the loops are rolled, so
          // that this code stays small (fully unrolled, this part and the
          // first 32 columns ran twice as long: past m = 32 the step's code
          // outgrows the instruction cache).
          const int i = 32 + (wl < M - 32 ? wl : 0);
          T* const Li = Lpk + i * (i + 1) / 2;   // row i of L
          // Its columns below 32, SB at a time, by forward substitution
          // against rows 0-31: L(i, k) = (a(i, k) - sum_j<k L(i, j) L(k, j))
          // r_k, the earlier blocks' terms first, then the block's own.
#pragma unroll 1
          for (int k0 = 0; k0 < 32; k0 += SB) {
            T acc[SB], lb[SB];
#pragma unroll
            for (int r = 0; r < SB; ++r) acc[r] = Ht[(k0 + r) * LHT + i];
#pragma unroll 2
            for (int j = 0; j < k0; ++j) {
              const T lij = Li[j];
#pragma unroll
              for (int r = 0; r < SB; ++r) acc[r] -= lij * Lpk[(k0 + r) * (k0 + r + 1) / 2 + j];
            }
#pragma unroll
            for (int r = 0; r < SB; ++r) {
#pragma unroll
              for (int q = 0; q < r; ++q)
                acc[r] -= lb[q] * Lpk[(k0 + r) * (k0 + r + 1) / 2 + k0 + q];
              lb[r] = acc[r] * iv[k0 + r];
              Li[k0 + r] = lb[r];
            }
          }
          warp_sync();
          // Its trailing entries less L(i, j) L(k, j), j < 32, in order
          // (L(k, j) from row k, written above by lane k - 32) ...
          constexpr int MT = M - 32;
          T a[MT];
#pragma unroll
          for (int k = 0; k < MT; ++k) {
            a[k] = Ht[(32 + k) * LHT + i];
            if (32 + k == i) a[k] += scal[0];
          }
#pragma unroll 2
          for (int j = 0; j < 32; ++j) {
            const T lij = Li[j];
#pragma unroll
            for (int k = 0; k < MT; ++k) a[k] -= lij * Lpk[(32 + k) * (33 + k) / 2 + j];
          }
          // ... then the trailing columns factored as rows 0-31 were.
          T d = a[0];
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            const T r = rsqrt_<T>(shfl(d, j));
            a[j] *= r;
            if (wl == 0) iv[32 + j] = r;
            if (j + 1 < MT) {
              d = a[j + 1];
              d -= a[j] * a[j];
            }
#pragma unroll
            for (int k = j + 1; k < MT; ++k) a[k] -= a[j] * shfl(a[j], k);
          }
          if (wl < MT) {
#pragma unroll
            for (int k = 0; k < MT; ++k)
              if (k <= wl) Li[32 + k] = a[k];
          }
          warp_sync();
        }
      }
      group_sync(BAR_SOLVERS, SOLVER_THREADS);
      tick(2);
      // [K | duff] = -(H + reg I)^-1 [G | g], column c by one lane, with the
      // reference's order: x = L^-1 b, then x = L^-T x, multiplying by the
      // reciprocal pivots, x in registers (a rolled loop over blocks of rows
      // with x in shared memory between them took 1.7 to 1.9 times as long:
      // two shared loads a multiply-add).  Every lane of the solver warps
      // runs the substitutions (lanes past the R + 1 columns on a zero pad
      // column, writing nothing), so that a __syncwarp can close each window
      // of WIN rows, and in float64 of LW terms within a row: without them
      // ptxas hoists the loads of L ahead of the chain and spills (at
      // m = 64 a row's 63 loads of L beside a column of 64 values fill the
      // registers).
      constexpr int WIN = P::F64 ? 1 : 2;
      constexpr int LW = P::F64 ? 16 : M;
      const int c = tid <= R ? tid : R + 1;   // the column (tid = warp * 32 + wl)
      {
        T x[M];
#pragma unroll
        // The column's first terms: in float64 up to m = 48 read as each
        // row starts, else all at once behind a __syncwarp, so that the
        // column index is not held across the chain (each form left ptxas
        // an 8-byte spill at some shapes; this choice leaves none in float32
        // and in float64 at (72, 36), (73, 36) and (128, 64)).
        constexpr bool LAZY = P::F64 && M <= 48;
        if constexpr (!LAZY) {
#pragma unroll
          for (int i = 0; i < M; ++i) x[i] = Gp[i * LG + c];
          warp_sync();
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          T acc = LAZY ? Gp[i * LG + c] : x[i];
#pragma unroll
          for (int j = 0; j < i; ++j) {
            acc -= Lpk[i * (i + 1) / 2 + j] * x[j];
            if (j % LW == LW - 1) warp_sync();
          }
          x[i] = acc * iv[i];
          if (i % WIN == WIN - 1) warp_sync();
        }
#pragma unroll
        for (int i = M - 1; i >= 0; --i) {
          T acc = x[i];
#pragma unroll
          for (int j = i + 1; j < M; ++j) {
            acc -= Lpk[j * (j + 1) / 2 + i] * x[j];
            if ((j - i) % LW == 0) warp_sync();
          }
          x[i] = acc * iv[i];
          if ((M - 1 - i) % WIN == WIN - 1) warp_sync();
        }
        // The column taken anew (not held across the chain: it spilled).
        const int cs = opaque(tid);
        if (cs <= R) {
#pragma unroll
          for (int i = 0; i < M; ++i) Kp[i * LG + cs] = -x[i];
        }
      }
      tick(3);
    } else if (it + 1 < T_steps) {
      // The packers: step t - 1's first terms and first panel (or all of A
      // and B), into buffers this step no longer reads; resident A and B in
      // bulk, by the first packer.
      if constexpr (BULK && P::RES) {
        if (tid == SOLVER_THREADS) issue(t - 1, 0, 0);
      }
      load_step(t - 1, tid - SOLVER_THREADS, P::PACKERS);
    }
    block_sync();
    tick(4);
    // K (own columns) and duff (block 0) to device memory, by every thread,
    // from shared memory: the solver lanes' chain ends at shared memory.
    {
      T* const Kt = LAYOUT == BATCH_LAST ? args.Ks + (long long)t * M * N * B + b
                                         : args.Ks + ((long long)b * T_steps + t) * M * N;
      for (int e = tid; e < M * R; e += NT) {
        const int i = e / R, c = e % R;
        if (r0 + c < N) Kt[(i * N + r0 + c) * step] = Kp[i * LG + c];
      }
      if (rank == 0 && tid < M) {
        T* const dt = LAYOUT == BATCH_LAST ? args.duffs + (long long)t * M * B + b
                                           : args.duffs + ((long long)b * T_steps + t) * M;
        dt[tid * step] = Kp[tid * LG + R];
      }
    }

    // W = G + H K (own columns, [W | H duff]), with the raw H.
#pragma unroll
    for (int r = 0; r < P::ROUNDSW; ++r) {
      const int job = tid + r * NT;
      if (job < P::J_W) {
        const int a0 = (job / (LG / 4)) * 4, c0 = (job % (LG / 4)) * 4;
        T w[4][4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          if (c0 < R) {
            ld4(Gp + (a0 + rr) * LG + c0, w[rr]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) w[rr][q] = T(0);
          }
        }
        tile_acc<T, 4, M>(Ht, LHT, Kp, LG, a0, c0, w);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) str<T, 4>(Wp + (a0 + rr) * LG + c0, w[rr]);
      }
    }
    block_sync();
    // s = ys + K'(H duff + g) + G'duff (own rows, to every block); dv1, dv2.
    for (int il = tid; il < R; il += NT) {
      if (r0 + il < N) {
        T acc = ys[il];
        for (int a = 0; a < M; ++a)
          acc += Kp[a * LG + il] * (Wp[a * LG + R] + Gp[a * LG + R]) + Gp[a * LG + il] * Kp[a * LG + R];
#pragma unroll
        for (int p = 0; p < C; ++p) peer(sv, p)[r0 + il] = acc;
      }
    }
    if (rank == 0 && tid == NT - 1) {
      T dg = T(0), dHd = T(0);
      for (int i = 0; i < M; ++i) {
        const T d = Kp[i * LG + R];
        dg += d * Gp[i * LG + R];
        dHd += d * Wp[i * LG + R];
      }
      scal[1] += dg;
      scal[2] += half * dHd;
    }
    tick(5);
    cluster_arrive();

    // 4. S = P + K'W + G'K by mirrored pairs: first those inside the own
    //    rows (nothing of a peer), then, once every block's K and W are out,
    //    those across two blocks.
    const bool write_sc = !symmetrize;
    {
      constexpr int NB = R / VB;
#pragma unroll
      for (int r = 0; r < P::ROUNDSD; ++r) {
        const int job = tid + r * NT;
        if (job < P::diag(VB)) {
          int I = 0, rest = job;
          while (rest >= NB - I) {
            rest -= NB - I;
            ++I;
          }
          pair_block<T, N, M, VB, LG, LR>(VB * I, VB * (I + rest), Kp, Wp, Gp, Kp, Wp, Gp,
                                          Pc + r0 * LR, Pc + r0 * LR, Sk, Sc, Sk, Sc, r0, r0,
                                          symmetrize, write_sc);
        }
      }
    }
    cluster_wait();
    tick(6);
    if constexpr (C > 1) {
      // The slot: the peer's G, K, W (contiguous, as in its Gp, Kp, Wp) and
      // its P rows of this block's rows.
      T* const slot = smem + P::Gs;
      const T* const Gq = slot;
      const T* const Kq = smem + P::Ks;
      const T* const Wq = smem + P::Ws;
      const T* const Pq = smem + P::Ps;   // P(r0 + row, p R + col)
      static_assert(P::Ks == P::Gs + MP * LG && P::Ps == P::Gs + 3 * MP * LG,
                    "the slot mirrors Gp, Kp, Wp");
#pragma unroll 1
      for (int d = 1; d < C; ++d) {
        const int p = (rank + d) % C;
        // Copied in, 16 bytes a thread.
        {
          constexpr int V = P::VEC;
          const int prow = min_(R, max_(0, NP - r0));
          const int n1 = 3 * MP * LG / V, n2 = prow * LR / V;
          const T* g = peer(Gp, p);
          const T* pc = peer(Pc, p) + r0 * LR;
          for (int e = tid; e < n1 + n2; e += NT) {
            const T* src = e < n1 ? g + e * V : pc + (e - n1) * V;
            T* dst = e < n1 ? slot + e * V : smem + P::Ps + (e - n1) * V;
            T x[V];
            ldr<T, V>(src, x);
            str<T, V>(dst, x);
          }
        }
        block_sync();
        const int p0 = p * R;
        if (p > rank) {
          // Rows of this block (X) against the first SPLIT columns of p (Y):
          // P(i, j) from p, P(j, i) here.
          constexpr int NJ = P::SPLIT / VB;
#pragma unroll
          for (int r = 0; r < P::ROUNDSX; ++r) {
            const int job = tid + r * NT;
            if (job < (R / VB) * NJ)
              pair_block<T, N, M, VB, LG, LR>(VB * (job / NJ), VB * (job % NJ), Kp, Wp, Gp, Kq,
                                              Wq, Gq, Pq, Pc + p0 * LR, Sk, Sc, peer(Sk, p),
                                              peer(Sc, p), r0, p0, symmetrize, write_sc);
          }
        } else {
          // Rows of p (X) against the columns of this block past SPLIT (Y):
          // P(i, j) here, P(j, i) from p.
          constexpr int NJ = (R - P::SPLIT) / VB;
#pragma unroll
          for (int r = 0; r < P::ROUNDSX; ++r) {
            const int job = tid + r * NT;
            if (NJ > 0 && job < (R / VB) * NJ) {
              const int jl0 = P::SPLIT + VB * (job % max_(NJ, 1));
              pair_block<T, N, M, VB, LG, LR>(VB * (job / max_(NJ, 1)), jl0, Kq, Wq, Gq, Kp, Wp,
                                              Gp, Pc + p0 * LR, Pq, peer(Sk, p), peer(Sc, p), Sk,
                                              Sc, p0, r0, symmetrize, write_sc);
            }
          }
        }
        if (d + 1 < C) block_sync();   // every thread done with the slot
      }
    }
    cluster_sync();
    tick(7);
  }

  if (rank == 0 && tid == NT - 1) {
    args.dv1[b] = scal[1];
    args.dv2[b] = scal[2];
  }
#ifdef RICCATI_STAGE_CLOCKS
  if (rank == 0 && tid == 0 && args.clocks != nullptr) {
    for (int k = 0; k < kStages; ++k) args.clocks[b * kStages + k] = clk[k];
  }
#endif
}

}  // namespace riccati_cluster

namespace {

using namespace riccati_cluster;

template <typename T>
using Kernel = void (*)(const Args<T>, int, long long, int);

// The kernel of a layout with its shared memory allowed (past 48 KB only by
// this attribute), and its launch configuration: B clusters of C blocks.
template <typename T, int N, int M>
cudaError_t prepare(int layout, long long B, void* stream, Kernel<T>* kernel,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  using Ch = Choice<T, N, M>;
  using P = typename Ch::P;
  constexpr int C = Ch::C, KP = Ch::KP;
  *kernel = layout == BATCH_LAST ? riccati_cluster_kernel<T, N, M, C, KP, BATCH_LAST>
                                 : riccati_cluster_kernel<T, N, M, C, KP, BATCH_FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * C));
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = P::BYTES;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int N, int M>
int launch(const void* const* in, const void* qxN, const void* QN, const void* reg,
           void* duffs, void* Ks, void* dv1, void* dv2, int T_steps, long long B,
           int symmetrize, int layout, int* path, void* clocks, void* stream) {
  using Ch = Choice<T, N, M>;
  constexpr int C = Ch::C;
#ifndef RICCATI_STAGE_CLOCKS
  if (clocks != nullptr) return (int)cudaErrorInvalidValue;
#endif
  // C blocks a lane: the grid's x dimension holds 2^31 - 1 blocks.
  if (B <= 0 || B * C > 0x7fffffffLL || T_steps < 0 ||
      (layout != BATCH_LAST && layout != BATCH_FIRST))
    return (int)cudaErrorInvalidValue;
  Kernel<T> kernel = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = prepare<T, N, M>(layout, B, stream, &kernel, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  // The clusters the card holds at once: none, and the launch would fail.
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kNoClusterFits;
  // Bulk copies read A and B from 16-byte boundaries (as_kernel_input
  // aligns a batch-first entry's inputs).
  const bool bulk = layout == BATCH_FIRST && Ch::P::DENSE;
  if (bulk && (reinterpret_cast<uintptr_t>(in[0]) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(in[1]) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  // The copy path, then the blocks a lane.
  if (path != nullptr) {
    path[0] = bulk ? kPathBulk : Ch::P::RES ? kPathPackers : kPathPanels;
    path[1] = C;
  }
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
  err = cudaLaunchKernelEx(&cfg, kernel, args, T_steps, B, symmetrize);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#if defined(RICCATI_N) && defined(RICCATI_M) && defined(RICCATI_SCALAR)
// The one instantiation of a build (ops/_build.py), behind the generic
// launcher with the C interface of the other sources: the seven step inputs
// as an array of device pointers, then qxN, QN, reg, the four outputs, T, B,
// symmetrize (0/1), layout (0 batch-last, 1 batch-first), where to write
// the copy path taken (5: the packer warps stage a step's first terms and
// its whole A and B; 6: A and B streamed in panels through registers) and,
// in the int after it, the blocks of a lane's cluster (may be null), a
// [B, kStages] int64 buffer of stage clocks (null unless built with
// -DRICCATI_STAGE_CLOCKS) and the CUDA stream; returns a cudaError_t, or
// kNoClusterFits (10000) when no cluster of the plan fits on the card.
extern "C" int riccati_cuda_instance(const void* const* in, const void* qxN,
                                     const void* QN, const void* reg, void* duffs,
                                     void* Ks, void* dv1, void* dv2, int T,
                                     long long B, int symmetrize, int layout,
                                     int* path, void* clocks, void* stream) {
  return launch<RICCATI_SCALAR, RICCATI_N, RICCATI_M>(
      in, qxN, QN, reg, duffs, Ks, dv1, dv2, T, B, symmetrize, layout, path,
      clocks, stream);
}
// The shared memory one block of the instantiation's cluster takes.
extern "C" int riccati_cuda_instance_shared_bytes() {
  return riccati_cluster::Choice<RICCATI_SCALAR, RICCATI_N, RICCATI_M>::P::BYTES;
}
// The blocks of a lane's cluster.
extern "C" int riccati_cuda_instance_cluster_size() {
  return riccati_cluster::Choice<RICCATI_SCALAR, RICCATI_N, RICCATI_M>::C;
}
// The clusters (lanes) of the instantiation resident on the current device
// at once in `layout`, as cudaOccupancyMaxActiveClusters counts them; a
// negative cudaError_t on failure.
extern "C" int riccati_cuda_instance_clusters_resident(int layout) {
  Kernel<RICCATI_SCALAR> kernel = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = prepare<RICCATI_SCALAR, RICCATI_N, RICCATI_M>(
      layout, 1024, nullptr, &kernel, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}
#else
#error "riccati_cluster.cu has no fixed instantiation: build it with \
-DRICCATI_N, -DRICCATI_M and -DRICCATI_SCALAR (ops/_build.py)"
#endif
