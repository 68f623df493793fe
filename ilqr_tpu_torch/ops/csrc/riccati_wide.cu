// Fused backward Riccati recursion for the larger models, (N, M) = (16, 8)
// and (24, 12) and, built at first use with -DRICCATI_N/-DRICCATI_M, any
// (n, m) whose padded plan fits a block (below): one launch for a whole
// scenario batch and horizon, a lane spread over the four warps of TPL = 128
// threads, two lanes a block, the inputs brought in by the Tensor Memory
// Accelerator (TMA) through a ring of steps in shared memory.
//
// Replaces the same TPU kernel as riccati.cu does at (4, 2):
// ilqr_tpu/ops/pallas_riccati.py::_riccati_kernel (launched by
// _riccati_pallas_call, fed by riccati_scan_pallas_bl and, batch-first, by
// riccati_scan_pallas_batched).  It computes what that kernel computes (the
// algebra is spelled out at the top of riccati.cu: g, G, H, Cholesky of
// H + reg I with one rsqrt per pivot, duff, K, the value update with the raw
// H, the optional symmetrize, dv1, dv2); it is not a copy of its blocks.
// Two layouts, chosen by a template argument: batch-LAST (element e of lane
// b at step t at (t*E + e)*B + b, as the TPU kernel) and batch-FIRST (at
// (b*T + t)*E + e, the per-scenario solver's), both read in place; a lane's
// arithmetic is the same code in both, so the two agree bit for bit.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores,
// 67 TFLOP/s float64 on its tensor cores, half of that outside them).  A
// lane and step reads 2N^2 + 2NM + M^2 + N + M values (856 at (16, 8), 1908
// at (24, 12)) and writes M + MN (136, 300); at B = 256, T = 1000, float32,
// (16, 8) that is 1.02 GB, 0.30 ms.  Its arithmetic, about 21.6 k
// multiply-adds a lane and step, is 0.17 ms.  Bytes bound it.  What holds
// the kernel above that bound is the dependent chain of a step: T steps
// follow one another, and a step is a dozen small products, an M-column
// Cholesky and the products that make the gains, each needing the one
// before.  The stage clocks (below) say where a step's cycles go.
//
// Design, each choice against the first version of this kernel (stage
// clocks and times of both in PERF.md):
//  * Four barriers a step (bar.sync of the lane's 128 threads), not seven:
//      1. SA = S A, BtS = B'S, g = ru + B's, ys = qx + A's      [barrier]
//      2. G = Pux + BtS A, H = Ruu + BtS B                      [barrier]
//      3. warp 0: the gains; warps 1-3: P = Qxx + A'(SA), then the next
//         step's inputs out of the ring                         [barrier]
//      4. S = Sn = P + K'W + G'K, written symmetrized by the owner of each
//         pair of 2 x 2 blocks; s = ys + K'(H duff + g) + G'duff [barrier]
//  * Products as register tiles on dense row-major copies: each thread
//    keeps a 1 x 4 or 2 x 4 tile of the result in registers and reads one
//    value (or pair) of the left factor and four of the right per step of
//    the sum, where the first version read two scalars from shared memory
//    for every multiply-add and so was bound by shared-memory bandwidth.
//    Each warp of a stage runs one kind of job (job counts are padded to
//    whole warps), so no warp serializes two code paths.
//  * The gains in one warp, in registers and without exchanges: every
//    thread of warp 0 factors H + reg I itself (right-looking, one rsqrt a
//    pivot, the subtractions in the reference's order), so L is in every
//    thread's registers; then thread c solves column c of [G | g] by the
//    reference's substitutions (depth M^2, from registers), and [W | H duff]
//    = [G | 0] + H [K | duff] is one product of depth M spread over the
//    warp.  The first version factored in shared memory, one column a round
//    with a barrier, and solved from shared memory.  A version with the
//    solves as products with L^-1 was slower (it added two dependent
//    products to the chain) and rounded differently from the reference
//    enough to move a float32 solve's worst lane (PERF.md).
//  * Loads off the chain.  The inputs of a step come in by TMA
//    (cp.async.bulk.tensor, one box per input) into a ring of RING = 3 steps,
//    completed on an mbarrier with its byte count; warps 1-3 copy a step out
//    of the ring into a dense double buffer during stage 3 of the step
//    before, and one of their threads then refills the slot, once both
//    lanes of the block have freed it (a second mbarrier).  A batch-last box
//    is 16 bytes of lanes (4 in float32, 2 in float64: TMA's least inner
//    box, and it must start on 16 bytes), of which the block's two lanes
//    use theirs; a batch-first box is the two lanes' contiguous blocks.
//    Where TMA cannot take a tensor (a batch-last row stride B*sizeof(T)
//    that is not a multiple of 16 bytes, as at a ragged B, a base address
//    that is not 16-byte aligned, fewer lanes than a box) the lane's own
//    threads copy its elements with cp.async into the same places and
//    complete the same kind of mbarrier (cp.async.mbarrier.arrive): the
//    launcher picks the path and reports it to the caller.
//  * Two lanes a block: B = 256 lanes make 128 blocks, one an SM.
//  * float64 N x N x N products (S A and A'(S A), 16 k of the 21.6 k
//    multiply-adds at (16, 8)) on the FP64 tensor core: mma.sync m8n8k4 f64,
//    one 8 x 8 output tile a warp, exact IEEE products.  float32 stays on
//    FFMA: no TF32 anywhere (reduced-precision products NaN the recursion at
//    T >= 300, ilqr_tpu/precision.py).
//
// Any (n, m): padding.  The tiles need N % 8 == 0 and M % 4 == 0, so a
// logical (NL, ML) runs as (N, M) = (ceil(NL/8)*8, ceil(ML/4)*4).  The padded
// rows and columns of A, B, qx, ru, Qxx, Pux, Ruu, QN and qxN are zero in
// shared memory (the per-element copies write only logical entries into a
// ring that starts zeroed; a TMA box over the logical dimensions fills what
// lies past them with zeros), and the padded diagonal of H + reg I is set to
// 1 in the Cholesky (not 0 + reg: reg may be 0, and rsqrt(0) = inf makes
// 0 * inf a NaN).  Then every padded entry of duff, K, W, S and s is an exact
// zero, every logical entry gets exactly the sums of the unpadded recursion
// plus exact zeros, and only the logical entries of duff and K are written.
// The limits are those of the plan: N + 1 <= 32 (one warp solves the N + 1
// columns) and Plan::BYTES <= 232,448, so N <= 24 (the padded (24, 12) in
// float64 takes 215,880 bytes; N = 32 breaks both); cuda_riccati.route
// refuses a shape past the padded (24, 12) before any nvcc run.
//
// Built with -DRICCATI_STAGE_CLOCKS (a second library, never on the main
// path) thread 0 of every lane adds the clock64() cycles of each stage of a
// step into a buffer of [B, kStages] counters.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace riccati_wide {

constexpr int TPL = 128;            // threads a lane
constexpr int WARPS = TPL / 32;
constexpr int RING = 3;             // steps in the ring of inputs
constexpr int NIN = 7;              // A, B, qx, ru, Qxx, Pux, Ruu
constexpr int kMaxSharedBytes = 232448;   // 227 KB: what a Hopper block may use
constexpr int kStages = 9;          // see STAGES in cuda_riccati.py
constexpr int PRODUCER = 32;        // the thread that issues TMA: lane 0, warp 1

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

__device__ __forceinline__ void lane_sync(int lane) {
  asm volatile("bar.sync %0, %1;" ::"r"(lane + 1), "r"(TPL) : "memory");
}

__device__ __forceinline__ void warp_sync() { __syncwarp(); }

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
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

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar)) : "memory");
}

// One element, asynchronously (the copy path for what TMA cannot take).
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

// Element offsets of the block's shared memory, in units of T, for the
// padded (N, M); the inputs in global memory have the logical (NL, ML).
template <typename T, int N, int M, int NL = N, int ML = M> struct Plan {
  static constexpr int LPB = 2;                     // lanes a block
  static constexpr int BOX = 16 / (int)sizeof(T);   // lanes of a batch-last box
  static constexpr int NTHREADS = LPB * TPL;
  // Input k is a d1(k) x d2(k) matrix a step (vectors are 1 x len).
  __host__ __device__ static constexpr int d1(int k) {
    return k == 0 || k == 1 || k == 4 ? N : k == 5 || k == 6 ? M : 1;
  }
  __host__ __device__ static constexpr int d2(int k) {
    return k == 1 || k == 3 || k == 6 ? M : N;
  }
  __host__ __device__ static constexpr int E(int k) { return d1(k) * d2(k); }
  // The same of the logical input in global memory.
  __host__ __device__ static constexpr int ld1(int k) {
    return k == 0 || k == 1 || k == 4 ? NL : k == 5 || k == 6 ? ML : 1;
  }
  __host__ __device__ static constexpr int ld2(int k) {
    return k == 1 || k == 3 || k == 6 ? ML : NL;
  }
  __host__ __device__ static constexpr int LE(int k) { return ld1(k) * ld2(k); }
  static constexpr bool PADDED = NL != N || ML != M;
  // A step's inputs, densely: A, B, qx, ru, Qxx, Pux, Ruu.
  __host__ __device__ static constexpr int dense(int k) {
    return k == 0 ? 0 : dense(k - 1) + E(k - 1);
  }
  static constexpr int IN = 2 * N * N + 2 * N * M + M * M + N + M;
  // In the ring each input's box (BOX lanes batch-last, LPB batch-first)
  // starts on a 128-byte boundary of the slot.
  static constexpr int ALIGN = 128 / (int)sizeof(T);
  __host__ __device__ static constexpr int up(int x) { return (x + ALIGN - 1) / ALIGN * ALIGN; }
  __host__ __device__ static constexpr int in_off(int k) {
    return k == 0 ? 0 : in_off(k - 1) + up(E(k - 1) * BOX);
  }
  static constexpr int SLOT = in_off(NIN);
  // A lane's region, every matrix row-major and on 4 elements: the step's
  // inputs twice (this step's and the next one's), the carry S and its
  // transpose, then the intermediates.
  static constexpr int IN0 = 0;
  static constexpr int S = 2 * IN;
  static constexpr int St = S + N * N;
  static constexpr int SA = St + N * N;
  static constexpr int P = SA + N * N;
  static constexpr int BtSt = P + N * N;   // (B'S)' = [N][M]
  // [M][NA] each, NA = N + 4: the N columns of a gain-sized matrix, then
  // its vector in column N and three zeros: [G | g], [K | duff] and
  // [W | H duff].
  static constexpr int NA = N + 4;
  static constexpr int GA = BtSt + N * M;
  static constexpr int KA = GA + M * NA;
  static constexpr int WA = KA + M * NA;
  static constexpr int H = WA + M * NA;
  static constexpr int Ht = H + M * M;
  static constexpr int s = Ht + M * M;
  static constexpr int ys = s + N;
  static constexpr int USED = ys + N;
  static constexpr int LANE = (USED + 3) / 4 * 4;
  static constexpr int LANES_OFF = RING * SLOT;
  static constexpr int ELEMS = LANES_OFF + LPB * LANE;
  // The mbarriers after the elements: full[RING][LPB], then empty[RING].
  static constexpr int BAR_BYTES = 8 * RING * (LPB + 1);
  static constexpr int BYTES = ((ELEMS * (int)sizeof(T) + 7) / 8) * 8 + BAR_BYTES;
  // Threads that repack a step (warps 1..): the arrivals that free a slot.
  static constexpr int PACKERS = TPL - 32;
  static_assert(IN % 4 == 0 && N % 4 == 0 && M % 4 == 0, "rows on 16 bytes");
  static_assert(0 < NL && NL <= N && 0 < ML && ML <= M, "logical within padded");
  static_assert(SLOT % ALIGN == 0 && LANE % 4 == 0, "aligned regions");
};

// c[r][q] += sum_k a(i0 + r, k) b(k, j0 + q), k = 0, 1, ..., for the RT x 4
// tile at (i0, j0), RT = 1 or 2: the left factor k-major (at[k * lda + i] =
// a(i, k)), the right one row-major (b[k * ldb + j]): one load of RT and one
// of 4 values for 4 RT multiply-adds.
template <typename T, int RT, int KD>
__device__ __forceinline__ void tile_acc(const T* at, int lda, const T* b, int ldb,
                                         int i0, int j0, T (&c)[RT][4]) {
#pragma unroll
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

// Tile `job` (RT x 4, row-major over the tiles) of the I x J result
// C = C0 + A B, the sum over KD: A k-major (at, lda), B row-major (b, ldb),
// C0 (may be null: zero) and C row-major, Ct (may be null) C transposed.
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
    if (C != nullptr) st4(C + (i0 + r) * ldc + j0, c[r]);
    if (Ct != nullptr) {
#pragma unroll
      for (int q = 0; q < 4; ++q) Ct[(j0 + q) * ldct + i0 + r] = c[r][q];
    }
  }
}

// One 8 x 8 tile of the N x N x N product C = C0 + A B on the FP64 tensor
// core, by a whole warp (at k-major, b row-major, as tile's).
template <int N>
__device__ __forceinline__ void tile_mma(int job, const double* at, const double* b,
                                         const double* c0, double* C, int wl) {
  constexpr int TN = N / 8;
  const int g = wl >> 2, q = wl & 3;
  const int i = (job / TN) * 8 + g;
  const int j = (job % TN) * 8 + 2 * q;
  const int bj = (job % TN) * 8 + g;
  double d0 = c0 ? c0[i * N + j] : 0.0;
  double d1 = c0 ? c0[i * N + j + 1] : 0.0;
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 4)
    mma_f64(d0, d1, at[(k0 + q) * N + i], b[(k0 + q) * N + bj]);
  C[i * N + j] = d0;
  C[i * N + j + 1] = d1;
}

// The N x N x N product C = C0 + A B (at k-major, b row-major) by warps
// w0 .. WARPS-1 of a lane: on the FP64 tensor core in float64, in 2 x 4 tiles
// by FFMA in float32.
template <typename T, int N>
__device__ __forceinline__ void nnn_product(const T* at, const T* b, const T* c0,
                                            T* C, int lt, int w0) {
  if constexpr (std::is_same<T, double>::value) {
    for (int job = lt / 32 - w0; job < (N / 8) * (N / 8); job += WARPS - w0)
      tile_mma<N>(job, at, b, c0, C, lt % 32);
  } else {
    for (int job = lt - 32 * w0; job < (N / 2) * (N / 4); job += TPL - 32 * w0)
      tile<T, 2, N, N>(job, at, N, b, N, c0, N, C, N, nullptr, 0);
  }
}

// Job counts rounded up to whole warps: each warp of a stage runs one kind
// of job, so no warp serializes two code paths.
__host__ __device__ constexpr int whole_warps(int jobs) { return (jobs + 31) / 32 * 32; }
// Rows of a tile: 1 where that gives the jobs at most `warps` warps, else 2.
__host__ __device__ constexpr int tile_rows(int rows, int cols, int warps) {
  return rows * (cols / 4) <= 32 * warps ? 1 : 2;
}

template <typename T, int N, int M, int NL, int ML, int LAYOUT>
__global__ void __launch_bounds__(Plan<T, N, M, NL, ML>::NTHREADS, 1)
riccati_wide_kernel(const __grid_constant__ Maps maps, const Args<T> args,
                    int T_steps, long long B, int symmetrize, int tma) {
  using P = Plan<T, N, M, NL, ML>;
  constexpr int LPB = P::LPB;
  constexpr int BOX = LAYOUT == BATCH_LAST ? P::BOX : LPB;
  constexpr int NA = P::NA;
  constexpr bool F64 = std::is_same<T, double>::value;
  static_assert(N % 8 == 0, "8 x 8 tiles of the N x N products");
  static_assert(N + 1 <= 32, "one warp solves the N + 1 columns");
  static_assert(P::BYTES <= kMaxSharedBytes, "the block does not fit");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (P::BYTES - P::BAR_BYTES));
  uint64_t* empty = full + RING * LPB;

  const int tid = threadIdx.x;
  const int lane = tid / TPL;
  const int lt = tid % TPL;
  const int warp = lt / 32;
  const int wl = lt % 32;
  const long long b0 = (long long)blockIdx.x * LPB;
  const long long b = b0 + lane;
  const bool valid = b < B;
  T* my = smem + P::LANES_OFF + lane * P::LANE;
  // A batch-last box starts on 16 bytes of lanes (TMA refuses another
  // start): this lane's place in it.
  const long long box0 = LAYOUT == BATCH_LAST ? b0 - b0 % BOX : b0;
  const int in_box = (int)(b - box0);

  for (int i = tid; i < P::ELEMS; i += P::NTHREADS) smem[i] = T(0);
  if (tid == 0) {
    for (int r = 0; r < RING; ++r) {
      for (int l = 0; l < LPB; ++l) mbar_init(&full[r * LPB + l], tma ? 1 : TPL);
      mbar_init(&empty[r], LPB * P::PACKERS);
    }
  }
  mbar_init_fence();
  __syncthreads();

  // Bring iteration it (step T-1-it) into its slot of the ring: by TMA, from
  // thread PRODUCER, or by the lane's own threads.
  auto issue = [&](int it) {
    const int t = T_steps - 1 - it;
    const int r = it % RING;
    T* slot = smem + r * P::SLOT;
    if (tma) {
      if (tid != PRODUCER) return;
      mbar_arrive_expect_tx(&full[r * LPB], (uint32_t)(sizeof(T) * BOX * P::IN));
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        if (LAYOUT == BATCH_LAST)
          tma_load(slot + P::in_off(k), &maps.m[k], (int)box0, 0, 0, t, &full[r * LPB]);
        else
          tma_load(slot + P::in_off(k), &maps.m[k], 0, 0, t, (int)box0, &full[r * LPB]);
      }
      return;
    }
    if (valid) {
#pragma unroll
      for (int k = 0; k < NIN; ++k) {
        // e counts the logical elements; ep is e's place in the padded
        // matrix (the padded places are never written: zero).
        const int E = P::LE(k);
        const T* src = args.in[k];
        for (int e = lt; e < E; e += TPL) {
          const long long at = LAYOUT == BATCH_LAST
                                   ? ((long long)t * E + e) * B + b
                                   : ((long long)b * T_steps + t) * E + e;
          const int ep = P::PADDED ? e / P::ld2(k) * P::d2(k) + e % P::ld2(k) : e;
          const int to = LAYOUT == BATCH_LAST ? ep * BOX + in_box : in_box * P::E(k) + ep;
          copy_elem(slot + P::in_off(k) + to, src + at);
        }
      }
    }
    copy_arrive(&full[r * LPB + lane]);
  };

  // Warps 1..: wait for iteration it's inputs, copy them densely into
  // their buffer, free the slot; with TMA the producer then refills it with
  // iteration it + RING once both lanes have freed it.
  auto repack = [&](int it) {
    const int r = it % RING;
    mbar_wait(&full[r * LPB + (tma ? 0 : lane)], (uint32_t)((it / RING) & 1));
    const T* slot = smem + r * P::SLOT;
    T* dst = my + P::IN0 + (it & 1) * P::IN;
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      const int E = P::E(k);
      for (int e = lt - 32; e < E; e += P::PACKERS)
        dst[P::dense(k) + e] = slot[P::in_off(k) + (LAYOUT == BATCH_LAST
                                                         ? e * BOX + in_box
                                                         : in_box * E + e)];
    }
    if (tma) {
      mbar_arrive(&empty[r]);
      if (tid == PRODUCER && it + RING < T_steps) {
        mbar_wait(&empty[r], (uint32_t)((it / RING) & 1));
        issue(it + RING);
      }
    }
  };

  // The carry, seeded from the terminal cost, and its transpose.
  if (valid) {
    for (int i = lt; i < NL * NL; i += TPL) {
      const T v = LAYOUT == BATCH_LAST ? args.QN[(long long)i * B + b]
                                       : args.QN[b * NL * NL + i];
      my[P::S + (i / NL) * N + i % NL] = v;
      my[P::St + (i % NL) * N + i / NL] = v;
    }
    for (int i = lt; i < NL; i += TPL)
      my[P::s + i] = LAYOUT == BATCH_LAST ? args.qxN[(long long)i * B + b]
                                          : args.qxN[b * NL + i];
  }
  const T reg_b = valid ? args.reg[b] : T(1);
  const T half = T(0.5);
  T dv1_acc = T(0), dv2_acc = T(0);   // kept by the lane's thread 0
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

  for (int it = 0; it < RING && it < T_steps; ++it) issue(it);
  if (T_steps > 0 && warp > 0) repack(0);
  lane_sync(lane);

  for (int it = 0; it < T_steps; ++it) {
    const int t = T_steps - 1 - it;
    const T* in = my + P::IN0 + (it & 1) * P::IN;
    const T* A = in + P::dense(0);
    const T* Bm = in + P::dense(1);
    const T* qx = in + P::dense(2);
    const T* ru = in + P::dense(3);
    const T* Qxx = in + P::dense(4);
    const T* Pux = in + P::dense(5);
    const T* Ruu = in + P::dense(6);
#ifdef RICCATI_STAGE_CLOCKS
    c_prev = clock_now();
#endif

    // 1. SA = S A;  BtS = B'S (stored transposed);  g = ru + B's (column N
    //    of GA), ys = qx + A's.
    {
      constexpr int SA_J = F64 ? 0 : (N / 2) * (N / 4);
      constexpr int BT_RT = tile_rows(M, N, 1);
      constexpr int BT_J = (M / BT_RT) * (N / 4);
      constexpr int O1 = whole_warps(SA_J), O2 = O1 + whole_warps(BT_J);
      if (F64) nnn_product<T, N>(my + P::St, A, nullptr, my + P::SA, lt, 0);
      for (int job = lt; job < O2 + M + N; job += TPL) {
        if (job < O1) {
          if (job < SA_J)
            tile<T, 2, N, N>(job, my + P::St, N, A, N, nullptr, 0, my + P::SA, N,
                             nullptr, 0);
        } else if (job < O2) {
          if (job - O1 < BT_J)
            tile<T, BT_RT, N, N>(job - O1, Bm, M, my + P::S, N, nullptr, 0, nullptr,
                                 0, my + P::BtSt, M);
        } else if (job < O2 + M) {
          const int i = job - O2;
          T acc = ru[i];
#pragma unroll
          for (int k = 0; k < N; ++k) acc += Bm[k * M + i] * my[P::s + k];
          my[P::GA + i * NA + N] = acc;
        } else {
          const int i = job - O2 - M;
          T acc = qx[i];
#pragma unroll
          for (int k = 0; k < N; ++k) acc += A[k * N + i] * my[P::s + k];
          my[P::ys + i] = acc;
        }
      }
    }
    lane_sync(lane);
    tick(0);

    // 2. G = Pux + BtS A (into GA),  H = Ruu + BtS B (and H').
    {
      constexpr int G_RT = tile_rows(M, N, 3);
      constexpr int G_J = (M / G_RT) * (N / 4);
      constexpr int H_RT = tile_rows(M, M, 1);
      constexpr int H_J = (M / H_RT) * (M / 4);
      constexpr int O1 = whole_warps(G_J);
      for (int job = lt; job < O1 + H_J; job += TPL) {
        if (job < O1) {
          if (job < G_J)
            tile<T, G_RT, N, N>(job, my + P::BtSt, M, A, N, Pux, N, my + P::GA, NA,
                                nullptr, 0);
        } else {
          tile<T, H_RT, M, N>(job - O1, my + P::BtSt, M, Bm, M, Ruu, M, my + P::H,
                              M, my + P::Ht, M);
        }
      }
    }
    lane_sync(lane);
    tick(1);

    // 3. Warp 0: the gains.  Warps 1..: P = Qxx + A'(SA), then the next
    //    step's inputs out of the ring.
    if (warp == 0) {
      // Cholesky of H + reg I, every thread of the warp the whole of it in
      // registers (no exchange on the chain): right-looking, one rsqrt a
      // pivot, the subtractions in the reference's order.  L overwrites
      // the lower triangle of a.
      T a[M][M], invd[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int k = 0; k <= i; ++k) a[i][k] = my[P::H + i * M + k];
        // A padded pivot is 1 (see the top of the file).
        a[i][i] = i < ML ? a[i][i] + reg_b : T(1);
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const T piv = a[j][j];
        const T rj = rsqrt_<T>(piv);
        invd[j] = rj;
        a[j][j] = piv * rj;
#pragma unroll
        for (int i = j + 1; i < M; ++i) a[i][j] *= rj;
#pragma unroll
        for (int i = j + 1; i < M; ++i) {
#pragma unroll
          for (int k = j + 1; k <= i; ++k) a[i][k] -= a[i][j] * a[k][j];
        }
      }
      tick(2);
      // [K | duff] = -(H + reg I)^-1 [G | g] by substitution, column c by
      // thread c (N + 1 <= 32), with the reference's order: x = L^-1 b, then
      // x = L^-T x, multiplying by the reciprocal pivots.
      if (wl <= N) {
        T x[M];
#pragma unroll
        for (int i = 0; i < M; ++i) x[i] = my[P::GA + i * NA + wl];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          T acc = x[i];
#pragma unroll
          for (int j = 0; j < i; ++j) acc -= a[i][j] * x[j];
          x[i] = acc * invd[i];
        }
#pragma unroll
        for (int i = M - 1; i >= 0; --i) {
          T acc = x[i];
#pragma unroll
          for (int j = i + 1; j < M; ++j) acc -= a[j][i] * x[j];
          x[i] = acc * invd[i];
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const T v = -x[i];
          my[P::KA + i * NA + wl] = v;
          // Only the logical entries of K and duff are written.
          if (!valid || i >= ML) continue;
          if (wl < N) {
            if (wl >= NL) continue;
            if (LAYOUT == BATCH_LAST)
              args.Ks[(((long long)t * ML + i) * NL + wl) * B + b] = v;
            else
              args.Ks[(((long long)b * T_steps + t) * ML + i) * NL + wl] = v;
          } else if (LAYOUT == BATCH_LAST) {
            args.duffs[((long long)t * ML + i) * B + b] = v;
          } else {
            args.duffs[((long long)b * T_steps + t) * ML + i] = v;
          }
        }
      }
      warp_sync();
      tick(3);
      constexpr int QJ = M * (NA / 4);   // quads of [M][NA]
      // [W | Hd] = [G | 0] + H [K | duff]: K'HK + K'G = K'W, Hd = H duff
      // (raw H).
      for (int job = wl; job < QJ; job += 32) {
        const int i = job / (NA / 4), c = (job % (NA / 4)) * 4;
        T w[1][4] = {{T(0), T(0), T(0), T(0)}};
        if (c < N) ld4(my + P::GA + i * NA + c, w[0]);
        tile_acc<T, 1, M>(my + P::Ht + i, M, my + P::KA, NA, 0, c, w);
        st4(my + P::WA + i * NA + c, w[0]);
      }
      warp_sync();
      tick(4);
      if (wl == 0) {
        T dg = T(0), dHd = T(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const T d = my[P::KA + i * NA + N];
          dg += d * my[P::GA + i * NA + N];
          dHd += d * my[P::WA + i * NA + N];
        }
        dv1_acc += dg;
        dv2_acc += half * dHd;
      }
      tick(5);
    } else {
      nnn_product<T, N>(A, my + P::SA, Qxx, my + P::P, lt, 1);
      if (it + 1 < T_steps) repack(it + 1);
    }
    lane_sync(lane);
    tick(6);

    // Without TMA the lane's threads bring in the step RING iterations
    // ahead, into the slot the repack of this step freed.
    if (!tma && it + RING < T_steps) issue(it + RING);
    tick(7);

    // 4. Sn = P + K'W + G'K, by 2 x 2 blocks (i-block <= j-block) and their
    //    mirrors, written symmetrized (and transposed);
    //    s = ys + K'(H duff + g) + G'duff.
    constexpr int NB = N / 2;
    for (int job = lt; job < NB * (NB + 1) / 2; job += TPL) {
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
          sn[r][q] = my[P::P + (i0 + r) * N + j0 + q];
          sm[r][q] = my[P::P + (j0 + q) * N + i0 + r];
        }
      }
#pragma unroll
      for (int a = 0; a < M; ++a) {
        T ki[2], kj[2], wi[2], wj[2];
        ld2(my + P::KA + a * NA + i0, ki[0], ki[1]);
        ld2(my + P::KA + a * NA + j0, kj[0], kj[1]);
        ld2(my + P::WA + a * NA + i0, wi[0], wi[1]);
        ld2(my + P::WA + a * NA + j0, wj[0], wj[1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            sn[r][q] += ki[r] * wj[q];
            sm[r][q] += kj[q] * wi[r];
          }
        }
      }
#pragma unroll
      for (int a = 0; a < M; ++a) {
        T gi[2], gj[2], ki[2], kj[2];
        ld2(my + P::GA + a * NA + i0, gi[0], gi[1]);
        ld2(my + P::GA + a * NA + j0, gj[0], gj[1]);
        ld2(my + P::KA + a * NA + i0, ki[0], ki[1]);
        ld2(my + P::KA + a * NA + j0, kj[0], kj[1]);
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
          my[P::S + i * N + j] = vij;
          my[P::S + j * N + i] = vji;
          my[P::St + j * N + i] = vij;
          my[P::St + i * N + j] = vji;
        }
      }
    }
    if (lt >= TPL - N) {
      const int i = lt - (TPL - N);
      T acc = my[P::ys + i];
#pragma unroll
      for (int a = 0; a < M; ++a)
        acc += my[P::KA + a * NA + i] * (my[P::WA + a * NA + N] + my[P::GA + a * NA + N]) +
               my[P::GA + a * NA + i] * my[P::KA + a * NA + N];
      my[P::s + i] = acc;
    }
    lane_sync(lane);
    tick(8);
  }

  if (valid && lt == 0) {
    args.dv1[b] = dv1_acc;
    args.dv2[b] = dv2_acc;
  }
#ifdef RICCATI_STAGE_CLOCKS
  if (valid && lt == 0 && args.clocks != nullptr) {
    for (int k = 0; k < kStages; ++k) args.clocks[b * kStages + k] = clk[k];
  }
#endif
}

}  // namespace riccati_wide

namespace {

using namespace riccati_wide;

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

// The tensor map of input k: a box of one step of BOX lanes (batch-last) or
// of the block's LPB lanes (batch-first), over the logical dimensions of the
// input with the padded matrix as the box: TMA fills the padded places,
// which lie past the logical dimensions, with zeros.
template <typename T, int N, int M, int NL, int ML>
bool encode(CUtensorMap* map, int k, const void* base, int T_steps, long long B,
            int layout) {
  using P = Plan<T, N, M, NL, ML>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t s = sizeof(T), d1 = P::ld1(k), d2 = P::ld2(k);
  const cuuint32_t p1 = P::d1(k), p2 = P::d2(k);
  const cuuint64_t Bu = (cuuint64_t)B, Tu = (cuuint64_t)T_steps;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], estr[4] = {1, 1, 1, 1};
  if (layout == BATCH_LAST) {
    const cuuint64_t d[4] = {Bu, d2, d1, Tu};
    const cuuint64_t st[3] = {Bu * s, d2 * Bu * s, d1 * d2 * Bu * s};
    const cuuint32_t bx[4] = {(cuuint32_t)P::BOX, p2, p1, 1};
    for (int i = 0; i < 4; ++i) { dims[i] = d[i]; box[i] = bx[i]; }
    for (int i = 0; i < 3; ++i) strides[i] = st[i];
  } else {
    const cuuint64_t d[4] = {d2, d1, Tu, Bu};
    const cuuint64_t st[3] = {d2 * s, d1 * d2 * s, Tu * d1 * d2 * s};
    const cuuint32_t bx[4] = {p2, p1, 1, (cuuint32_t)P::LPB};
    for (int i = 0; i < 4; ++i) { dims[i] = d[i]; box[i] = bx[i]; }
    for (int i = 0; i < 3; ++i) strides[i] = st[i];
  }
  const CUtensorMapDataType type = sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int N, int M, int NL = N, int ML = M>
int launch(const void* const* in, const void* qxN, const void* QN, const void* reg,
           void* duffs, void* Ks, void* dv1, void* dv2, int T_steps, long long B,
           int symmetrize, int layout, int* path, void* clocks, void* stream) {
  using P = Plan<T, N, M, NL, ML>;
#ifndef RICCATI_STAGE_CLOCKS
  if (clocks != nullptr) return (int)cudaErrorInvalidValue;
#endif
  // TMA coordinates are 32-bit.
  if (B <= 0 || B > 0x7fffffffLL || T_steps < 0 ||
      (layout != BATCH_LAST && layout != BATCH_FIRST))
    return (int)cudaErrorInvalidValue;
  // The copy path.  TMA takes an input when its base is on 16 bytes, its
  // strides are multiples of 16 bytes and the batch holds at least one box
  // of lanes.  A batch-first stride is a row of NL or ML values (on 16 bytes
  // where they are whole chunks, as at (16, 8) and (24, 12), not at a logical
  // shape that is padded); a batch-last one is a row of B lanes.
  int tma = T_steps > 0 && B >= (layout == BATCH_LAST ? P::BOX : P::LPB);
  if (layout == BATCH_LAST && (B * (long long)sizeof(T)) % 16) tma = 0;
  for (int k = 0; k < NIN; ++k) {
    if (reinterpret_cast<uintptr_t>(in[k]) % 16) tma = 0;
    if (layout == BATCH_FIRST && (P::ld2(k) * sizeof(T)) % 16) tma = 0;
  }
  if (path != nullptr) *path = tma;
  Maps maps = {};
  Args<T> args;
  for (int k = 0; k < NIN; ++k) {
    args.in[k] = static_cast<const T*>(in[k]);
    if (tma && !encode<T, N, M, NL, ML>(&maps.m[k], k, in[k], T_steps, B, layout))
      return (int)cudaErrorInvalidValue;
  }
  args.qxN = static_cast<const T*>(qxN);
  args.QN = static_cast<const T*>(QN);
  args.reg = static_cast<const T*>(reg);
  args.duffs = static_cast<T*>(duffs);
  args.Ks = static_cast<T*>(Ks);
  args.dv1 = static_cast<T*>(dv1);
  args.dv2 = static_cast<T*>(dv2);
  args.clocks = static_cast<long long*>(clocks);
  auto kernel = layout == BATCH_LAST ? riccati_wide_kernel<T, N, M, NL, ML, BATCH_LAST>
                                     : riccati_wide_kernel<T, N, M, NL, ML, BATCH_FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + P::LPB - 1) / P::LPB));
  kernel<<<grid, dim3(P::NTHREADS), P::BYTES, static_cast<cudaStream_t>(stream)>>>(
      maps, args, T_steps, B, symmetrize, tma);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one function per instantiation, as riccati.cu's: the
// seven step inputs as an array of device pointers, then qxN, QN, reg, the
// four outputs, T, B, symmetrize (0/1), layout (0 batch-last, 1 batch-first),
// where to write the copy path taken (1: TMA, 0: per element; may be null), a
// [B, kStages] int64 buffer of stage clocks (null unless built with
// -DRICCATI_STAGE_CLOCKS) and the CUDA stream; returns a cudaError_t.
#define RICCATI_WIDE_EXPORT(NAME, SCALAR, N, M, NL, ML)                          \
  extern "C" int NAME(const void* const* in, const void* qxN, const void* QN,    \
                      const void* reg, void* duffs, void* Ks, void* dv1,         \
                      void* dv2, int T, long long B, int symmetrize, int layout, \
                      int* path, void* clocks, void* stream) {                   \
    return launch<SCALAR, N, M, NL, ML>(in, qxN, QN, reg, duffs, Ks, dv1, dv2,   \
                                        T, B, symmetrize, layout, path, clocks,  \
                                        stream);                                 \
  }

#if defined(RICCATI_N) && defined(RICCATI_M) && defined(RICCATI_SCALAR)
// One instantiation built at first use (ops/_build.py): the logical
// (RICCATI_N, RICCATI_M) in RICCATI_SCALAR, padded to whole tiles, behind the
// generic launcher riccati_cuda_instance.
constexpr int kPaddedN = (RICCATI_N + 7) / 8 * 8, kPaddedM = (RICCATI_M + 3) / 4 * 4;
RICCATI_WIDE_EXPORT(riccati_cuda_instance, RICCATI_SCALAR, kPaddedN, kPaddedM, RICCATI_N,
                    RICCATI_M)
// The shared memory a block of the instantiation takes (its Plan::BYTES).
extern "C" int riccati_cuda_instance_shared_bytes() {
  return riccati_wide::Plan<RICCATI_SCALAR, kPaddedN, kPaddedM, RICCATI_N, RICCATI_M>::BYTES;
}
#else
RICCATI_WIDE_EXPORT(riccati_cuda_16x8_f32, float, 16, 8, 16, 8)
RICCATI_WIDE_EXPORT(riccati_cuda_16x8_f64, double, 16, 8, 16, 8)
RICCATI_WIDE_EXPORT(riccati_cuda_24x12_f32, float, 24, 12, 24, 12)
RICCATI_WIDE_EXPORT(riccati_cuda_24x12_f64, double, 24, 12, 24, 12)
#endif
