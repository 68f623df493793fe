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
// product entry in the formulas of riccati_xl.cu.  Two layouts, a template
// argument: batch-LAST (element e of lane b at step t at (t*E + e)*B + b)
// and batch-FIRST (at (b*T + t)*E + e), both read in place; a lane's
// arithmetic is the same code in both, so the two agree bit for bit.
// float32 and float64; no TF32 anywhere (reduced-precision products NaN the
// recursion at T >= 300, ilqr_tpu/precision.py).
//
// Why a cluster.  A lane's step holds S, S A (then the new S), A, P, B,
// S'B, G, K, W, H and its factor.  At (64, 32) float64 riccati_xl.cu's plan
// takes 204,672 of a block's 232,448 bytes; at (72, 36) the same plan needs
// about 266,688, at (96, 48) about 464 KB in float64 (232 KB in float32),
// at (128, 64) about 816 KB (408 KB).  Here a lane's rows are split over
// the C blocks of a cluster on neighbouring SMs: block r holds rows
// [r R, r R + R) of A, B, S, S A / P and S'B, and columns [r R, r R + R) of
// G, K and W (R = ceil(n / C)), rows [r RM, r RM + RM) of H (RM = ceil(m /
// C)), and a whole copy of H and of its factor.  Per block, in values:
//     3 R (n + 1) + 2 R (m + 1) + 3 m (R + 1) + (RM + 2 m) (m + 1) + m + 2 R + 4
// (Plan::ELEMS), which gives (Cluster::C, the smallest of 2, 4, 8 whose
// share fits a block):
//     (72, 36)  float32 C = 2,  71,944 B;  float64 C = 2, 143,888 B
//     (96, 48)  float32 C = 2, 127,024 B;  float64 C = 4, 146,624 B
//     (128, 64) float32 C = 2, 224,656 B;  float64 C = 8, 163,808 B
// so the ceiling (128, 64) fits in both types.  A cluster of 8 blocks is
// the portable limit; it would hold up to (152, 76) in float64 and
// (216, 108) in float32.
//
// The products read rows held by other blocks through distributed shared
// memory (cooperative_groups' map_shared_rank: a generic address into the
// peer's shared memory), after a cluster barrier.  Every entry is summed by
// one thread, from its first term, in the order of k, reading the remote
// operands where they lie: no partial sums of different blocks are added.
// Four cluster barriers a step:
//   1. S'B (own rows), S A (own rows), ys = qx + A's (own rows), and in
//      every block the whole g = ru + B's                     [cluster]
//   2. G = Pux + (B'S) A (own columns), H = Ruu + (B'S) B (own rows),
//      P = Qxx + A'(S A) (own rows, into the buffer of S)       [cluster]
//   3. every block: H gathered whole, H + reg I factored in shared memory by
//      the whole block (right-looking, one rsqrt a pivot, one block barrier
//      a column: past m = 32 a warp no longer holds a row a lane), [K |
//      duff] = -(H + reg I)^-1 [G | g] for its own columns and g (a thread a
//      column, the reference's substitutions), [W | H duff] = [G | 0] +
//      H [K | duff]; then the next step's A and B rows        [cluster]
//   4. S = P + K'W + G'K (own rows, each entry and its mirror by one thread,
//      so that a symmetrized S is symmetric to the bit), into the buffer of
//      S A, which then holds S; s = ys + K'(H duff + g) + G'duff (own rows);
//      dv1, dv2 (block 0)                                        [cluster]
// The last barrier of the last step is also the one that keeps every block
// alive until no peer reads its shared memory.  duff and the dv sums are
// computed by every block alike and written by block 0; each block writes
// the columns of K it owns.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores,
// 67 TFLOP/s float64 on the FP64 tensor cores): a lane and step reads
// 2n^2 + 2nm + m^2 + n + m values (16,956 at (72, 36)) and writes m + mn
// (2,628); its arithmetic is about 1.8 M multiply-adds at (72, 36)
// (chip_smoke.riccati_bound_ms counts them): bound by operations.  This
// first plan is simple rather than fast: scalar loads, a thread an entry,
// every input read from device memory where it lies (copy path "direct"),
// the whole block behind a barrier for each column of the factor.  Its
// times beside the bound are in PERF.md.
//
// The limits: n <= 128, m <= 64 and a block's shared memory (static_asserts
// below; cuda_riccati.route refuses a larger shape before any nvcc run).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace riccati_cluster {

constexpr int NT = 256;                    // threads a block
constexpr int NIN = 7;                     // A, B, qx, ru, Qxx, Pux, Ruu
constexpr int kMaxSharedBytes = 232448;    // what a Hopper block may use
constexpr int kMaxN = 128, kMaxM = 64;
// The copy path the launcher reports (cuda_riccati.COPY_PATHS): the inputs
// are read from device memory where they lie.
constexpr int kPathDirect = 3;
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
};

template <typename T> __device__ __forceinline__ T rsqrt_(T x);
template <> __device__ __forceinline__ float rsqrt_<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_<double>(double x) { return rsqrt(x); }

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

__host__ __device__ constexpr int min_(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int max_(int a, int b) { return a > b ? a : b; }

// The shared memory of one block of a cluster of C, in values of T, and
// the rows each block owns.
template <typename T, int N, int M, int C> struct Plan {
  static constexpr int R = (N + C - 1) / C;    // rows of n a block
  static constexpr int RM = (M + C - 1) / C;   // rows of H a block
  static constexpr int LDN = N + 1;            // row strides
  static constexpr int LDM = M + 1;
  static constexpr int LDC = R + 1;            // own columns, then the vector
  // Rows of n (of H) block q owns: [q R, q R + rows(q)).
  __host__ __device__ static constexpr int rows(int q) { return max_(0, min_(N, (q + 1) * R) - q * R); }
  __host__ __device__ static constexpr int hrows(int q) { return max_(0, min_(M, (q + 1) * RM) - q * RM); }

  static constexpr int A = 0;                    // [R][LDN]
  static constexpr int Bm = A + R * LDN;         // [R][LDM]
  static constexpr int X = Bm + R * LDM;         // S, then P       [R][LDN]
  static constexpr int Y = X + R * LDN;          // S A, then the new S
  static constexpr int BtSt = Y + R * LDN;       // S'B, [R][LDM]
  static constexpr int G = BtSt + R * LDM;       // [G | g], [M][LDC]
  static constexpr int K = G + M * LDC;          // [K | duff]
  static constexpr int W = K + M * LDC;          // [W | H duff]
  static constexpr int Hd = W + M * LDC;         // own rows of H, [RM][LDM]
  static constexpr int Hf = Hd + RM * LDM;       // the whole H, [M][LDM]
  static constexpr int Lf = Hf + M * LDM;        // H + reg I, then L
  static constexpr int invd = Lf + M * LDM;      // reciprocal pivots
  static constexpr int s = invd + M;             // own rows of s
  static constexpr int ys = s + R;               // own rows of qx + A's
  static constexpr int scal = ys + R;            // reg, dv1, dv2
  static constexpr int ELEMS = scal + 4;
  static constexpr int BYTES = ELEMS * (int)sizeof(T);
  static constexpr bool FITS = BYTES <= kMaxSharedBytes;
};

// The smallest cluster whose block holds its share of the plan.
template <typename T, int N, int M> struct Cluster {
  static constexpr int C = Plan<T, N, M, 2>::FITS ? 2 : Plan<T, N, M, 4>::FITS ? 4 : 8;
  using P = Plan<T, N, M, C>;
  static_assert(0 < N && N <= kMaxN && 0 < M && M <= kMaxM,
                "the plan serves n <= 128 and m <= 64");
  static_assert(P::FITS, "a lane's share does not fit a block of a cluster of 8");
};

// Input k is a d1(k) x d2(k) matrix a step (vectors are 1 x len).
template <int N, int M> __host__ __device__ constexpr int E(int k) {
  return k == 0 || k == 4 ? N * N : k == 1 ? N * M : k == 2 ? N : k == 3 ? M : k == 5 ? M * N : M * M;
}

template <typename T, int N, int M, int LAYOUT>
__global__ void __launch_bounds__(NT, 1)
riccati_cluster_kernel(const Args<T> args, int T_steps, long long B, int symmetrize) {
  using P = typename Cluster<T, N, M>::P;
  constexpr int C = Cluster<T, N, M>::C;
  constexpr int R = P::R, RM = P::RM, LDN = P::LDN, LDM = P::LDM, LDC = P::LDC;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int r0 = rank * R, nr = P::rows(rank);
  const int h0 = rank * RM, nh = P::hrows(rank);
  T* const smem = reinterpret_cast<T*>(smem_base());
  T* const A = smem + P::A;
  T* const Bm = smem + P::Bm;
  T* const BtSt = smem + P::BtSt;
  T* const G = smem + P::G;
  T* const K = smem + P::K;
  T* const W = smem + P::W;
  T* const Hd = smem + P::Hd;
  T* const Hf = smem + P::Hf;
  T* const Lf = smem + P::Lf;
  T* const invd = smem + P::invd;
  T* const sv = smem + P::s;
  T* const ys = smem + P::ys;
  T* const scal = smem + P::scal;   // reg, dv1, dv2
  // The same place in block q's shared memory.
  auto peer = [&](T* p, int q) -> const T* { return cluster.map_shared_rank(p, q); };

  // Element e of input k of this lane at step t, where it lies.
  auto input = [&](int k, int t, int e) -> T {
    return LAYOUT == BATCH_LAST ? args.in[k][((long long)t * E<N, M>(k) + e) * B + b]
                                : args.in[k][((long long)b * T_steps + t) * E<N, M>(k) + e];
  };
  // This block's rows of A and B at step t.
  auto load_AB = [&](int t) {
    for (int e = tid; e < nr * N; e += NT)
      A[(e / N) * LDN + e % N] = input(0, t, (r0 + e / N) * N + e % N);
    for (int e = tid; e < nr * M; e += NT)
      Bm[(e / M) * LDM + e % M] = input(1, t, (r0 + e / M) * M + e % M);
  };

  // The carry, seeded from the terminal cost.
  for (int e = tid; e < nr * N; e += NT) {
    const long long i = r0 + e / N, j = e % N;
    smem[P::X + (e / N) * LDN + j] =
        LAYOUT == BATCH_LAST ? args.QN[(i * N + j) * B + b] : args.QN[(b * N + i) * N + j];
  }
  for (int e = tid; e < nr; e += NT)
    sv[e] = LAYOUT == BATCH_LAST ? args.qxN[(long long)(r0 + e) * B + b] : args.qxN[b * N + r0 + e];
  if (tid == 0) {
    scal[0] = args.reg[b];
    scal[1] = T(0);
    scal[2] = T(0);
  }
  if (T_steps > 0) load_AB(T_steps - 1);
  const T half = T(0.5);
  int xo = P::X, yo = P::Y;   // the buffers of S and of S A swap every step
  cluster.sync();

  for (int it = 0; it < T_steps; ++it) {
    const int t = T_steps - 1 - it;
    T* const S = smem + xo;    // S; P from stage 2
    T* const SA = smem + yo;   // S A; the new S from stage 4

    // 1. S'B and S A (own rows), ys = qx + A's (own rows), g = ru + B's.
    for (int e = tid; e < nr * M; e += NT) {
      const int jl = e / M, a = e % M, j = r0 + jl;
      T acc = T(0);
      for (int q = 0; q < C; ++q) {
        const T* Sq = peer(S, q);
        const T* Bq = peer(Bm, q);
        for (int kk = 0; kk < P::rows(q); ++kk) acc += Sq[kk * LDN + j] * Bq[kk * LDM + a];
      }
      BtSt[jl * LDM + a] = acc;
    }
    for (int e = tid; e < nr * N; e += NT) {
      const int il = e / N, j = e % N;
      const T* Si = S + il * LDN;
      T acc = T(0);
      for (int q = 0; q < C; ++q) {
        const T* Aq = peer(A, q);
        for (int kk = 0; kk < P::rows(q); ++kk) acc += Si[q * R + kk] * Aq[kk * LDN + j];
      }
      SA[il * LDN + j] = acc;
    }
    for (int e = tid; e < nr + M; e += NT) {
      const bool is_g = e >= nr;
      const int i = is_g ? e - nr : r0 + e;   // a row of g, or of ys
      T acc = is_g ? input(3, t, i) : input(2, t, i);
      for (int q = 0; q < C; ++q) {
        const T* Xq = is_g ? peer(Bm, q) : peer(A, q);
        const T* sq = peer(sv, q);
        const int ld = is_g ? LDM : LDN;
        for (int kk = 0; kk < P::rows(q); ++kk) acc += Xq[kk * ld + i] * sq[kk];
      }
      if (is_g) G[i * LDC + R] = acc; else ys[e] = acc;
    }
    cluster.sync();

    // 2. G = Pux + (B'S) A (own columns), H = Ruu + (B'S) B (own rows),
    //    P = Qxx + A'(S A) (own rows, into the buffer of S).
    for (int e = tid; e < M * nr; e += NT) {
      const int a = e / nr, jl = e % nr, j = r0 + jl;
      T acc = input(5, t, a * N + j);
      for (int q = 0; q < C; ++q) {
        const T* Cq = peer(BtSt, q);
        const T* Aq = peer(A, q);
        for (int kk = 0; kk < P::rows(q); ++kk) acc += Cq[kk * LDM + a] * Aq[kk * LDN + j];
      }
      G[a * LDC + jl] = acc;
    }
    for (int e = tid; e < nh * M; e += NT) {
      const int al = e / M, c = e % M, a = h0 + al;
      T acc = input(6, t, a * M + c);
      for (int q = 0; q < C; ++q) {
        const T* Cq = peer(BtSt, q);
        const T* Bq = peer(Bm, q);
        for (int kk = 0; kk < P::rows(q); ++kk) acc += Cq[kk * LDM + a] * Bq[kk * LDM + c];
      }
      Hd[al * LDM + c] = acc;
    }
    for (int e = tid; e < nr * N; e += NT) {
      const int il = e / N, j = e % N, i = r0 + il;
      T acc = input(4, t, i * N + j);
      for (int q = 0; q < C; ++q) {
        const T* Aq = peer(A, q);
        const T* Yq = peer(SA, q);
        for (int kk = 0; kk < P::rows(q); ++kk) acc += Aq[kk * LDN + i] * Yq[kk * LDN + j];
      }
      S[il * LDN + j] = acc;
    }
    cluster.sync();

    // 3. H whole in every block, and H + reg I.
    for (int e = tid; e < M * M; e += NT) {
      const int a = e / M, c = e % M;
      const T v = peer(Hd, a / RM)[(a % RM) * LDM + c];
      Hf[a * LDM + c] = v;
      Lf[a * LDM + c] = a == c ? v + scal[0] : v;
    }
    __syncthreads();
    // Its Cholesky, right-looking: at column j every entry (i, k), j < k <=
    // i, subtracts L(i, j) L(k, j), L(i, j) = a(i, j) rsqrt(a(j, j)) formed
    // where it is used (the same product each time), so that each entry
    // subtracts its terms in the reference's order (j = 0, 1, ...); column j
    // itself is scaled in the next round, where nothing reads it, and its
    // pivot is L_jj = piv * rsqrt(piv).
    {
      T r_prev = T(0);
      for (int j = 0; j < M; ++j) {
        const T r = rsqrt_<T>(Lf[j * LDM + j]);
        const int w = M - 1 - j;
        for (int e = tid; e < w * w; e += NT) {
          const int i = j + 1 + e / w, k = j + 1 + e % w;
          if (k <= i) Lf[i * LDM + k] -= (Lf[i * LDM + j] * r) * (Lf[k * LDM + j] * r);
        }
        if (j > 0) {
          for (int i = j - 1 + tid; i < M; i += NT) Lf[i * LDM + j - 1] *= r_prev;
        }
        if (tid == 0) invd[j] = r;
        r_prev = r;
        __syncthreads();
      }
      if (tid == 0) Lf[(M - 1) * LDM + M - 1] *= r_prev;
      __syncthreads();
    }
    // [K | duff] = -(H + reg I)^-1 [G | g], a thread a column (its own
    // columns, then the vector), the reference's order: x = L^-1 b, then
    // x = L^-T x, multiplying by the reciprocal pivots.
    for (int e = tid; e <= nr; e += NT) {
      const int cl = e < nr ? e : R;
      for (int i = 0; i < M; ++i) {
        T acc = G[i * LDC + cl];
        for (int j = 0; j < i; ++j) acc -= Lf[i * LDM + j] * K[j * LDC + cl];
        K[i * LDC + cl] = acc * invd[i];
      }
      for (int i = M - 1; i >= 0; --i) {
        T acc = K[i * LDC + cl];
        for (int j = i + 1; j < M; ++j) acc -= Lf[j * LDM + i] * K[j * LDC + cl];
        K[i * LDC + cl] = acc * invd[i];
      }
      for (int i = 0; i < M; ++i) {
        const T v = -K[i * LDC + cl];
        K[i * LDC + cl] = v;
        if (e < nr) {
          const long long c = r0 + cl;
          if (LAYOUT == BATCH_LAST)
            args.Ks[(((long long)t * M + i) * N + c) * B + b] = v;
          else
            args.Ks[(((long long)b * T_steps + t) * M + i) * N + c] = v;
        } else if (rank == 0) {
          if (LAYOUT == BATCH_LAST)
            args.duffs[((long long)t * M + i) * B + b] = v;
          else
            args.duffs[((long long)b * T_steps + t) * M + i] = v;
        }
      }
    }
    __syncthreads();
    // [W | H duff] = [G | 0] + H [K | duff], with the raw H.
    for (int e = tid; e < M * (nr + 1); e += NT) {
      const int a = e / (nr + 1), cc = e % (nr + 1);
      const int cl = cc < nr ? cc : R;
      T acc = cc < nr ? G[a * LDC + cl] : T(0);
      for (int c = 0; c < M; ++c) acc += Hf[a * LDM + c] * K[c * LDC + cl];
      W[a * LDC + cl] = acc;
    }
    // The next step's rows of A and B (every peer read this step's in
    // stage 2).
    if (it + 1 < T_steps) load_AB(t - 1);
    cluster.sync();

    // 4. S = P + K'W + G'K, each entry (i, j) of the own rows with its
    //    mirror (j, i) summed in the same order by whichever thread holds
    //    row j, so that the symmetrized S is symmetric to the bit; into the
    //    buffer of S A.  s = ys + K'(H duff + g) + G'duff.
    for (int e = tid; e < nr * N; e += NT) {
      const int il = e / N, j = e % N, i = r0 + il;
      const int qj = j / R, jl = j % R;
      const T* Wj = peer(W, qj);
      const T* Kj = peer(K, qj);
      T sn = S[il * LDN + j];
      for (int a = 0; a < M; ++a) sn += K[a * LDC + il] * Wj[a * LDC + jl];
      for (int a = 0; a < M; ++a) sn += G[a * LDC + il] * Kj[a * LDC + jl];
      T v = sn;
      if (symmetrize) {
        const T* Gj = peer(G, qj);
        T sm = peer(S, qj)[jl * LDN + i];
        for (int a = 0; a < M; ++a) sm += Kj[a * LDC + jl] * W[a * LDC + il];
        for (int a = 0; a < M; ++a) sm += Gj[a * LDC + jl] * K[a * LDC + il];
        v = half * (sn + sm);
      }
      SA[il * LDN + j] = v;
    }
    for (int il = tid; il < nr; il += NT) {
      T acc = ys[il];
      for (int a = 0; a < M; ++a)
        acc += K[a * LDC + il] * (W[a * LDC + R] + G[a * LDC + R]) + G[a * LDC + il] * K[a * LDC + R];
      sv[il] = acc;
    }
    if (rank == 0 && tid == NT - 1) {
      T dg = T(0), dHd = T(0);
      for (int i = 0; i < M; ++i) {
        const T d = K[i * LDC + R];
        dg += d * G[i * LDC + R];
        dHd += d * W[i * LDC + R];
      }
      scal[1] += dg;
      scal[2] += half * dHd;
    }
    cluster.sync();
    const int tmp = xo;
    xo = yo;
    yo = tmp;
  }

  if (rank == 0 && tid == NT - 1) {
    args.dv1[b] = scal[1];
    args.dv2[b] = scal[2];
  }
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
  using P = typename Cluster<T, N, M>::P;
  constexpr int C = Cluster<T, N, M>::C;
  *kernel = layout == BATCH_LAST ? riccati_cluster_kernel<T, N, M, BATCH_LAST>
                                 : riccati_cluster_kernel<T, N, M, BATCH_FIRST>;
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
  constexpr int C = Cluster<T, N, M>::C;
  // No stage-clock build of this source.
  if (clocks != nullptr) return (int)cudaErrorInvalidValue;
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
  // The copy path, then the blocks a lane.
  if (path != nullptr) {
    path[0] = kPathDirect;
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
// the copy path taken (3: read where they lie) and, in the int after it,
// the blocks of a lane's cluster (may be null), a stage-clock buffer (must
// be null: this source has no stage-clock build) and the CUDA stream;
// returns a cudaError_t, or kNoClusterFits (10000) when no cluster of the
// plan fits on the card.
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
  return riccati_cluster::Cluster<RICCATI_SCALAR, RICCATI_N, RICCATI_M>::P::BYTES;
}
// The blocks of a lane's cluster.
extern "C" int riccati_cuda_instance_cluster_size() {
  return riccati_cluster::Cluster<RICCATI_SCALAR, RICCATI_N, RICCATI_M>::C;
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
