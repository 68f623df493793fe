// Fused backward Riccati recursion for the larger models, (N, M) = (16, 8)
// and (24, 12): one launch for a whole scenario batch, a lane spread over
// the 64 threads of two warps.
//
// Replaces the same TPU kernel as riccati.cu does at (4, 2):
// ilqr_tpu/ops/pallas_riccati.py::_riccati_kernel (launched by
// _riccati_pallas_call, fed by riccati_scan_pallas_bl).  It computes what
// that kernel computes (the algebra is spelled out at the top of
// riccati.cu: g, G, H, Cholesky of H + reg I with one rsqrt per pivot, duff,
// K, the value update with the raw H, dv1, dv2); it is not a copy of its
// blocks: no padding of the batch, no time blocking, no tile-shape
// argument.  Layout batch-LAST as there: element e of lane b at e*B + b.
//
// Why not riccati.cu's one thread a lane.  At (16, 8) a lane carries 272
// values and a step needs A, S·A, the next S, G, K, H and L beside them: over
// a thousand live values, which one thread would keep in local memory, and
// B = 256 lanes would be 8 warps on a card with 132 SMs.
//
// Design.
//  * A lane is owned by TPL = 64 threads of one block; a block owns LPB = 2
//    consecutive lanes.  The carry (S, s) and every matrix of a step live
//    in the lane's region of shared memory (about 13 KB a lane in float32 at
//    (16, 8), 29 KB at (24, 12)).  Every product is computed here, by the
//    lane's threads: each thread owns 1x4 tiles of the result and walks the
//    inner dimension with one scalar and one 16-byte shared-memory load per
//    four multiply-adds.
//  * The stages of a step depend on each other (B'S; then G, H and S·A; the
//    Cholesky, whose M pivots are sequential; the N+1 solves, one column a
//    thread; H·K; the value update), so the lane's threads meet at a named
//    barrier (bar.sync lane+1, TPL) between them.  Lanes of a block never
//    wait for each other inside a step.
//  * Loads are coalesced ACROSS lanes.  A block that read one lane's element
//    e at e*B + b would use 4 bytes of each 32-byte sector.  Instead the
//    whole block copies a step's inputs together: thread i takes element
//    i / LPB of lane i % LPB, so LPB consecutive lanes make 4*LPB contiguous
//    bytes.  The copy is asynchronous (cp.async, 4 or 8 bytes each) into one
//    of two staging buffers: the inputs of step t-1 travel while step t is
//    computed, and the one __syncthreads() of a step is where they are
//    handed over.  Gains are written the same way, from a double buffer,
//    one step late.
//  * The ragged edge: lanes at or beyond B are not copied (their staging
//    stays zero, their reg is 1) and not stored.
//  * Two lanes a block is a compromise for the batches this package sends
//    (64 to 256 lanes): more lanes a block would read whole sectors but
//    leave most of the card's 132 SMs without a block.  A wider batch may
//    want more; that shape belongs with the workload that sends it.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 outside the tensor
// cores).  A lane and step reads 2N^2 + 2NM + M^2 + N + M values (856 at
// (16, 8), 1908 at (24, 12)) and writes M + MN (136, 300).  At B = 256,
// T = 1000, float32, (16, 8): 1.02 GB, 0.30 ms.  Its arithmetic is about
// 21.6 k multiply-adds a lane and step (43 kFLOP; S·A and A'(S·A) are 16 k of
// them), 11 GFLOP a launch: 0.17 ms.  Bytes bound it, by a factor of two.
//
// Predicted before the first run on the card, when the block shape was still
// a template argument (LPB, TPL): the products read shared
// memory for every multiply-add (0.5 loads each), so the kernel is bound by
// shared-memory loads and instruction dispatch, not by device memory: about
// 2000 to 2500 cycles a step for a block of 8 lanes, 1.5 to 3 ms at
// B = 256, T = 1000 in float32 (5 to 10 times the bound) with the best
// (LPB, TPL), and more with 8 lanes a block, which leaves 100 of 132 SMs
// idle at B = 256.  float64: two to three times the float32 time.  At
// (24, 12), B = 64, T = 50: 0.2 to 0.4 ms against a bound of 8 us — 64 lanes
// cannot fill the card, and 50 dependent steps are 50 round trips.
// Measured times are in PERF.md.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace riccati_wide {

constexpr int LPB = 2;    // lanes a block
constexpr int TPL = 64;   // threads a lane
constexpr int NTHREADS = LPB * TPL;
constexpr int kMaxSharedBytes = 232448;   // 227 KB: what a Hopper block may use

template <typename T> __device__ __forceinline__ T rsqrt_(T x);
template <> __device__ __forceinline__ float rsqrt_<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_<double>(double x) { return rsqrt(x); }

template <typename T> struct alignas(16) Vec4 { T v[4]; };

// Element offsets inside one lane's region of shared memory.
template <int N, int M> struct Layout {
  // One step's inputs, in the order they are staged (two buffers).
  static constexpr int A = 0;
  static constexpr int Bm = A + N * N;
  static constexpr int qx = Bm + N * M;
  static constexpr int ru = qx + N;
  static constexpr int Qxx = ru + M;
  static constexpr int Pux = Qxx + N * N;
  static constexpr int Ruu = Pux + M * N;
  static constexpr int IN = Ruu + M * M;
  // The carry and the step's intermediates.
  static constexpr int S = 2 * IN;
  static constexpr int SA = S + N * N;
  static constexpr int Sn = SA + N * N;
  static constexpr int BtS = Sn + N * N;
  static constexpr int G = BtS + M * N;
  static constexpr int W = G + M * N;
  static constexpr int H = W + M * N;
  static constexpr int L = H + M * M;
  static constexpr int s = L + M * M;
  static constexpr int g = s + N;
  static constexpr int Hd = g + M;
  static constexpr int invd = Hd + M;
  // This step's outputs, duff [M] then K [M][N] (two buffers).
  static constexpr int OUT = M + M * N;
  static constexpr int out = invd + M;
  static constexpr int USED = out + 2 * OUT;
  // Lane regions 4 (mod 32) elements apart: the block-wide copies touch
  // LPB lanes with one warp, and this keeps them on different banks.
  static constexpr int LANE = USED + ((4 - USED % 32) + 32) % 32;
};

// The barrier of one lane's threads: named barrier lane+1 (0 is the block's).
__device__ __forceinline__ void lane_sync(int lane) {
  asm volatile("bar.sync %0, %1;" ::"r"(lane + 1), "r"(TPL) : "memory");
}

// C[i][j] = (C0 ? C0[i][j] : 0) + sum_k a(i, k) * Bk[k][j] for an I x J
// result, by the TPL threads of a lane: thread `lt` takes the 1x4 tiles
// lt - rot, lt - rot + TPL, ...  a(i, k) is A[i * a_si + k * a_sk], so a
// transposed left factor costs nothing.  C0 may be C.
template <typename T, int I, int J, int K>
__device__ __forceinline__ void lane_gemm(const T* A, int a_si, int a_sk,
                                          const T* Bk, const T* C0, T* C,
                                          int lt, int rot) {
  constexpr int JT = J / 4;
  for (int tile = (lt - rot + TPL) % TPL; tile < I * JT; tile += TPL) {
    const int i = tile / JT;
    const int j0 = (tile % JT) * 4;
    Vec4<T> acc;
    if (C0 != nullptr) {
      acc = *reinterpret_cast<const Vec4<T>*>(C0 + i * J + j0);
    } else {
      acc.v[0] = acc.v[1] = acc.v[2] = acc.v[3] = T(0);
    }
    const T* a = A + i * a_si;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const T aik = a[k * a_sk];
      const Vec4<T> b = *reinterpret_cast<const Vec4<T>*>(Bk + k * J + j0);
      acc.v[0] += aik * b.v[0];
      acc.v[1] += aik * b.v[1];
      acc.v[2] += aik * b.v[2];
      acc.v[3] += aik * b.v[3];
    }
    *reinterpret_cast<Vec4<T>*>(C + i * J + j0) = acc;
  }
}

// The whole block copies COUNT elements of each of its lanes from a
// batch-last array (src points at the block's first lane) into the lanes'
// regions at element offset dst_off.
template <typename T, int COUNT, int LANE>
__device__ __forceinline__ void stage_in(T* smem, int dst_off, const T* src,
                                         long long B, int nvalid, int tid) {
  for (int i = tid; i < COUNT * LPB; i += NTHREADS) {
    const int l = i % LPB;
    const int e = i / LPB;
    if (l < nvalid) {
      __pipeline_memcpy_async(smem + l * LANE + dst_off + e,
                              src + (long long)e * B + l, sizeof(T));
    }
  }
}

template <typename T, int N, int M>
__global__ void __launch_bounds__(NTHREADS)
riccati_wide_kernel(const T* __restrict__ As, const T* __restrict__ Bs,
                    const T* __restrict__ qx, const T* __restrict__ ru,
                    const T* __restrict__ Qxx, const T* __restrict__ Pux,
                    const T* __restrict__ Ruu, const T* __restrict__ qxN,
                    const T* __restrict__ QN, const T* __restrict__ reg,
                    T* __restrict__ duffs, T* __restrict__ Ks,
                    T* __restrict__ dv1, T* __restrict__ dv2, int T_steps,
                    long long B, int symmetrize) {
  static_assert(N % 4 == 0 && M % 4 == 0, "1x4 tiles need N, M multiples of 4");
  static_assert(N + 1 <= 32 && M <= 32, "one warp solves all N+1 columns");
  using Lay = Layout<N, M>;
  constexpr int LANE = Lay::LANE;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid / TPL;   // which of the block's lanes
  const int lt = tid % TPL;     // which of the lane's threads
  const long long b0 = (long long)blockIdx.x * LPB;
  const int nvalid = (B - b0 < LPB) ? (int)(B - b0) : LPB;
  const bool valid = lane < nvalid;
  const long long b = b0 + lane;
  T* my = smem + lane * LANE;

  for (int i = tid; i < LPB * LANE; i += NTHREADS) smem[i] = T(0);
  __syncthreads();

  // The carry, seeded from the terminal cost.
  if (valid) {
    for (int i = lt; i < N * N; i += TPL) my[Lay::S + i] = QN[(long long)i * B + b];
    for (int i = lt; i < N; i += TPL) my[Lay::s + i] = qxN[(long long)i * B + b];
  }
  const T reg_b = valid ? reg[b] : T(1);
  const T half = T(0.5);
  T dv1_acc = T(0), dv2_acc = T(0);   // kept by the lane's thread 0

  auto prefetch = [&](int t) {
    const int off = (t & 1) * Lay::IN;
    const long long tt = t;
    stage_in<T, N * N, LANE>(smem, off + Lay::A, As + tt * N * N * B + b0, B, nvalid, tid);
    stage_in<T, N * M, LANE>(smem, off + Lay::Bm, Bs + tt * N * M * B + b0, B, nvalid, tid);
    stage_in<T, N, LANE>(smem, off + Lay::qx, qx + tt * N * B + b0, B, nvalid, tid);
    stage_in<T, M, LANE>(smem, off + Lay::ru, ru + tt * M * B + b0, B, nvalid, tid);
    stage_in<T, N * N, LANE>(smem, off + Lay::Qxx, Qxx + tt * N * N * B + b0, B, nvalid, tid);
    stage_in<T, M * N, LANE>(smem, off + Lay::Pux, Pux + tt * M * N * B + b0, B, nvalid, tid);
    stage_in<T, M * M, LANE>(smem, off + Lay::Ruu, Ruu + tt * M * M * B + b0, B, nvalid, tid);
  };

  // The whole block writes the gains of step t (duff, then K) of its lanes.
  auto store_out = [&](int t) {
    const int off = Lay::out + (t & 1) * Lay::OUT;
    T* duff_t = duffs + (long long)t * M * B + b0;
    T* K_t = Ks + (long long)t * M * N * B + b0;
    for (int i = tid; i < Lay::OUT * LPB; i += NTHREADS) {
      const int l = i % LPB;
      const int e = i / LPB;
      if (l < nvalid) {
        const T v = smem[l * LANE + off + e];
        if (e < M) {
          duff_t[(long long)e * B + l] = v;
        } else {
          K_t[(long long)(e - M) * B + l] = v;
        }
      }
    }
  };

  if (T_steps > 0) prefetch(T_steps - 1);
  __pipeline_commit();

  for (int t = T_steps - 1; t >= 0; --t) {
    // Step t's inputs have landed, and every lane is done with step t+1:
    // its staging buffer and the gain buffer of step t+2 are free.
    __pipeline_wait_prior(0);
    __syncthreads();
    if (t > 0) prefetch(t - 1);
    __pipeline_commit();
    if (t < T_steps - 1) store_out(t + 1);

    const T* in = my + (t & 1) * Lay::IN;
    const T* A_ = in + Lay::A;
    const T* Bm_ = in + Lay::Bm;
    T* S_ = my + Lay::S;
    T* s_ = my + Lay::s;
    T* SA_ = my + Lay::SA;
    T* Sn_ = my + Lay::Sn;
    T* BtS_ = my + Lay::BtS;
    T* G_ = my + Lay::G;
    T* W_ = my + Lay::W;
    T* H_ = my + Lay::H;
    T* L_ = my + Lay::L;
    T* g_ = my + Lay::g;
    T* Hd_ = my + Lay::Hd;
    T* invd_ = my + Lay::invd;
    T* duff_ = my + Lay::out + (t & 1) * Lay::OUT;
    T* K_ = duff_ + M;

    // 1. BtS = B'S,  g = ru + B's.
    lane_gemm<T, M, N, N>(Bm_, 1, M, S_, nullptr, BtS_, lt, 0);
    if (lt < M) {
      T acc = in[Lay::ru + lt];
      for (int k = 0; k < N; ++k) acc += Bm_[k * M + lt] * s_[k];
      g_[lt] = acc;
    }
    lane_sync(lane);

    // 2. G = Pux + BtS A,  H = Ruu + BtS B,  SA = S A.
    lane_gemm<T, M, N, N>(BtS_, N, 1, A_, in + Lay::Pux, G_, lt, 0);
    lane_gemm<T, M, M, N>(BtS_, N, 1, Bm_, in + Lay::Ruu, H_, lt,
                               (M * N / 4) % TPL);
    lane_gemm<T, N, N, N>(S_, N, 1, A_, nullptr, SA_, lt, 0);
    lane_sync(lane);

    // 3. Cholesky-Crout of H + reg I by the lane's first warp, one column
    // a round: thread i owns row i.  Every thread recomputes the pivot.
    if (lt < 32) {
      for (int j = 0; j < M; ++j) {
        T piv = H_[j * M + j] + reg_b;
        for (int k = 0; k < j; ++k) piv -= L_[j * M + k] * L_[j * M + k];
        const T r = rsqrt_<T>(piv);
        if (lt == j) {
          L_[j * M + j] = piv * r;
          invd_[j] = r;
        } else if (lt > j && lt < M) {
          T acc = H_[lt * M + j];
          for (int k = 0; k < j; ++k) acc -= L_[lt * M + k] * L_[j * M + k];
          L_[lt * M + j] = acc * r;
        }
        __syncwarp();
      }
    }
    lane_sync(lane);

    // 4. duff = -(H + reg I)^-1 g,  K = -(H + reg I)^-1 G: thread c < N
    // solves column c of G, thread N solves g.
    if (lt <= N) {
      T x[M];
#pragma unroll
      for (int a = 0; a < M; ++a) x[a] = (lt < N) ? G_[a * N + lt] : g_[a];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        T acc = x[i];
#pragma unroll
        for (int j = 0; j < i; ++j) acc -= L_[i * M + j] * x[j];
        x[i] = acc * invd_[i];
      }
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
        T acc = x[i];
#pragma unroll
        for (int j = i + 1; j < M; ++j) acc -= L_[j * M + i] * x[j];
        x[i] = acc * invd_[i];
      }
      if (lt < N) {
#pragma unroll
        for (int a = 0; a < M; ++a) K_[a * N + lt] = -x[a];
      } else {
#pragma unroll
        for (int a = 0; a < M; ++a) duff_[a] = -x[a];
      }
    }
    lane_sync(lane);

    // 5. W = G + H K (so that K'HK + K'G = K'W),  Hd = H duff (raw H).
    lane_gemm<T, M, N, M>(H_, M, 1, K_, G_, W_, lt, 0);
    if (lt >= TPL - M) {
      const int a = lt - (TPL - M);
      T acc = T(0);
      for (int c = 0; c < M; ++c) acc += H_[a * M + c] * duff_[c];
      Hd_[a] = acc;
    }
    lane_sync(lane);

    // 6. Sn = Qxx + A'(SA) + K'W + G'K,  s_next likewise (in a register),
    // and the expected-decrease sums.
    lane_gemm<T, N, N, N>(A_, 1, N, SA_, in + Lay::Qxx, Sn_, lt, 0);
    lane_gemm<T, N, N, M>(K_, 1, N, W_, Sn_, Sn_, lt, 0);
    lane_gemm<T, N, N, M>(G_, 1, N, K_, Sn_, Sn_, lt, 0);
    T s_next = T(0);
    if (lt < N) {
      T acc = in[Lay::qx + lt];
      for (int k = 0; k < N; ++k) acc += A_[k * N + lt] * s_[k];
      for (int a = 0; a < M; ++a)
        acc += K_[a * N + lt] * (Hd_[a] + g_[a]) + G_[a * N + lt] * duff_[a];
      s_next = acc;
    }
    if (lt == TPL - 1) {
      T dg = T(0), dHd = T(0);
      for (int a = 0; a < M; ++a) {
        dg += duff_[a] * g_[a];
        dHd += duff_[a] * Hd_[a];
      }
      dv1_acc += dg;
      dv2_acc += half * dHd;
    }
    lane_sync(lane);

    // 7. The new carry: S = (Sn + Sn')/2 if symmetrize, else Sn.
    for (int i = lt; i < N * N; i += TPL) {
      const int r = i / N, c = i % N;
      S_[i] = symmetrize ? half * (Sn_[i] + Sn_[c * N + r]) : Sn_[i];
    }
    if (lt < N) s_[lt] = s_next;
  }

  __syncthreads();
  if (T_steps > 0) store_out(0);
  if (valid && lt == TPL - 1) {
    dv1[b] = dv1_acc;
    dv2[b] = dv2_acc;
  }
}

}  // namespace riccati_wide

namespace {

template <typename T, int N, int M>
int launch(const void* As, const void* Bs, const void* qx, const void* ru,
           const void* Qxx, const void* Pux, const void* Ruu, const void* qxN,
           const void* QN, const void* reg, void* duffs, void* Ks, void* dv1,
           void* dv2, int T_steps, long long B, int symmetrize, void* stream) {
  using namespace riccati_wide;
  constexpr size_t bytes = sizeof(T) * (size_t)LPB * Layout<N, M>::LANE;
  static_assert(bytes <= (size_t)kMaxSharedBytes, "lanes do not fit a block");
  if (B <= 0 || T_steps < 0) return (int)cudaErrorInvalidValue;
  auto kernel = riccati_wide_kernel<T, N, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + LPB - 1) / LPB));
  kernel<<<grid, dim3(NTHREADS), bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(As), static_cast<const T*>(Bs),
      static_cast<const T*>(qx), static_cast<const T*>(ru),
      static_cast<const T*>(Qxx), static_cast<const T*>(Pux),
      static_cast<const T*>(Ruu), static_cast<const T*>(qxN),
      static_cast<const T*>(QN), static_cast<const T*>(reg),
      static_cast<T*>(duffs), static_cast<T*>(Ks), static_cast<T*>(dv1),
      static_cast<T*>(dv2), T_steps, B, symmetrize);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one function per instantiation, as riccati.cu's: raw
// device pointers, T, B, symmetrize (0/1) and the CUDA stream; returns
// cudaGetLastError().
#define RICCATI_WIDE_EXPORT(NAME, SCALAR, N, M)                               \
  extern "C" int NAME(const void* As, const void* Bs, const void* qx,         \
                      const void* ru, const void* Qxx, const void* Pux,       \
                      const void* Ruu, const void* qxN, const void* QN,       \
                      const void* reg, void* duffs, void* Ks, void* dv1,      \
                      void* dv2, int T, long long B, int symmetrize,          \
                      void* stream) {                                         \
    return launch<SCALAR, N, M>(As, Bs, qx, ru, Qxx, Pux, Ruu, qxN, QN, reg,  \
                                duffs, Ks, dv1, dv2, T, B, symmetrize,        \
                                stream);                                      \
  }

RICCATI_WIDE_EXPORT(riccati_cuda_16x8_f32, float, 16, 8)
RICCATI_WIDE_EXPORT(riccati_cuda_16x8_f64, double, 16, 8)
RICCATI_WIDE_EXPORT(riccati_cuda_24x12_f32, float, 24, 12)
RICCATI_WIDE_EXPORT(riccati_cuda_24x12_f64, double, 24, 12)
