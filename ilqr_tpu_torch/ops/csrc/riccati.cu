// Fused backward Riccati recursion of a scenario batch, one launch.
//
// Replaces the TPU kernel ilqr_tpu/ops/pallas_riccati.py::_riccati_kernel
// (launched by _riccati_pallas_call, fed by riccati_scan_pallas_bl).  It
// computes what that kernel computes; it is not a block-by-block copy.
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
// and writes duff [T,M,B], K [T,M,N,B], dv1 = sum_t duff.g [B],
// dv2 = 1/2 sum_t duff.H.duff [B].
//
// Layout: every array is batch-LAST, element (t, i, j, b) of As at
// ((t*N + i)*N + j)*B + b.
//
// Design.  One thread per lane.  The time loop runs inside the kernel and
// takes the place of the TPU kernel's sequential grid dimension; the carry,
// every intermediate and the dv1/dv2 sums live in registers (N=4: 16+4
// carry values), where the TPU kernel kept them in on-chip scratch memory
// between grid steps and wrote dv1/dv2 per step for a sum outside.  Thread
// b reads element [..., b], so the 32 threads of a warp read 32 consecutive
// values: every load and store is coalesced and no shared memory is
// needed.  The ragged edge is `if (b >= B) return;` — no padding of the
// batch, no time blocking, no tile-shape knobs.
//
// Bound on an H100 (3.35 TB/s): the launch reads N*N+N*M+N+M+N*N+M*N+M*M
// values per lane and step (58 for N=4, M=2) and writes M+M*N (10), so at
// B=4096, T=100, float32 it moves about 111 MB: 33 us.  Its arithmetic
// (about 750 flops per lane and step, 0.3 GFLOP) needs under 5 us at the
// card's 67 TFLOP/s float32 rate, so bytes bound it.  This first version is
// expected to sit well above that bound: 4096 lanes are 128 warps, about
// one per SM, and each thread runs T dependent steps whose loads it cannot
// start before the loop reaches them, so it is bound by latency, not by
// bandwidth.  Blocks are one warp wide to spread those warps over all SMs.
// Measured times are in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <typename T> __device__ __forceinline__ T rsqrt_(T x);
template <> __device__ __forceinline__ float rsqrt_<float>(float x) { return rsqrtf(x); }
template <> __device__ __forceinline__ double rsqrt_<double>(double x) { return rsqrt(x); }

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

template <typename scalar_t, int N, int M, bool SYMMETRIZE>
__global__ void __launch_bounds__(kThreads)
riccati_kernel(const scalar_t* __restrict__ As, const scalar_t* __restrict__ Bs,
               const scalar_t* __restrict__ qx, const scalar_t* __restrict__ ru,
               const scalar_t* __restrict__ Qxx, const scalar_t* __restrict__ Pux,
               const scalar_t* __restrict__ Ruu, const scalar_t* __restrict__ qxN,
               const scalar_t* __restrict__ QN, const scalar_t* __restrict__ reg,
               scalar_t* __restrict__ duffs, scalar_t* __restrict__ Ks,
               scalar_t* __restrict__ dv1, scalar_t* __restrict__ dv2,
               int T, long long B) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

  const scalar_t half = scalar_t(0.5);
  const scalar_t reg_b = reg[b];

  scalar_t S[N][N], s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = qxN[i * B + b];
#pragma unroll
    for (int j = 0; j < N; ++j) S[i][j] = QN[(i * N + j) * B + b];
  }
  scalar_t dv1_acc = scalar_t(0), dv2_acc = scalar_t(0);

  for (int t = T - 1; t >= 0; --t) {
    // This step's local model, lane b.
    const scalar_t* A_t = As + (long long)t * N * N * B + b;
    const scalar_t* B_t = Bs + (long long)t * N * M * B + b;
    const scalar_t* qx_t = qx + (long long)t * N * B + b;
    const scalar_t* ru_t = ru + (long long)t * M * B + b;
    const scalar_t* Qxx_t = Qxx + (long long)t * N * N * B + b;
    const scalar_t* Pux_t = Pux + (long long)t * M * N * B + b;
    const scalar_t* Ruu_t = Ruu + (long long)t * M * M * B + b;

    scalar_t A[N][N], Bm[N][M], G[M][N], H[M][M], g[M], s_next[N], S_next[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s_next[i] = qx_t[i * B];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        A[i][j] = A_t[(i * N + j) * B];
        S_next[i][j] = Qxx_t[(i * N + j) * B];
      }
#pragma unroll
      for (int j = 0; j < M; ++j) Bm[i][j] = B_t[(i * M + j) * B];
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      g[a] = ru_t[a * B];
#pragma unroll
      for (int j = 0; j < N; ++j) G[a][j] = Pux_t[(a * N + j) * B];
#pragma unroll
      for (int c = 0; c < M; ++c) H[a][c] = Ruu_t[(a * M + c) * B];
    }

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

    // Outputs of this step.
    scalar_t* duff_t = duffs + (long long)t * M * B + b;
    scalar_t* K_t = Ks + (long long)t * M * N * B + b;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      duff_t[a * B] = duff[a];
#pragma unroll
      for (int j = 0; j < N; ++j) K_t[(a * N + j) * B] = K[a][j];
    }

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
  }

  dv1[b] = dv1_acc;
  dv2[b] = dv2_acc;
}

template <typename scalar_t, int N, int M>
int launch(const void* As, const void* Bs, const void* qx, const void* ru,
           const void* Qxx, const void* Pux, const void* Ruu, const void* qxN,
           const void* QN, const void* reg, void* duffs, void* Ks, void* dv1,
           void* dv2, int T, long long B, int symmetrize, void* stream) {
  if (B <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads));
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RICCATI_ARGS                                                          \
  static_cast<const scalar_t*>(As), static_cast<const scalar_t*>(Bs),         \
      static_cast<const scalar_t*>(qx), static_cast<const scalar_t*>(ru),     \
      static_cast<const scalar_t*>(Qxx), static_cast<const scalar_t*>(Pux),   \
      static_cast<const scalar_t*>(Ruu), static_cast<const scalar_t*>(qxN),   \
      static_cast<const scalar_t*>(QN), static_cast<const scalar_t*>(reg),    \
      static_cast<scalar_t*>(duffs), static_cast<scalar_t*>(Ks),              \
      static_cast<scalar_t*>(dv1), static_cast<scalar_t*>(dv2), T, B
  if (symmetrize)
    riccati_kernel<scalar_t, N, M, true><<<grid, block, 0, st>>>(RICCATI_ARGS);
  else
    riccati_kernel<scalar_t, N, M, false><<<grid, block, 0, st>>>(RICCATI_ARGS);
#undef RICCATI_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, one function per instantiation: raw device pointers,
// T, B, symmetrize (0/1) and the CUDA stream; returns cudaGetLastError().
#define RICCATI_EXPORT(NAME, SCALAR, N, M)                                    \
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

RICCATI_EXPORT(riccati_cuda_4x2_f32, float, 4, 2)
RICCATI_EXPORT(riccati_cuda_4x2_f64, double, 4, 2)
