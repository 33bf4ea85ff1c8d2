// K2: pairwise L2 distance matrix of the clustering layer, (n, d) -> (n, n).
//
// Replaces scema_tpu/ops/pairwise_pallas.py::_dist_kernel (launched by
// pairwise_l2_pallas), the TPU kernel behind the strain-history similarity
// graph (the reference's ring comparison, strain2spline.h:546-614).
//
// What bounds it on an H100: at the slice's size (n = 576 qps, d = 6 x 10
// spline points = 60) nothing much: n^2 d = 20 M subtract-square-adds, under
// a microsecond at the card's float32 rate, and a 138 KB input; a launch
// costs more.  At n = 4608 it is 1.3 G subtract-square-adds against an 85 MB
// output written once, so the float32 pipes bound it.
//
// Distances are taken by direct differencing, as on the TPU: the
// |a|^2 + |b|^2 - 2ab identity (a GEMM on the tensor cores) would cancel
// catastrophically in float32 against the 1e-6 similarity threshold.  Every
// element is fmaf(diff, diff, acc) over k = 0, 1, ..., d - 1 from acc = 0,
// then sqrtf, in both designs, so the two agree bit for bit; (j, i) squares
// the negated differences of (i, j), so the matrix is exactly symmetric.
//
// Design (pairwise_l2_f32): one block per tile pair (bi <= bj) of the upper
// triangle, 256 threads, each with an R x R register tile: T = 64, R = 4
// where that grid gives every SM two blocks (n >~ 1500 on an H100), else
// T = 32, R = 2, so that a small n (the slice's 576: 171 blocks instead of
// 45) spreads over the SMs and each thread's chain is 4 outputs long, not
// 16.  (Measured on an H100 by device time, the crossover lies between
// n = 1152, where 32 wins, and 2304, where 64 does.)  The two T-row
// panels are staged k-major in shared memory, KC columns at a time (any d),
// so per k a thread reads one R-vector of each panel (float4 or float2) and
// does R * R subtract + FMA pairs.  The finished tile goes through a padded
// shared buffer and is written twice, as itself and transposed into the
// mirror tile, both stores coalesced; a diagonal tile is written once.  The
// ragged edge is masked in the kernel (rows past n stage as zeros and are
// not written).
//
// The first design (pairwise_l2_first_f32, kept for the checks only): a
// block per 32 x 32 tile of the full square, 4 outputs per thread, 5 shared
// loads per 4 subtract + FMA pairs; every off-diagonal pair computed twice.
#include <cuda_runtime.h>

namespace {

constexpr int KC = 32;  // panel columns staged per pass
constexpr int THREADS = 256;

// one R-vector of a k-major panel row (16- or 8-byte aligned)
template <int R>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[R]);
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x, v[1] = q.y;
}

template <int T>
struct Panels {
  float a[KC][T + 4];  // rows padded to keep the vectors aligned
  float b[KC][T + 4];
};
template <int T>
union Smem {
  Panels<T> p;
  float tile[T][T + 1];  // the finished tile, padded against bank conflicts
};

template <int T, int R>
__global__ void __launch_bounds__(THREADS)
pairwise_l2_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int d,
                   int nb) {
  static_assert((T / R) * (T / R) == THREADS, "one R x R register tile per thread");
  __shared__ __align__(16) Smem<T> s;
  // tile pair of the upper triangle: row-major over bi, bj >= bi
  int bi = 0, rem = blockIdx.x;
  while (rem >= nb - bi) {
    rem -= nb - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int i0 = bi * T, j0 = bj * T;
  const int tid = threadIdx.x;
  const int tx = tid % (T / R), ty = tid / (T / R);

  float acc[R][R];
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < R; ++q) acc[p][q] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    const int kmax = min(KC, d - k0);
    // stage both panels k-major; consecutive threads take consecutive rows,
    // so the shared stores hit distinct banks
    for (int idx = tid; idx < T * KC; idx += THREADS) {
      const int r = idx % T, c = idx / T;
      const bool kin = c < kmax;
      s.p.a[c][r] = (kin && i0 + r < n) ? x[(size_t)(i0 + r) * d + k0 + c] : 0.f;
      s.p.b[c][r] = (kin && j0 + r < n) ? x[(size_t)(j0 + r) * d + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kmax; ++c) {
      float ar[R], br[R];
      load_vec<R>(&s.p.a[c][ty * R], ar);
      load_vec<R>(&s.p.b[c][tx * R], br);
#pragma unroll
      for (int p = 0; p < R; ++p)
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float diff = ar[p] - br[q];
          acc[p][q] = fmaf(diff, diff, acc[p][q]);
        }
    }
    __syncthreads();
  }

  // the finished tile through shared memory (the panels are done with)
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < R; ++q) s.tile[ty * R + p][tx * R + q] = sqrtf(acc[p][q]);
  __syncthreads();
  // the tile itself: consecutive threads along a row of out
  for (int idx = tid; idx < T * T; idx += THREADS) {
    const int r = idx / T, c = idx % T;
    if (i0 + r < n && j0 + c < n) out[(size_t)(i0 + r) * n + j0 + c] = s.tile[r][c];
  }
  if (bi == bj) return;
  // the mirror tile: out[j0 + c][i0 + r] = tile[r][c], consecutive threads
  // along a row of out (down a column of the padded tile)
  for (int idx = tid; idx < T * T; idx += THREADS) {
    const int c = idx / T, r = idx % T;
    if (i0 + r < n && j0 + c < n) out[(size_t)(j0 + c) * n + i0 + r] = s.tile[r][c];
  }
}

template <int T, int R>
int launch(const float* x, float* out, int n, int d, cudaStream_t stream) {
  const int nb = (n + T - 1) / T;
  pairwise_l2_kernel<T, R><<<nb * (nb + 1) / 2, THREADS, 0, stream>>>(x, out, n, d, nb);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- first design

constexpr int TILE1 = 32;  // output tile edge
constexpr int KC1 = 64;    // columns staged per pass
constexpr int ROWS1 = 8;   // threadIdx.y extent; each thread owns TILE1/ROWS1 rows

__global__ void pairwise_l2_first_kernel(const float* __restrict__ x,
                                         float* __restrict__ out, int n, int d) {
  __shared__ float a[TILE1][KC1 + 1];
  __shared__ float b[TILE1][KC1 + 1];
  const int i0 = blockIdx.y * TILE1;
  const int j0 = blockIdx.x * TILE1;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE1 + tx;
  float acc[TILE1 / ROWS1];
#pragma unroll
  for (int q = 0; q < TILE1 / ROWS1; ++q) acc[q] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC1) {
    for (int idx = tid; idx < TILE1 * KC1; idx += TILE1 * ROWS1) {
      const int r = idx / KC1;
      const int c = idx % KC1;
      const int k = k0 + c;
      a[r][c] = (i0 + r < n && k < d) ? x[(size_t)(i0 + r) * d + k] : 0.f;
      b[r][c] = (j0 + r < n && k < d) ? x[(size_t)(j0 + r) * d + k] : 0.f;
    }
    __syncthreads();
    const int kmax = min(KC1, d - k0);
    for (int c = 0; c < kmax; ++c) {
      const float bv = b[tx][c];
#pragma unroll
      for (int q = 0; q < TILE1 / ROWS1; ++q) {
        const float diff = a[ty + ROWS1 * q][c] - bv;
        acc[q] = fmaf(diff, diff, acc[q]);
      }
    }
    __syncthreads();
  }
  const int j = j0 + tx;
#pragma unroll
  for (int q = 0; q < TILE1 / ROWS1; ++q) {
    const int i = i0 + ty + ROWS1 * q;
    if (i < n && j < n) out[(size_t)i * n + j] = sqrtf(acc[q]);
  }
}

}  // namespace

// tile: 64 or 32, or 0 for the rule above (64 where its grid gives every SM
// two blocks)
extern "C" int pairwise_l2_f32(const float* x, float* out, int n, int d, int tile,
                               void* stream) {
  if (tile == 0) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long nb = (n + 63) / 64;
    tile = nb * (nb + 1) / 2 >= 2L * sms ? 64 : 32;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 64) return launch<64, 4>(x, out, n, d, st);
  if (tile == 32) return launch<32, 2>(x, out, n, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pairwise_l2_first_f32(const float* x, float* out, int n, int d,
                                     void* stream) {
  dim3 block(TILE1, ROWS1);
  dim3 grid((n + TILE1 - 1) / TILE1, (n + TILE1 - 1) / TILE1);
  pairwise_l2_first_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(x, out,
                                                                                   n, d);
  return static_cast<int>(cudaGetLastError());
}
