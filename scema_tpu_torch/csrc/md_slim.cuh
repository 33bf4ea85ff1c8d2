// P1's shared device code: the operands, the slot layouts, the deform
// path, the thermostat chain, the minimum image and the int8 images, and the
// variant table.  Included by md_slim.cu (the first design) and
// md_slim_ring.cu (the Hopper redesign), so both run the same arithmetic;
// design notes in each source.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NHC = 3;
constexpr int MAXW = 32;       // warps in a 1024-thread block
constexpr int MISC = 8;        // chain (3), velocity scale, image-overflow mark
constexpr int R_REFRESH = 20;  // steps per image-cache chunk
constexpr int FS = 20, IS = 2, SACC = 8;
constexpr int TILE = 32;  // v8's tile: one warp's atoms
enum { FULL = 0, ATOMIC = 1, PARTIALS = 2, SHUFFLE = 3 };  // pair schedules
enum { SIG = 0, LJ = 1, RSQRT = 2 };                     // force forms

// mirrored field for field by ops/md_slim._SlimArgs
struct SlimArgs {
  const float* state;  // (P, 8, M) rows x y z vx vy vz 1/m m, M = J N atoms
  float* out;          // (P, 8, M)
  float* sacc;         // (P, 8): vxi0 vxi1 vxi2, 2 KE, zeros
  const float* w4e;    // the planes in the variant's slot layout, one copy for
  const float* sig2;   //   every program and job
  const int* iscal;    // (P, 2): n_run, n_tot
  const float* fscal;  // (P, 20): dt, T, h0 (6), eps (6), vxi (3)
  char4* img;          // (P, J, slots) cached images (n1, n2, n3, 0); null for v1
  int P, N, J;
  float cutoff2, r2min, boltz, tdamp, sig2u, ndof;
};

struct Box {
  float lx, ly, lz, xy, xz, yz;
};

template <int NEWTON>
__host__ __device__ __forceinline__ int slots_per_job(int N) {
  if (NEWTON == FULL) return N * N;
  if (NEWTON == SHUFFLE) return (N / TILE) * (N / TILE + 1) / 2 * TILE * TILE;
  return N / 2 * N;
}

// tile pair q -> (a, b), a <= b, in the order of ops/md_slim.layout_pairs
__device__ __forceinline__ void tile_pair(int q, int T, int& a, int& b) {
  a = 0;
  while (q >= T - a) { q -= T - a; ++a; }
  b = a + q;
}

// (i, j) of slot o of one job's layout; false for the unused slots of the
// half shell (d = N/2 with i >= N/2)
template <int NEWTON>
__device__ __forceinline__ bool slot_pair(int o, int N, int& i, int& j) {
  if constexpr (NEWTON == FULL) {
    j = o / N;
    i = o - j * N;
    return true;
  } else if constexpr (NEWTON == SHUFFLE) {
    const int k = (o >> 5) & 31, l = o & 31;
    int a, b;
    tile_pair(o >> 10, N / TILE, a, b);
    i = a * TILE + l;
    j = b * TILE + ((l + k) & 31);
    return true;
  } else {
    const int d = o / N + 1;
    i = o - (d - 1) * N;
    j = i + d;
    if (j >= N) j -= N;
    return !(2 * d == N && 2 * i >= N);
  }
}

__device__ __forceinline__ Box h_at(const float* h0, const float* eps, float frac) {
  Box h;
  h.lx = h0[0] * (1.f + frac * eps[0]);
  h.ly = h0[1] * (1.f + frac * eps[1]);
  h.lz = h0[2] * (1.f + frac * eps[2]);
  h.xy = h0[3] + frac * eps[3] * h0[1];
  h.xz = h0[4] + frac * eps[4] * h0[2];
  h.yz = h0[5] + frac * eps[5] * h0[2];
  return h;
}

// Sum over the block; every thread receives the total.  Warp shuffles, then
// the warp partials in warp order: a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  __syncthreads();
  return s;
}

// the lab's nhc_half given the block's 2 KE: thread 0 advances the chain in
// misc[0..2] and leaves the velocity scale in misc[NHC]; block-synced
__device__ void nhc_chain(float ke, float* misc, float dt, float kt, float ndof, float tdamp) {
  if (threadIdx.x == 0) {
    float* vxi = misc;
    const float q0 = ndof * kt * (tdamp * tdamp);
    const float q1 = kt * (tdamp * tdamp);
    const float dt2 = dt / 2.f, dt4 = dt / 4.f, dt8 = dt / 8.f;
    vxi[2] = vxi[2] + dt4 * ((q1 * vxi[1] * vxi[1] - kt) / q1);
    float s = expf(-dt8 * vxi[2]);
    vxi[1] = s * (s * vxi[1] + dt4 * ((q0 * vxi[0] * vxi[0] - kt) / q1));
    s = expf(-dt8 * vxi[1]);
    vxi[0] = s * (s * vxi[0] + dt4 * ((ke - ndof * kt) / q0));
    const float scale = expf(-dt2 * vxi[0]);
    ke = ke * scale * scale;
    s = expf(-dt8 * vxi[1]);
    vxi[0] = s * (s * vxi[0] + dt4 * ((ke - ndof * kt) / q0));
    s = expf(-dt8 * vxi[2]);
    vxi[1] = s * (s * vxi[1] + dt4 * ((q0 * vxi[0] * vxi[0] - kt) / q1));
    vxi[2] = vxi[2] + dt4 * ((q1 * vxi[1] * vxi[1] - kt) / q1);
    misc[NHC] = scale;
  }
  __syncthreads();
}

// the lab's nhc_half over the block's M atoms (velocities in shared memory)
__device__ void nhc_half(float* vx, float* vy, float* vz, const float* mftm, float* red,
                         float* misc, int M, float dt, float kt, float ndof, float tdamp) {
  float ke = 0.f;
  for (int a = threadIdx.x; a < M; a += blockDim.x)
    ke += mftm[a] * (vx[a] * vx[a] + vy[a] * vy[a] + vz[a] * vz[a]);
  nhc_chain(block_sum(ke, red), misc, dt, kt, ndof, tdamp);
  const float scale = misc[NHC];
  for (int a = threadIdx.x; a < M; a += blockDim.x) {
    vx[a] *= scale;
    vy[a] *= scale;
    vz[a] *= scale;
  }
}

// d = x_j - x_i to its minimum image, z then y then x (forces_v1); r^2
__device__ __forceinline__ float min_image(const Box& h, float ilx, float ily, float ilz,
                                           float& dx, float& dy, float& dz) {
  const float n3 = rintf(dz * ilz);
  dz = dz - n3 * h.lz;
  dy = dy - n3 * h.yz;
  const float n2 = rintf(dy * ily);
  dy = dy - n2 * h.ly;
  dx = dx - n3 * h.xz - n2 * h.xy;
  const float n1 = rintf(dx * ilx);
  dx = dx - n1 * h.lx;
  return dx * dx + dy * dy + dz * dz;
}

// d = x_j - x_i + h n with the cached images; r^2
__device__ __forceinline__ float disp_cached(const Box& h, char4 n, float& dx, float& dy,
                                             float& dz) {
  const float n1 = n.x, n2 = n.y, n3 = n.z;
  dx = dx + n1 * h.lx + n2 * h.xy + n3 * h.xz;
  dy = dy + n2 * h.ly + n3 * h.yz;
  dz = dz + n3 * h.lz;
  return dx * dx + dy * dy + dz * dz;
}

// the images n = -round(.) of refresh_images; over marks |n| > 127 (or NaN)
__device__ __forceinline__ signed char image8(float n, bool& over) {
  over |= !(fabsf(n) <= 127.f);
  return (signed char)fminf(fmaxf(n, -127.f), 127.f);
}

__device__ __forceinline__ char4 images(const Box& h, float ilx, float ily, float ilz,
                                        float dx, float dy, float dz, bool& over) {
  const float n3 = -rintf(dz * ilz);
  dz = dz + n3 * h.lz;
  dy = dy + n3 * h.yz;
  const float n2 = -rintf(dy * ily);
  dy = dy + n2 * h.ly;
  dx = dx + n3 * h.xz + n2 * h.xy;
  const float n1 = -rintf(dx * ilx);
  return make_char4(image8(n1, over), image8(n2, over), image8(n3, over), 0);
}

// the deform remap's coefficients A = h_new inv(h_old) (upper triangular)
struct Remap {
  float a00, a01, a02, a11, a12, a22;
};

__device__ __forceinline__ Remap remap(const Box& h, const Box& hn) {
  const float i00 = 1.f / h.lx, i11 = 1.f / h.ly, i22 = 1.f / h.lz;
  const float i01 = -h.xy / (h.lx * h.ly);
  const float i12 = -h.yz / (h.ly * h.lz);
  const float i02 = (h.xy * h.yz - h.xz * h.ly) / (h.lx * h.ly * h.lz);
  Remap r;
  r.a00 = hn.lx * i00;
  r.a01 = hn.lx * i01 + hn.xy * i11;
  r.a02 = hn.lx * i02 + hn.xy * i12 + hn.xz * i22;
  r.a11 = hn.ly * i11;
  r.a12 = hn.ly * i12 + hn.yz * i22;
  r.a22 = hn.lz * i22;
  return r;
}

// One variant's template flags as a type (the dispatch of both designs).
template <bool CACHE_, bool TRIM_, bool UNISIG_, int FORM_, int NEWTON_, int J_>
struct Flags {
  static constexpr bool CACHE = CACHE_, TRIM = TRIM_, UNISIG = UNISIG_;
  static constexpr int FORM = FORM_, NEWTON = NEWTON_, J = J_;
};

// variant ids: ops/md_slim.VARIANTS[...].vid
template <class Fn>
cudaError_t by_variant(int variant, Fn fn) {
  switch (variant) {
    //                         CACHE  TRIM   UNISIG FORM   NEWTON    J
    case 0: return fn(Flags<false, false, false, SIG, FULL, 1>{});       // v1
    case 1: return fn(Flags<true, false, false, SIG, FULL, 1>{});        // v2
    case 2: return fn(Flags<true, true, false, SIG, FULL, 1>{});         // v3
    case 3: return fn(Flags<true, true, true, SIG, FULL, 1>{});          // v4
    case 4: return fn(Flags<true, true, false, SIG, ATOMIC, 1>{});       // v5
    case 5: return fn(Flags<true, true, false, LJ, ATOMIC, 1>{});        // v5p
    case 6: return fn(Flags<true, true, false, RSQRT, ATOMIC, 1>{});     // v5r
    case 7: return fn(Flags<true, true, false, LJ, PARTIALS, 1>{});      // v5m
    case 8: return fn(Flags<true, true, false, SIG, ATOMIC, 2>{});       // v7
    case 9: return fn(Flags<true, true, false, SIG, ATOMIC, 4>{});       // v7d4
    case 10: return fn(Flags<true, true, false, LJ, ATOMIC, 2>{});       // v7p
    case 11: return fn(Flags<true, true, false, SIG, SHUFFLE, 1>{});     // v8
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
