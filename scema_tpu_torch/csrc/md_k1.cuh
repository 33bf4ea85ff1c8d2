// K1's (csrc/md_k1.cu) operands, type-table and window codes, pair loop
// and launch helpers, shared with K1m's redesign (md_k1m.cu), which runs the
// same pair arithmetic for J jobs per block.  Design notes in md_k1.cu.
#pragma once
#include "md_kernel.cuh"

namespace {

// an atom's code (the w of its float4): bits 0-7 its type, 8-14 the
// excluded offsets d = j - i + 3 of its window (d = 3 is the atom itself),
// 16-22 the offsets whose weight is neither 0 nor 1 (read from win)
constexpr int K1_TYPE = 0xff, K1_EXCL = 8, K1_SPEC = 16, K1_WIN = 7, K1_REACH = 3;
// the force entry's tile: rows per block, and at most this many warps,
// each a slice of the j range
constexpr int K1_ROWS = 32, K1_SLICES = 16;
constexpr int K1_Q = K1_ROWS + K1_REACH;  // the tile's anchors, halo included

// Every operand of a K1 launch; mirrored field for field by
// ops/md_fused.py's ctypes structure _K1Args.
struct K1Args {
  const float* tbl;   // (T, T, 2) lj1, lj2 of (type i, type j)
  const int* code;    // (N,) atom codes
  const float* win;   // (N, 7) window weights (read for special offsets)
  const float* topo;  // (16, N) chain rows
  const float *invm, *mftm;
  float *state, *vxi, *press;
  const int* n_run;
  const float *fscal, *pos, *h6;
  float *force, *virial, *partial;  // partial: (B, tiles, 6) virial scratch
  int B, N, T, deform, sample, tiles;
  float cutoff2, r2min, ndof, boltz, nktv2p, tdamp;
};

// what the pair loop reads
struct K1Pair {
  const float4* p4;   // shared: positions + codes
  const float2* tbl;  // shared: (T, T) type table
  const float* win;
  int N, T;
  float cutoff2, r2min;
  Box h;
  float ilx, ily, ilz;
};

__device__ __forceinline__ K1Pair k1_pair(const K1Args& A, const float4* p4, const float2* tbl,
                                          const Box& h) {
  return K1Pair{p4, tbl, A.win, A.N, A.T, A.cutoff2, A.r2min, h,
                1.f / h.lx, 1.f / h.ly, 1.f / h.lz};
}

// 1 / r2c: rsqrtf squared (RSQRT, the run) or __frcp_rn (the force entry)
template <bool RSQRT>
__device__ __forceinline__ float inv_r2(float r2c) {
  if constexpr (RSQRT) {
    const float r = rsqrtf(r2c);
    return r * r;
  } else {
    return __frcp_rn(r2c);
  }
}

// One live pair's force on atom i from its coefficients a1, a2 at r2 and d
// = r_j - r_i into f, and with WV half of its virial d (x) d into w (K1's
// pair loop and K1m's, md_k1m.cu, share this arithmetic).
template <bool RSQRT, bool WV>
__device__ __forceinline__ void k1_apply(float a1, float a2, float r2, float r2min, float dx,
                                         float dy, float dz, float f[3], float w[6]) {
  const float inv = inv_r2<RSQRT>(fmaxf(r2, r2min));
  const float u2 = inv * inv;
  const float u3 = u2 * inv;
  const float fp = (a1 * u3 - a2) * u2 * u2;
  f[0] -= fp * dx;
  f[1] -= fp * dy;
  f[2] -= fp * dz;
  if constexpr (WV) {
    const float hp = 0.5f * fp;
    w[0] += hp * dx * dx;
    w[1] += hp * dy * dy;
    w[2] += hp * dz * dz;
    w[3] += hp * dx * dy;
    w[4] += hp * dx * dz;
    w[5] += hp * dy * dz;
  }
}

// Pair forces on atom i from every j in [j0, j1) into f, and with WV half
// of each pair's virial d (x) d into w.
template <bool RSQRT, bool WV>
__device__ __forceinline__ void k1_row(const K1Pair& P, int i, int j0, int j1, float f[3],
                                       float w[6]) {
  const float4 pi = P.p4[i];
  const int ci = __float_as_int(pi.w);
  const int row = (ci & K1_TYPE) * P.T;
  const unsigned excl = (ci >> K1_EXCL) & 0x7fu, spec = (ci >> K1_SPEC) & 0x7fu;
  for (int j = j0; j < j1; ++j) {
    const float4 pj = P.p4[j];
    float dx = pj.x - pi.x, dy = pj.y - pi.y, dz = pj.z - pi.z;
    const float r2 = min_image_r2(P.h, P.ilx, P.ily, P.ilz, dx, dy, dz);
    if (!(r2 < P.cutoff2)) continue;
    const unsigned d = (unsigned)(j - i + K1_REACH);
    bool sp = false;
    if (d < (unsigned)K1_WIN) {
      if ((excl >> d) & 1u) continue;  // weight 0: skipped, never subtracted
      sp = (spec >> d) & 1u;
    }
    const float2 c = P.tbl[row + (__float_as_int(pj.w) & K1_TYPE)];
    float a1 = c.x, a2 = c.y;
    if (sp) {
      const float wt = __ldg(P.win + (size_t)i * K1_WIN + d);
      a1 *= wt;
      a2 *= wt;
    }
    k1_apply<RSQRT, WV>(a1, a2, r2, P.r2min, dx, dy, dz, f, w);
  }
}

template <class K>
cudaError_t opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// registers, local (spill) bytes per thread, resident blocks per SM and
// block width of one kernel at N atoms of T types
template <class K>
cudaError_t kernel_info(K kernel, int threads, size_t bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = opt_in(kernel, bytes);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = threads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, bytes);
}

}  // namespace
