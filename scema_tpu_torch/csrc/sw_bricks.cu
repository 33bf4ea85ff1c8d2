// K6: Stillinger-Weber over 128-slot tiles of atoms, for boxes above the
// fused kernel K5's gate.  Two kernels, exported for ops/sw_bricks.py:
//
// * sw_moments_kernel: per-atom SW channels over a tile-pair list —
//   half the two-body energy, s = sum g, sum g^2, m = sum g u (3) and
//   Q = sum g u (x) u (6).  Replaces scema_tpu/ops/sw_pallas.py
//   _sw_kernel_adj (:215), launched by sw_moments_pallas_bricks_raw (K6d,
//   :674) and sw_energy_pallas_bricks (K6e, :707) on the brick structure's
//   27-stencil, and by sw_moments_pallas_adj (K6b, :311) on a tile
//   adjacency; and _sw_kernel (:45, K6a, :133), the same channels over all
//   tile pairs with the general (sig/r)^q term.  One kernel serves all four:
//   the tile-pair list (C, K) is an input, and q is a constant (0 for
//   K6b/K6d/K6e, as their TPU kernels hardcode).
// * sw_forces_kernel: the adjoint pair forces of every slot in both roles
//   (centre with its own adjoints, neighbour of the other slot's centre
//   with that slot's adjoints) and role 1's w (x) d virial channels.
//   Replaces _sw_force_kernel (:420), launched by sw_forces_pallas_bricks
//   (K6c, :585).  The adjoints between the two kernels are computed in
//   torch, as JAX computes them in jnp (:550-561), so each kernel matches
//   one pallas_call.
//
// Design: a grid of (tiles x jobs), one block of 128 threads per tile,
// thread = slot.  The block walks its tile's valid list entries; before
// each it stages the neighbour tile's positions and occupancy (and, in the
// force kernel, its 11 adjoint channels: 7.7 KB) in shared memory, then
// every thread runs over the 128 neighbour slots with its sums in
// registers — no atomics: each slot's outputs are written once by its own
// thread.  The minimum image is triclinic from each job's h and its
// inverse (box.min_image_disp: ds = h^-1 d, ds -= rint(ds), d = h ds); the
// TPU kernels round per axis by the diagonal of h only, which equals this
// on an orthorhombic box (ROADMAP section 3 records the tilted-box
// difference).  A pair is live when both slots are occupied, it is not the
// same slot of the same tile, and r^2 < (rc - 1e-6)^2; only live pairs
// reach the exps (K5's pattern, ops/md_fused.sw_consts).  p = 4 is built in.
//
// What bounds it on an H100: operations.  Every candidate pair pays the
// geometry (two 3x3 products, three roundings) whether or not it is live,
// and at the slice's 4096-atom box the stencil offers 27 x 128 candidates
// per slot of which ~9 are live, so the geometry of the candidates, not
// the SW arithmetic of the live pairs, is most of the work; positions,
// channels and outputs are a few MB per call.  A warp executes the live
// body whenever any of its lanes has a live pair.  A per-atom list of the
// live candidates (sweep 1 finds them) is the lever for a later PR.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int NMOM = 12;  // moment channels
constexpr int NADJ = 11;  // A_s, A_gsq, A_m (3), A_Q (xx yy zz xy xz yz)
constexpr int NFRC = 9;   // F (3), w (x) d (xx yy zz xy xz yz)

// constants derived on the host in double precision (sw_bricks.sw_consts)
struct SWK {
  float rc, rc2, sig, gs, aeps, b, m4b, q;
};

// d = x_j - x_i in place -> its minimum image and r^2
__device__ __forceinline__ float min_image(const float* h, const float* ih, float& dx,
                                           float& dy, float& dz) {
  float sx = ih[0] * dx + ih[1] * dy + ih[2] * dz;
  float sy = ih[3] * dx + ih[4] * dy + ih[5] * dz;
  float sz = ih[6] * dx + ih[7] * dy + ih[8] * dz;
  sx -= rintf(sx);
  sy -= rintf(sy);
  sz -= rintf(sz);
  dx = h[0] * sx + h[1] * sy + h[2] * sz;
  dy = h[3] * sx + h[4] * sy + h[5] * sz;
  dz = h[6] * sx + h[7] * sy + h[8] * sz;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(TILE)
sw_moments_kernel(const float* __restrict__ tiles, const int* __restrict__ nbr,
                  const int* __restrict__ valid, const float* __restrict__ hbox,
                  const float* __restrict__ ihbox, float* __restrict__ out, int C, int K,
                  SWK k) {
  __shared__ float sb[4][TILE];
  const int c = blockIdx.x, job = blockIdx.y, i = threadIdx.x;
  float h[9], ih[9];
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    h[a] = hbox[job * 9 + a];
    ih[a] = ihbox[job * 9 + a];
  }
  const float* mine = tiles + ((size_t)job * C + c) * 4 * TILE;
  const float xi = mine[i], yi = mine[TILE + i], zi = mine[2 * TILE + i];
  const bool occ_i = mine[3 * TILE + i] > 0.5f;
  float m[NMOM];
#pragma unroll
  for (int q = 0; q < NMOM; ++q) m[q] = 0.f;
  for (int e = 0; e < K; ++e) {
    if (!valid[c * K + e]) continue;  // uniform over the block
    const int b = nbr[c * K + e];
    __syncthreads();  // the previous entry's reads of sb are done
    const float* nb = tiles + ((size_t)job * C + b) * 4 * TILE;
#pragma unroll
    for (int r = 0; r < 4; ++r) sb[r][i] = nb[r * TILE + i];
    __syncthreads();
    if (!occ_i) continue;
    const bool same = b == c;
    for (int j = 0; j < TILE; ++j) {
      if (sb[3][j] <= 0.5f || (same && j == i)) continue;
      float dx = sb[0][j] - xi, dy = sb[1][j] - yi, dz = sb[2][j] - zi;
      const float r2 = min_image(h, ih, dx, dy, dz);
      if (r2 < k.rc2) {
        const float r = sqrtf(r2);
        const float sr = k.sig / r;
        const float sr2 = sr * sr;
        const float srp = sr2 * sr2;  // p = 4
        const float srq = k.q == 0.f ? 1.f : powf(sr, k.q);
        const float denom = r - k.rc;
        const float expo = expf(k.sig / denom);
        m[0] += k.aeps * (k.b * srp - srq) * expo;
        const float g = expf(k.gs / denom);
        const float ux = dx / r, uy = dy / r, uz = dz / r;
        const float gx = g * ux, gy = g * uy, gz = g * uz;
        m[1] += g;
        m[2] += g * g;
        m[3] += gx; m[4] += gy; m[5] += gz;
        m[6] += gx * ux; m[7] += gy * uy; m[8] += gz * uz;
        m[9] += gx * uy; m[10] += gx * uz; m[11] += gy * uz;
      }
    }
  }
  m[0] *= 0.5f;  // each pair is seen from both ends
  float* o = out + ((size_t)job * C + c) * NMOM * TILE + i;
#pragma unroll
  for (int q = 0; q < NMOM; ++q) o[q * TILE] = m[q];
}

// w = dT/dd of one ordered pair along u for a centre with adjoints
// a = (A_s, A_gsq, A_m (3), A_Q (xx yy zz xy xz yz)) (_sw_force_kernel's
// pair_w)
__device__ __forceinline__ void sw_w(float ux, float uy, float uz, float inv_r, float g,
                                     float dg, float radial0, const float* a, int stride,
                                     float wv[3]) {
  const float a_s = a[0], a_gsq = a[stride];
  const float amx = a[2 * stride], amy = a[3 * stride], amz = a[4 * stride];
  const float qxx = a[5 * stride], qyy = a[6 * stride], qzz = a[7 * stride];
  const float qxy = a[8 * stride], qxz = a[9 * stride], qyz = a[10 * stride];
  const float am_u = amx * ux + amy * uy + amz * uz;
  const float qx = qxx * ux + qxy * uy + qxz * uz;
  const float qy = qxy * ux + qyy * uy + qyz * uz;
  const float qz = qxz * ux + qyz * uy + qzz * uz;
  const float uqu = ux * qx + uy * qy + uz * qz;
  const float radial = radial0 + dg * (a_s + 2.f * a_gsq * g + am_u + uqu);
  const float tang = g * inv_r;
  const float t2 = am_u + 2.f * uqu;
  wv[0] = radial * ux + tang * (amx + 2.f * qx - t2 * ux);
  wv[1] = radial * uy + tang * (amy + 2.f * qy - t2 * uy);
  wv[2] = radial * uz + tang * (amz + 2.f * qz - t2 * uz);
}

__global__ void __launch_bounds__(TILE)
sw_forces_kernel(const float* __restrict__ tiles, const float* __restrict__ adj,
                 const int* __restrict__ nbr, const int* __restrict__ valid,
                 const float* __restrict__ hbox, const float* __restrict__ ihbox,
                 float* __restrict__ out, int C, int K, SWK k) {
  __shared__ float sb[4 + NADJ][TILE];
  const int c = blockIdx.x, job = blockIdx.y, i = threadIdx.x;
  float h[9], ih[9];
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    h[a] = hbox[job * 9 + a];
    ih[a] = ihbox[job * 9 + a];
  }
  const size_t tile0 = (size_t)job * C + c;
  const float* mine = tiles + tile0 * 4 * TILE;
  const float xi = mine[i], yi = mine[TILE + i], zi = mine[2 * TILE + i];
  const bool occ_i = mine[3 * TILE + i] > 0.5f;
  float a[NADJ];
#pragma unroll
  for (int q = 0; q < NADJ; ++q) a[q] = adj[(tile0 * NADJ + q) * TILE + i];
  float f[3] = {0.f, 0.f, 0.f};
  float wd[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int e = 0; e < K; ++e) {
    if (!valid[c * K + e]) continue;  // uniform over the block
    const int b = nbr[c * K + e];
    __syncthreads();
    const size_t tb = (size_t)job * C + b;
#pragma unroll
    for (int r = 0; r < 4; ++r) sb[r][i] = tiles[(tb * 4 + r) * TILE + i];
#pragma unroll
    for (int q = 0; q < NADJ; ++q) sb[4 + q][i] = adj[(tb * NADJ + q) * TILE + i];
    __syncthreads();
    if (!occ_i) continue;
    const bool same = b == c;
    for (int j = 0; j < TILE; ++j) {
      if (sb[3][j] <= 0.5f || (same && j == i)) continue;
      float dx = sb[0][j] - xi, dy = sb[1][j] - yi, dz = sb[2][j] - zi;
      const float r2 = min_image(h, ih, dx, dy, dz);
      if (r2 < k.rc2) {
        const float r = sqrtf(r2);
        const float inv_r = 1.f / r;
        const float ux = dx * inv_r, uy = dy * inv_r, uz = dz * inv_r;
        const float denom = r - k.rc;
        const float expo = expf(k.sig / denom);
        const float sr = k.sig * inv_r;
        const float sr2 = sr * sr;
        const float srp = sr2 * sr2;  // p = 4
        const float phi2 = k.aeps * (k.b * srp - 1.f) * expo;  // q = 0
        const float id2 = denom * denom;
        const float dphi2 = k.aeps * (k.m4b * srp * inv_r) * expo + phi2 * (-k.sig / id2);
        const float g = expf(k.gs / denom);
        const float dg = g * (-k.gs / id2);
        const float radial0 = 0.5f * dphi2;
        float wa[3], wb[3];
        sw_w(ux, uy, uz, inv_r, g, dg, radial0, a, 1, wa);  // role 1: i the centre
        sw_w(-ux, -uy, -uz, inv_r, g, dg, radial0, &sb[4][j], TILE, wb);  // role 2: j
        f[0] += wa[0] - wb[0];
        f[1] += wa[1] - wb[1];
        f[2] += wa[2] - wb[2];
        // role 1 enumerates every ordered pair once
        wd[0] += wa[0] * dx;
        wd[1] += wa[1] * dy;
        wd[2] += wa[2] * dz;
        wd[3] += 0.5f * (wa[0] * dy + wa[1] * dx);
        wd[4] += 0.5f * (wa[0] * dz + wa[2] * dx);
        wd[5] += 0.5f * (wa[1] * dz + wa[2] * dy);
      }
    }
  }
  float* o = out + tile0 * NFRC * TILE + i;
#pragma unroll
  for (int q = 0; q < 3; ++q) o[q * TILE] = f[q];
#pragma unroll
  for (int q = 0; q < 6; ++q) o[(3 + q) * TILE] = wd[q];
}

}  // namespace

// tiles (B, C, 4, 128) [x y z occ]; nbr, valid (C, K) int32; h, ih (B, 9)
// row-major; out (B, C, 12, 128); k points to the host's SWK
extern "C" int sw_moments_f32(const float* tiles, const int* nbr, const int* valid,
                              const float* h, const float* ih, float* out, int B, int C, int K,
                              const void* k, void* stream) {
  dim3 grid(C, B);
  sw_moments_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, nbr, valid, h, ih, out, C, K, *static_cast<const SWK*>(k));
  return static_cast<int>(cudaGetLastError());
}

// adj (B, C, 11, 128); out (B, C, 9, 128); the rest as sw_moments_f32
extern "C" int sw_forces_f32(const float* tiles, const float* adj, const int* nbr,
                             const int* valid, const float* h, const float* ih, float* out,
                             int B, int C, int K, const void* k, void* stream) {
  dim3 grid(C, B);
  sw_forces_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, adj, nbr, valid, h, ih, out, C, K, *static_cast<const SWK*>(k));
  return static_cast<int>(cudaGetLastError());
}
