// K6: Stillinger-Weber over 128-slot tiles of atoms, for boxes above the
// fused kernel K5's gate.  Exported for ops/sw_bricks.py:
//
// * the moments kernel (sw_moments_list_f32): per-atom SW channels over a
//   tile-pair list — half the two-body energy, s = sum g, sum g^2, m = sum
//   g u (3) and Q = sum g u (x) u (6).  Replaces scema_tpu/ops/sw_pallas.py
//   _sw_kernel_adj (:215), launched by sw_moments_pallas_bricks_raw (K6d,
//   :674) and sw_energy_pallas_bricks (K6e, :707) on the brick structure's
//   27-stencil, and by sw_moments_pallas_adj (K6b, :311) on a tile
//   adjacency; and _sw_kernel (:45, K6a, :133), the same channels over all
//   tile pairs with the general (sig/r)^q term.  One kernel serves all four:
//   the tile-pair list (C, K) is an input, and q is a constant (0 for
//   K6b/K6d/K6e, as their TPU kernels hardcode).  On K6d's launch it also
//   writes each slot's live pairs (the live list) for the forces kernel.
// * the forces kernel (sw_forces_list_f32): the adjoint pair forces of
//   every slot in both roles (centre with its own adjoints, neighbour of
//   the other slot's centre with that slot's adjoints) and role 1's w (x) d
//   virial channels, over the live list.  Replaces _sw_force_kernel (:420),
//   launched by sw_forces_pallas_bricks (K6c, :585).  The adjoints between
//   the two kernels are computed in torch, as JAX computes them in jnp
//   (:550-561), so each kernel matches one pallas_call.
// * the first design of both (sw_moments_f32, sw_forces_f32), which only
//   the checks reach (sw_bricks._moments_first / _forces_first): one
//   128-thread block per tile, every thread over the whole 27-stencil with
//   block-wide staging of each neighbour tile (and its 11 adjoint rows).
//
// Shared by all: thread = slot, sums in registers, each slot's outputs
// written once by its own thread — no atomics on the outputs, so a run is
// deterministic.  The minimum image is triclinic from each job's h and its
// inverse (box.min_image_disp: ds = h^-1 d, ds -= rint(ds), d = h ds); the
// TPU kernels round per axis by the diagonal of h only, which equals this
// on an orthorhombic box (ROADMAP section 3 records the tilted-box
// difference).  A pair is live when both slots are occupied, it is not the
// same slot of the same tile, and r^2 < (rc - 1e-6)^2; only live pairs
// reach the exps (K5's pattern, ops/md_fused.sw_consts).  p = 4 is built in.
//
// What bounds it on an H100: at the slice's 4096-atom box a slot meets
// 27 x 128 stencil candidates, ~2300 occupied, of which ~4-10 are live, so
// the first design spent its time on the geometry of dead candidates (and
// the forces kernel repeated the moments kernel's sweep).  The design:
// * the moments kernel's warps run on their own, with no block barrier: a
//   warp whose 32 slots are all empty exits at once; each warp stages a
//   neighbour tile's kept 32-slot chunks as one float4 (x y z occ) per slot
//   into its own buffer and walks each chunk's lanes up to its last
//   occupied one, 4 per unrolled step (ILP), skipping empty lanes by the
//   chunk's occupancy ballot;
// * chunk pruning: a per-call pass (sw_spheres_kernel) writes each 32-slot
//   chunk's bounding sphere (centre c, radius r; r < 0 when empty), and a
//   warp skips a neighbour chunk when min_m |d_cc + h m| >= r_i + r_j + rc
//   (+ a margin for float32 rounding) over the 27 image offsets m in
//   {-1, 0, 1}^3 (one per lane, a warp min), where d_cc is the kernel's
//   minimum image of the centres.  Why no live pair is lost: slot a of
//   chunk I is an image of c_i + u with |u| <= r_i, slot b of chunk J of
//   c_j + v with |v| <= r_j, so the kernel's d_ab equals (c_j - c_i + h n)
//   + (v - u) for some integer n and |d_ab| >= |c_j - c_i + h n| - r_i -
//   r_j.  In fractional coordinates d_ab lies in [-1/2, 1/2]^3 and h^-1 (v
//   - u) in (-1/2, 1/2)^3 whenever r_i + r_j is below half the box's least
//   height (the test is only made then), so c_j - c_i + h n lies in
//   (-1, 1)^3: one of the 27 offsets of d_cc.  So |d_ab| >= rc, not live;
// * on a job whose h and h^-1 are upper-triangular (their zeros exact),
//   the minimum image takes 6 multiply-adds, not 9 (the same bits: the
//   dropped terms are exact zeros); any other job takes the general path;
// * the live list: the moments kernel writes each slot's live neighbour
//   slots (flat tile * 128 + lane) in sweep order, up to cap, and its
//   count; the forces kernel walks min(count, cap) of them, gathering j's
//   position and adjoints, so it examines no dead candidate and stages
//   nothing.  A slot whose count passes cap sweeps the whole stencil in the
//   same kernel (exact) and is counted in *overflow.  Walking in sweep
//   order keeps the first design's summation order, and the per-pair
//   arithmetic is the same source; on the card the two designs still
//   differ at float32 rounding (~1e-6 relative): the compiler does not
//   emit the same arithmetic for it in both kernels.
// Timed on the card as design steps (PERF.md section 6): warps on their own
// with float4 staging took K6d from 3.47 to 3.30 ms per 128-job call, the
// triangular image to 3.00, pruning (~21% of the candidates here) to 2.48,
// the unrolled walk to 2.17; a cp.async double buffer of the next entry
// lost 2-3% wherever it was tried, one-warp blocks gained nothing, and
// more registers (fewer spills, fewer resident warps) lost 10%: the sweep
// is bound by latency at 8 blocks per SM.  What is left: the ~1800 kept
// candidates per slot (~25 instructions each) in the moments kernel;
// bytes are ~0.1 GB per 128-job call.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int WARPS = TILE / 32;  // 32-slot chunks per tile
constexpr int NMOM = 12;  // moment channels
constexpr int NADJ = 11;  // A_s, A_gsq, A_m (3), A_Q (xx yy zz xy xz yz)
constexpr int NFRC = 9;   // F (3), w (x) d (xx yy zz xy xz yz)
constexpr unsigned FULL = 0xffffffffu;
// the sphere test's margin (A) over the float32 rounding of centres, radii
// and pair geometry at box coordinates of ~100 A
constexpr float PRUNE_MARGIN = 1e-2f;

// constants derived on the host in double precision (sw_bricks.sw_consts)
struct SWK {
  float rc, rc2, sig, gs, aeps, b, m4b, q;
};

// d = x_j - x_i in place -> its minimum image and r^2; TRI: h and h^-1
// upper-triangular with exact zeros (the dropped products are exact zeros)
template <bool TRI = false>
__device__ __forceinline__ float min_image(const float* h, const float* ih, float& dx,
                                           float& dy, float& dz) {
  float sx, sy, sz;
  if (TRI) {
    sx = ih[0] * dx + ih[1] * dy + ih[2] * dz;
    sy = ih[4] * dy + ih[5] * dz;
    sz = ih[8] * dz;
  } else {
    sx = ih[0] * dx + ih[1] * dy + ih[2] * dz;
    sy = ih[3] * dx + ih[4] * dy + ih[5] * dz;
    sz = ih[6] * dx + ih[7] * dy + ih[8] * dz;
  }
  sx -= rintf(sx);
  sy -= rintf(sy);
  sz -= rintf(sz);
  if (TRI) {
    dx = h[0] * sx + h[1] * sy + h[2] * sz;
    dy = h[4] * sy + h[5] * sz;
    dz = h[8] * sz;
  } else {
    dx = h[0] * sx + h[1] * sy + h[2] * sz;
    dy = h[3] * sx + h[4] * sy + h[5] * sz;
    dz = h[6] * sx + h[7] * sy + h[8] * sz;
  }
  return dx * dx + dy * dy + dz * dz;
}

// one live pair's moments into m (d = x_j - x_i, r^2 < rc2)
__device__ __forceinline__ void pair_moments(float dx, float dy, float dz, float r2,
                                             const SWK& k, float* m) {
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

// one live pair's forces (both roles) and role 1's w (x) d into f, wd: the
// centre's adjoints a (stride 1), the neighbour's aj (stride sj)
__device__ __forceinline__ void pair_forces(float dx, float dy, float dz, float r2,
                                            const SWK& k, const float* a, const float* aj,
                                            int sj, float* f, float* wd) {
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
  sw_w(ux, uy, uz, inv_r, g, dg, radial0, a, 1, wa);       // role 1: i the centre
  sw_w(-ux, -uy, -uz, inv_r, g, dg, radial0, aj, sj, wb);  // role 2: j the centre
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

__device__ __forceinline__ void load_box(const float* hbox, const float* ihbox, int job,
                                         float* h, float* ih) {
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    h[a] = hbox[job * 9 + a];
    ih[a] = ihbox[job * 9 + a];
  }
}

// ---------------------------------------------------------------------------
// The first design (reached only through sw_bricks._moments_first /
// _forces_first): block-wide staging of every stencil entry

__global__ void __launch_bounds__(TILE)
sw_moments_kernel(const float* __restrict__ tiles, const int* __restrict__ nbr,
                  const int* __restrict__ valid, const float* __restrict__ hbox,
                  const float* __restrict__ ihbox, float* __restrict__ out, int C, int K,
                  SWK k) {
  __shared__ float sb[4][TILE];
  const int c = blockIdx.x, job = blockIdx.y, i = threadIdx.x;
  float h[9], ih[9];
  load_box(hbox, ihbox, job, h, ih);
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
      if (r2 < k.rc2) pair_moments(dx, dy, dz, r2, k, m);
    }
  }
  m[0] *= 0.5f;  // each pair is seen from both ends
  float* o = out + ((size_t)job * C + c) * NMOM * TILE + i;
#pragma unroll
  for (int q = 0; q < NMOM; ++q) o[q * TILE] = m[q];
}

__global__ void __launch_bounds__(TILE)
sw_forces_kernel(const float* __restrict__ tiles, const float* __restrict__ adj,
                 const int* __restrict__ nbr, const int* __restrict__ valid,
                 const float* __restrict__ hbox, const float* __restrict__ ihbox,
                 float* __restrict__ out, int C, int K, SWK k) {
  __shared__ float sb[4 + NADJ][TILE];
  const int c = blockIdx.x, job = blockIdx.y, i = threadIdx.x;
  float h[9], ih[9];
  load_box(hbox, ihbox, job, h, ih);
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
      if (r2 < k.rc2) pair_forces(dx, dy, dz, r2, k, a, &sb[4][j], TILE, f, wd);
    }
  }
  float* o = out + tile0 * NFRC * TILE + i;
#pragma unroll
  for (int q = 0; q < 3; ++q) o[q * TILE] = f[q];
#pragma unroll
  for (int q = 0; q < 6; ++q) o[(3 + q) * TILE] = wd[q];
}

// ---------------------------------------------------------------------------
// The path's design

// each 32-slot chunk's bounding sphere (cx, cy, cz, r), r = -1 for a chunk
// with no occupied slot: slots taken by their minimum image from the
// chunk's first occupied slot, centre their mean, r the largest distance
__global__ void __launch_bounds__(TILE)
sw_spheres_kernel(const float* __restrict__ tiles, const float* __restrict__ hbox,
                  const float* __restrict__ ihbox, float4* __restrict__ sph, int C) {
  const int c = blockIdx.x, job = blockIdx.y, i = threadIdx.x, lane = i & 31;
  const float* mine = tiles + ((size_t)job * C + c) * 4 * TILE;
  const float x = mine[i], y = mine[TILE + i], z = mine[2 * TILE + i];
  const bool occ = mine[3 * TILE + i] > 0.5f;
  const unsigned mask = __ballot_sync(FULL, occ);
  float4* o = sph + ((size_t)job * C + c) * WARPS + (i >> 5);
  if (mask == 0u) {
    if (lane == 0) *o = make_float4(0.f, 0.f, 0.f, -1.f);
    return;
  }
  float h[9], ih[9];
  load_box(hbox, ihbox, job, h, ih);
  const int r0 = __ffs(mask) - 1;
  const float rx = __shfl_sync(FULL, x, r0), ry = __shfl_sync(FULL, y, r0),
              rz = __shfl_sync(FULL, z, r0);
  float dx = x - rx, dy = y - ry, dz = z - rz;
  min_image(h, ih, dx, dy, dz);
  if (!occ) dx = dy = dz = 0.f;
  float sx = dx, sy = dy, sz = dz;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    sx += __shfl_xor_sync(FULL, sx, s);
    sy += __shfl_xor_sync(FULL, sy, s);
    sz += __shfl_xor_sync(FULL, sz, s);
  }
  const float inv = 1.f / static_cast<float>(__popc(mask));
  const float mx = sx * inv, my = sy * inv, mz = sz * inv;
  const float ex = dx - mx, ey = dy - my, ez = dz - mz;
  float e2 = occ ? ex * ex + ey * ey + ez * ez : 0.f;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) e2 = fmaxf(e2, __shfl_xor_sync(FULL, e2, s));
  if (lane == 0) *o = make_float4(rx + mx, ry + my, rz + mz, sqrtf(e2));
}

// The moments sweep of one warp (its 32 centre slots) over the tile list:
// per entry, the neighbour tile's chunks that the sphere test keeps are
// staged into the warp's buffer (a float4 per slot), and each chunk's lanes
// are walked in order up to its last occupied one, 4 per unrolled step,
// each candidate a broadcast read.  TRI: the upper-triangular minimum image.
template <bool TRI>
__device__ __forceinline__ void moments_sweep(
    const float* __restrict__ tiles, const int* __restrict__ nbr, const int* __restrict__ valid,
    const float* h, const float* ih, const float4* __restrict__ sph, float4* buf, int c,
    int job, int i, int C, int K, const SWK& k, float* m, int* __restrict__ list, int cap,
    int& cnt) {
  const int lane = i & 31, w = i >> 5;
  const size_t tile0 = (size_t)job * C + c;
  const float* mine = tiles + tile0 * 4 * TILE;
  const float xi = mine[i], yi = mine[TILE + i], zi = mine[2 * TILE + i];
  const bool occ_i = mine[3 * TILE + i] > 0.5f;
  const float4 si = sph[tile0 * WARPS + w];
  // half the box's least height: 1 / (2 max_k |row k of h^-1|)
  float g = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    g = fmaxf(g, ih[3 * a] * ih[3 * a] + ih[3 * a + 1] * ih[3 * a + 1] +
                     ih[3 * a + 2] * ih[3 * a + 2]);
  const float hlim = 0.5f * rsqrtf(g);
  // this lane's image offset for the sphere test (lanes 27-31 idle)
  const float kx = static_cast<float>(lane % 3 - 1);
  const float ky = static_cast<float>((lane / 3) % 3 - 1);
  const float kz = static_cast<float>(lane / 9 - 1);
  for (int e = 0; e < K; ++e) {
    if (!valid[c * K + e]) continue;  // uniform over the warp
    const int b = nbr[c * K + e];
    // the chunks of tile b this warp sweeps: occupied and not ruled out
    unsigned keep = 0u;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
      const float4 sj = sph[((size_t)job * C + b) * WARPS + q];
      if (sj.w < 0.f) continue;
      if (si.w + sj.w < hlim) {
        float dx = sj.x - si.x, dy = sj.y - si.y, dz = sj.z - si.z;
        min_image<TRI>(h, ih, dx, dy, dz);
        const float ex = dx + h[0] * kx + h[1] * ky + h[2] * kz;
        const float ey = dy + h[3] * kx + h[4] * ky + h[5] * kz;
        const float ez = dz + h[6] * kx + h[7] * ky + h[8] * kz;
        const float d2 = lane < 27 ? ex * ex + ey * ey + ez * ez : __int_as_float(0x7f800000);
        const float lim = si.w + sj.w + k.rc + PRUNE_MARGIN;
        if (__uint_as_float(__reduce_min_sync(FULL, __float_as_uint(d2))) >= lim * lim) continue;
      }
      keep |= 1u << q;
    }
    __syncwarp();  // the previous entry's reads of buf are done
    const float* nb = tiles + ((size_t)job * C + b) * 4 * TILE + lane;
#pragma unroll
    for (int q = 0; q < WARPS; ++q)
      if (keep >> q & 1u) {
        const float* s = nb + q * 32;
        buf[q * 32 + lane] = make_float4(s[0], s[TILE], s[2 * TILE], s[3 * TILE]);
      }
    __syncwarp();
    const bool same = b == c;
#pragma unroll 1
    for (int q = 0; q < WARPS; ++q) {
      if (!(keep >> q & 1u)) continue;
      const unsigned occ_q = __ballot_sync(FULL, buf[q * 32 + lane].w > 0.5f);
      unsigned mm = occ_i ? occ_q : 0u;
      if (same && q == w) mm &= ~(1u << lane);
      const int top = 32 - __clz(occ_q);
#pragma unroll 4
      for (int t = 0; t < top; ++t) {
        if (!(mm >> t & 1u)) continue;
        const int j = q * 32 + t;
        const float4 pj = buf[j];
        float dx = pj.x - xi, dy = pj.y - yi, dz = pj.z - zi;
        const float r2 = min_image<TRI>(h, ih, dx, dy, dz);
        if (r2 < k.rc2) {
          pair_moments(dx, dy, dz, r2, k, m);
          if (list != nullptr) {
            if (cnt < cap) list[(tile0 * cap + cnt) * TILE + i] = b * TILE + j;
            ++cnt;
          }
        }
      }
    }
  }
}

// grid (tiles, jobs) of 128 threads, each warp on its own (no block
// barrier); 8 blocks per SM cap it at 64 registers
__global__ void __launch_bounds__(TILE, 8)
sw_moments_warp_kernel(const float* __restrict__ tiles, const int* __restrict__ nbr,
                       const int* __restrict__ valid, const float* __restrict__ hbox,
                       const float* __restrict__ ihbox, const float4* __restrict__ sph,
                       float* __restrict__ out, int* __restrict__ count,
                       int* __restrict__ list, int cap, int C, int K, SWK k) {
  __shared__ float4 buf[WARPS][TILE];
  const int c = blockIdx.x, job = blockIdx.y, i = threadIdx.x;
  const size_t tile0 = (size_t)job * C + c;
  const bool occ_i = tiles[(tile0 * 4 + 3) * TILE + i] > 0.5f;
  float m[NMOM];
#pragma unroll
  for (int q = 0; q < NMOM; ++q) m[q] = 0.f;
  int cnt = 0;
  if (__ballot_sync(FULL, occ_i) != 0u) {  // an all-empty warp only writes zeros
    float h[9], ih[9];
    load_box(hbox, ihbox, job, h, ih);
    const bool tri = h[3] == 0.f && h[6] == 0.f && h[7] == 0.f && ih[3] == 0.f &&
                     ih[6] == 0.f && ih[7] == 0.f;
    if (tri)
      moments_sweep<true>(tiles, nbr, valid, h, ih, sph, buf[i >> 5], c, job, i, C, K, k, m,
                          list, cap, cnt);
    else
      moments_sweep<false>(tiles, nbr, valid, h, ih, sph, buf[i >> 5], c, job, i, C, K, k, m,
                           list, cap, cnt);
  }
  m[0] *= 0.5f;  // each pair is seen from both ends
  float* o = out + tile0 * NMOM * TILE + i;
#pragma unroll
  for (int q = 0; q < NMOM; ++q) o[q * TILE] = m[q];
  if (count != nullptr) count[tile0 * TILE + i] = cnt;
}

// grid (tiles, jobs), 128 threads: each occupied slot walks its live list
// (or, past cap, the whole stencil)
__global__ void __launch_bounds__(TILE, 8)
sw_forces_list_kernel(const float* __restrict__ tiles, const float* __restrict__ adj,
                      const int* __restrict__ nbr, const int* __restrict__ valid,
                      const float* __restrict__ hbox, const float* __restrict__ ihbox,
                      const int* __restrict__ count, const int* __restrict__ list, int cap,
                      float* __restrict__ out, int* __restrict__ overflow, int C, int K,
                      SWK k) {
  const int c = blockIdx.x, job = blockIdx.y, i = threadIdx.x;
  const size_t tile0 = (size_t)job * C + c;
  const float* mine = tiles + tile0 * 4 * TILE;
  float f[3] = {0.f, 0.f, 0.f};
  float wd[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (mine[3 * TILE + i] > 0.5f) {
    float h[9], ih[9];
    load_box(hbox, ihbox, job, h, ih);
    const float xi = mine[i], yi = mine[TILE + i], zi = mine[2 * TILE + i];
    float a[NADJ];
#pragma unroll
    for (int q = 0; q < NADJ; ++q) a[q] = adj[(tile0 * NADJ + q) * TILE + i];
    const int cnt = count[tile0 * TILE + i];
    if (cnt <= cap) {
      const int* l = list + tile0 * cap * TILE + i;
      for (int t = 0; t < cnt; ++t) {
        const int s = l[t * TILE];
        const size_t tb = (size_t)job * C + s / TILE;
        const int j = s % TILE;
        const float* nb = tiles + tb * 4 * TILE + j;
        float dx = nb[0] - xi, dy = nb[TILE] - yi, dz = nb[2 * TILE] - zi;
        const float r2 = min_image(h, ih, dx, dy, dz);
        if (r2 < k.rc2) pair_forces(dx, dy, dz, r2, k, a, adj + tb * NADJ * TILE + j, TILE, f, wd);
      }
    } else {  // the list overflowed: this slot sweeps the stencil
      atomicAdd(overflow, 1);
      for (int e = 0; e < K; ++e) {
        if (!valid[c * K + e]) continue;
        const int b = nbr[c * K + e];
        const size_t tb = (size_t)job * C + b;
        const float* nb = tiles + tb * 4 * TILE;
        for (int j = 0; j < TILE; ++j) {
          if (nb[3 * TILE + j] <= 0.5f || (b == c && j == i)) continue;
          float dx = nb[j] - xi, dy = nb[TILE + j] - yi, dz = nb[2 * TILE + j] - zi;
          const float r2 = min_image(h, ih, dx, dy, dz);
          if (r2 < k.rc2)
            pair_forces(dx, dy, dz, r2, k, a, adj + tb * NADJ * TILE + j, TILE, f, wd);
        }
      }
    }
  }
  float* o = out + tile0 * NFRC * TILE + i;
#pragma unroll
  for (int q = 0; q < 3; ++q) o[q * TILE] = f[q];
#pragma unroll
  for (int q = 0; q < 6; ++q) o[(3 + q) * TILE] = wd[q];
}

template <class Kern>
cudaError_t kernel_info(Kern kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = TILE;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, TILE, 0);
}

}  // namespace

// The first design.  tiles (B, C, 4, 128) [x y z occ]; nbr, valid (C, K)
// int32; h, ih (B, 9) row-major; out (B, C, 12, 128); k points to the
// host's SWK
extern "C" int sw_moments_f32(const float* tiles, const int* nbr, const int* valid,
                              const float* h, const float* ih, float* out, int B, int C, int K,
                              const void* k, void* stream) {
  dim3 grid(C, B);
  sw_moments_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, nbr, valid, h, ih, out, C, K, *static_cast<const SWK*>(k));
  return static_cast<int>(cudaGetLastError());
}

// The first design.  adj (B, C, 11, 128); out (B, C, 9, 128); the rest as
// sw_moments_f32
extern "C" int sw_forces_f32(const float* tiles, const float* adj, const int* nbr,
                             const int* valid, const float* h, const float* ih, float* out,
                             int B, int C, int K, const void* k, void* stream) {
  dim3 grid(C, B);
  sw_forces_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, adj, nbr, valid, h, ih, out, C, K, *static_cast<const SWK*>(k));
  return static_cast<int>(cudaGetLastError());
}

// The moments: the sphere pass into sph (B, C, 4, 4), then the sweep into
// out (B, C, 12, 128) and, when count is not null, the live list: count
// (B, C, 128) and list (B, C, cap, 128) int32
extern "C" int sw_moments_list_f32(const float* tiles, const int* nbr, const int* valid,
                                   const float* h, const float* ih, float* sph, float* out,
                                   int* count, int* list, int cap, int B, int C, int K,
                                   const void* k, void* stream) {
  if (count != nullptr && (list == nullptr || cap < 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(C, B);
  sw_spheres_kernel<<<grid, TILE, 0, s>>>(tiles, h, ih, reinterpret_cast<float4*>(sph), C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sw_moments_warp_kernel<<<grid, TILE, 0, s>>>(tiles, nbr, valid, h, ih,
                                              reinterpret_cast<const float4*>(sph), out, count,
                                              list, cap, C, K, *static_cast<const SWK*>(k));
  return static_cast<int>(cudaGetLastError());
}

// The forces over the live list of sw_moments_list_f32 (count, list, cap);
// overflow (one int, zeroed by the caller) counts the slots that swept the
// stencil; the rest as sw_forces_f32
extern "C" int sw_forces_list_f32(const float* tiles, const float* adj, const int* nbr,
                                  const int* valid, const float* h, const float* ih,
                                  const int* count, const int* list, int cap, float* out,
                                  int* overflow, int B, int C, int K, const void* k,
                                  void* stream) {
  dim3 grid(C, B);
  sw_forces_list_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, adj, nbr, valid, h, ih, count, list, cap, out, overflow, C, K,
      *static_cast<const SWK*>(k));
  return static_cast<int>(cudaGetLastError());
}

// registers, local (spill) bytes per thread, resident blocks per SM and
// block width of kernel `which`: 0 the path's moments, 1 its forces, 2 the
// first design's moments, 3 its forces, 4 the sphere pass
extern "C" int sw_kernel_info(int which, int* out) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0: return (int)kernel_info(sw_moments_warp_kernel, out);
    case 1: return (int)kernel_info(sw_forces_list_kernel, out);
    case 2: return (int)kernel_info(sw_moments_kernel, out);
    case 3: return (int)kernel_info(sw_forces_kernel, out);
    case 4: return (int)kernel_info(sw_spheres_kernel, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
