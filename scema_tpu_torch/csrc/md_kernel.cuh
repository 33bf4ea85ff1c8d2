// The first designs of K1, K3, K4, K5 and K1m: fused MD — whole NVT +
// fix-deform or NVT + virial-sampling runs of many boxes, one thread block
// per job (K1m: J jobs per block).  The device code shared by md_allpairs.cu
// (the all-pairs pair loop: K1's and K3's first designs), md_list.cu (the
// gather-list pair loop: K4's first design), md_sw.cu (K5's first design:
// the Stillinger-Weber sweeps) and md_multi.cu (K1m's first design); each
// source instantiates and exports its own side, so nvcc builds them in
// parallel.  Every one of them was redesigned for Hopper (md_k1.cu and
// md_k1m.cu over md_k1.cuh; md_charged.cuh with md_k3.cu, md_k4.cu and
// md_k4_big.cu; md_k5.cu), reusing the device functions here (the bonded,
// pattern and SHAKE/RATTLE passes through a position accessor, the NHC
// chain, the deform path, the block sums, SW's w).  The first designs stay
// built for the A/B timings and the checks only (ops/md_fused.py's
// _run_first, _forces_first and _run_multi_first; K1m's first design
// copies K1's per job); no path of the port launches them.
//
// K1 replaces the all-pairs LJ/OPLS chain branch of the TPU kernel
// scema_tpu/ops/md_fused.py::_make_kernel (launched by fused_chunk):
// forces_allpairs, refresh_images, bonded_chain_forces, nhc_half, the
// deform path _h_at / _remap_coeffs and the sampling accumulation.
//
// K3's first design is the same kernel with the charged all-atom additions
// of that TPU kernel switched on at compile time (template flags):
//   COUL     Coulomb pair force from a dense qq plane (special-bond weights
//            folded in): plain cutoff qq/r^3 ...
//   EWALD    ... or LAMMPS's damped real-space Ewald form
//            qq (erfc(a r)/r + 2a/sqrt(pi) e^{-a^2 r^2}) / r^2 with erfc
//            from the A&S 7.1.26 polynomial sharing the exp (_ewald_fcoul,
//            erfc_poly);
//   PATTERNS offset-pattern bonds, angles and OPLS dihedrals for all-atom
//            [C H H (H)] layouts (bonded_pattern_forces) instead of the
//            linear-chain terms;
//   SHAKE    Jacobi SHAKE after the drift and Jacobi RATTLE after the
//            second half-kick over static partner offsets (shake_rolls,
//            rattle_rolls);
//   FEXT     a frozen per-atom force (the smooth k-space remainder,
//            refreshed by the host between chunks) added to every step's
//            force, and per-job step offsets (gstep0, n_tot) so a chunk
//            deforms along the path of the whole run.
// K1 is the instantiation with every flag off.
//
// K4's first design is the LIST flag: the pair loop walks a fixed-width
// neighbor list (the gather-list branch of the TPU kernel: forces ->
// pair_tile, gather3) instead of every j.  Per job, slot-major (B, K, N)
// channels in
// global memory give each slot's neighbor index, its lj1/lj2 and qq with
// the special-bond weights folded in (zero on dead slots, which are
// self-padded), and the periodic image integers n_ij fixed at the list
// build; the pair displacement is d = x_j + h n_ij - x_i with the CURRENT
// step's box (not a per-pair minimum image), live only where r2min < r2 <
// cutoff2.  The full list counts each pair twice, so the virial takes half
// of each slot.  Everything else (NHC, deform, patterns, SHAKE, fext,
// sampling) is K3's code.  K4 also stands for K4s, the TPU's HBM-streamed
// job-grid form (md_fused.py:1603-1722): here the grid is the jobs and the
// channels always live in device memory; the TPU's double-buffered K-chunk
// DMA has no counterpart.  What bounds this design: the channel bytes,
// read every step (7 x 4 B per slot: 70 MB per job-step at N = 2240, K =
// 1112), against ~25-60 FLOP per slot — the redesign (md_charged.cuh)
// reads one 4-byte word per live slot.
//
// K5 is the SW flag: the Stillinger-Weber branch of the TPU kernel
// (FusedSpec.sw -> forces_allpairs_sw, md_fused.py:910-1081) for the
// p = 4, q = 0 family, single element, no parameter planes and no bonded
// terms.  Its force call is two sweeps over all j per atom i, with the
// per-pair minimum image of K1 and live pairs r2 < (rc - 1e-6)^2, r2 >
// 1e-8:
//   sweep 1  thread i sums g = exp(gam sig / (r - rc)) and the moments
//            s = sum g, m = sum g u, Q = sum g u (x) u in registers, then
//            writes its ten adjoints (a_s = lam eps c0^2 s, a_m = -2 lam
//            eps c0 m, a_Q = lam eps Q) to the role buffer; one barrier;
//   sweep 2  thread i takes phi2', g and dg of each live pair, w_A with its
//            own adjoints (registers) and w_B with atom j's (ten shared
//            reads, live pairs only), f_i += w_A - w_B, and with sampling
//            role A's virial W -= sym(w_A (x) d).
// The sum of g^2 has a constant adjoint -(lam eps / 2)(1 - c0)^2, so it is
// not accumulated.  exp(sig / (r - rc)) and exp(gam sig / (r - rc)) are
// evaluated only on live pairs, where r - rc < 0 gives exp -> 0 and never
// inf * 0.  What bounds K5: the geometry of 2 N^2 ordered pairs per force
// call (N = 216: ~4 of 215 neighbours are live in the diamond lattice, so
// the SW arithmetic is a few percent of the pairs; a warp still executes a
// live body whenever any of its 32 lanes has a live j).  The redesign
// (md_k5.cu) walks sweep 1's live js in sweep 2.
//
// What bounds the first designs of K1/K3 on an H100: the pair loop (their
// redesigns read type tables and charges in place of the planes below).  A
// job does N^2 pair
// evaluations per step, twice the N(N-1)/2 the function needs (no Newton
// halving, below).  For K1's 512-site box that is 262k (~25 FLOP
// each, a quarter inside the 10 A cutoff); for K3's 1792-atom charged box
// 3.2M, of which ~40% lie inside the 12 A LJ cutoff and ~17% inside the
// 9 A Coulomb cutoff, where the erfc form adds one exp, one rcp and ~15
// FMAs.  The parameter planes (lj1, lj2, and qq with COUL: 3 x 12.8 MB at
// N = 1792) are read once per step per job through L2 (50 MB, shared by
// every block); device memory sees them about once.  The bonded patterns
// and the SHAKE/RATTLE sweeps are O(N) work per step but each costs block
// barriers: 2 per pattern (~40 patterns for PE), 2 per SHAKE sweep (20)
// and 2 per RATTLE sweep (10).
//
// Design:
// * One block per job, one thread per atom (strided loops when N exceeds
//   the block; the block is as wide as the instantiation's register count
//   allows, and __launch_bounds__ fixes that width per flag set).  Positions, velocities, forces and a 12 N role/scratch
//   buffer live in shared memory for the whole run: 21 N floats (43 KB at
//   N = 512, 150 KB at N = 1792).
// * Pair loop: each thread sums the full row of its own atom over every j
//   with no Newton halving — deterministic, no atomics, and the plane
//   reads plane[j*N + i] are coalesced across the warp (the planes are
//   symmetric).  Positions of j are shared-memory broadcasts.  The virial
//   takes half of each ordered pair.
// * Minimum image per pair by the sequential triclinic rounding of
//   refresh_images (z, then y, then x), exact while every box height
//   exceeds twice the cutoff (checked at system build).  The TPU's cached
//   image planes and triangle-packed parameter planes are not ported.
// * Bonded terms write per-role forces to the shared role buffer, then
//   every atom gathers its roles at their static offsets — the TPU's
//   shift trick, deterministic.  Chain terms (K1) do this in one pass;
//   with PATTERNS each pattern is one pass (compute roles, barrier,
//   gather, barrier).  acosf is exact (the TPU used a polynomial only on
//   hardware).
// * SHAKE/RATTLE sweeps: each constraint's anchor thread writes its
//   Lagrange factor, then each atom sums its corrections from its +o and
//   -o partners in a fixed order.  The role buffer holds the positions
//   before the drift and the factors; the force arrays (free between the
//   half-kick and the force call) hold the drifted positions.
// * Per-job scalars (kinetic energy, kinetic tensor, virial) come from
//   block reductions in a fixed order; thread 0 advances the NHC-3 chain
//   exactly as nhc_half does and broadcasts the velocity scale.
// * A job with n_run = 0 returns at once: its state is left bit-identical.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NHC = 3;
constexpr int MAXW = 32;  // warps in a 1024-thread block
constexpr int NRED = 12;  // values per block reduction
constexpr int FSCAL = 16;
constexpr int F_DT = 0, F_T = 1, F_H0 = 2, F_EPS = 8;
constexpr int T_BMASK = 0, T_BK = 1, T_BR0 = 2, T_AMASK = 3, T_AK = 4,
              T_ATH0 = 5, T_DMASK = 6, T_DK1 = 7;
constexpr int MAXPAT = 64;  // offset patterns (pack_patterns' bound)
constexpr int MAXSHK = 8;   // SHAKE offsets (pack_shake's bound)
constexpr int PAT_BOND = 0, PAT_ANGLE = 1, PAT_DIHEDRAL = 2;
constexpr float EWALD_F = 1.12837916709551257f;  // 2/sqrt(pi)

struct Box {
  float lx, ly, lz, xy, xz, yz;
};

// K5's constants, derived on the host in double precision
// (ops/md_fused.sw_consts) and passed in float32: rc = a sig, the mask
// bound rc2 = (rc - 1e-6)^2, gs = gam sig, aeps = A eps, b = B, m4b = -4 B,
// lam_eps = lam eps, k_s = lam eps c0^2, k_m = -2 lam eps c0, a_gsq =
// -(lam eps / 2)(1 - c0)^2
struct SWC {
  float rc, rc2, sig, gs, aeps, b, m4b, lam_eps, k_s, k_m, a_gsq;
};

struct Params {
  const float* lj1;   // (N, N)
  const float* lj2;   // (N, N)
  const float* topo;  // (16, N) chain rows
  int N;
  float cutoff2, r2min;
  // K3 only
  const float* qq;    // (N, N) with COUL
  const float* pat;   // (R, N) pattern parameter rows with PATTERNS
  const float* shk;   // (n_shk, N) SHAKE d0^2 rows with SHAKE
  float coul_cutoff2, alpha;
  // K4 only: (B, K, N) neighbor channels (slot-major per job)
  const int* nidx;
  const float *nlj1, *nlj2, *nqq, *nimx, *nimy, *nimz;
  int K;
  // K5 only
  SWC sw;
};

// Offset patterns (PATTERNS) and SHAKE offsets, passed by value.  Pattern
// p reads its parameter rows from row[p]; its roles sit at offsets
// 0, off[p][0], off[p][1], off[p][2] from the anchor atom.
struct Topo3 {
  int n_pat;
  int kind[MAXPAT];
  int off[MAXPAT][3];
  int row[MAXPAT];
  int n_shk;
  int shk_off[MAXSHK];
  int shake_iters, rattle_iters;
  float relax;
};

// shared-memory views of one job
struct Smem {
  float *px, *py, *pz, *vx, *vy, *vz, *fx, *fy, *fz;
  float* q;    // 12 N: bonded role forces (4 roles x 3 components), SHAKE
               // scratch, K5's ten adjoint rows
  float* red;  // MAXW x NRED reduction scratch
  float* misc; // NHC chain + broadcasts
};

__device__ __forceinline__ Smem carve(float* sm, int N) {
  Smem s;
  s.px = sm; s.py = s.px + N; s.pz = s.py + N;
  s.vx = s.pz + N; s.vy = s.vx + N; s.vz = s.vy + N;
  s.fx = s.vz + N; s.fy = s.fx + N; s.fz = s.fy + N;
  s.q = s.fz + N;
  s.red = s.q + 12 * N;
  s.misc = s.red + MAXW * NRED;
  return s;
}

__device__ __forceinline__ Box h_at(const Box& h0, const float* eps, float frac) {
  Box h;
  h.lx = h0.lx * (1.f + frac * eps[0]);
  h.ly = h0.ly * (1.f + frac * eps[1]);
  h.lz = h0.lz * (1.f + frac * eps[2]);
  h.xy = h0.xy + frac * eps[3] * h0.ly;
  h.xz = h0.xz + frac * eps[4] * h0.lz;
  h.yz = h0.yz + frac * eps[5] * h0.lz;
  return h;
}

// Sum K values over the block; every thread receives the totals.  Warp
// shuffles, then warp partials summed in warp order: a fixed order.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * NRED + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w * NRED + k];
    v[k] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void add_outer(float w[6], const float f[3], const float d[3]) {
  w[0] += f[0] * d[0];
  w[1] += f[1] * d[1];
  w[2] += f[2] * d[2];
  w[3] += 0.5f * (f[0] * d[1] + f[1] * d[0]);
  w[4] += 0.5f * (f[0] * d[2] + f[2] * d[0]);
  w[5] += 0.5f * (f[1] * d[2] + f[2] * d[1]);
}

// OPLS dihedral on the bond vectors b1, b2, b3 (Blondel-Karplus gradient):
// the four role forces F0..F3.
__device__ __forceinline__ void dihedral_forces(const float b1[3], const float b2[3],
                                                const float b3[3], float K1, float K2,
                                                float K3, float K4, float F0[3], float F1[3],
                                                float F2[3], float F3[3]) {
  const float n1[3] = {b1[1] * b2[2] - b1[2] * b2[1], b1[2] * b2[0] - b1[0] * b2[2],
                       b1[0] * b2[1] - b1[1] * b2[0]};
  const float n2[3] = {b2[1] * b3[2] - b2[2] * b3[1], b2[2] * b3[0] - b2[0] * b3[2],
                       b2[0] * b3[1] - b2[1] * b3[0]};
  const float n1sq = n1[0] * n1[0] + n1[1] * n1[1] + n1[2] * n1[2];
  const float n2sq = n2[0] * n2[0] + n2[1] * n2[1] + n2[2] * n2[2];
  const float b2sq = b2[0] * b2[0] + b2[1] * b2[1] + b2[2] * b2[2];
  const float nb2 = sqrtf(b2sq);
  const float inv_nn = rsqrtf(n1sq * n2sq);
  const float cphi = (n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2]) * inv_nn;
  const float cx[3] = {n1[1] * n2[2] - n1[2] * n2[1], n1[2] * n2[0] - n1[0] * n2[2],
                       n1[0] * n2[1] - n1[1] * n2[0]};
  const float s = (cx[0] * b2[0] + cx[1] * b2[1] + cx[2] * b2[2]) * inv_nn / nb2;
  const float sin2 = 2.f * s * cphi;
  const float sin3 = s * (3.f - 4.f * s * s);
  const float cos2 = 1.f - 2.f * s * s;
  const float sin4 = 2.f * sin2 * cos2;
  const float dE = 0.5f * (-K1 * s + 2.f * K2 * sin2 - 3.f * K3 * sin3 + 4.f * K4 * sin4);
  const float c0 = nb2 / n1sq, c3 = nb2 / n2sq;
  const float ts = (b1[0] * b2[0] + b1[1] * b2[1] + b1[2] * b2[2]) / b2sq;
  const float tu = (b3[0] * b2[0] + b3[1] * b2[1] + b3[2] * b2[2]) / b2sq;
  for (int a = 0; a < 3; ++a) {
    const float dp0 = -c0 * n1[a];
    const float dp3 = c3 * n2[a];
    const float dp1 = -(1.f + ts) * dp0 + tu * dp3;
    const float dp2 = ts * dp0 - (1.f + tu) * dp3;
    F0[a] = -dE * dp0; F1[a] = -dE * dp1; F2[a] = -dE * dp2; F3[a] = -dE * dp3;
  }
}

// Bonded chain terms anchored at atom k: role forces into q, virial into w.
__device__ void bonded_terms(const Params& P, const Smem& S, int k, float w[6]) {
  const int N = P.N;
  const float* topo = P.topo;
  float r0[3] = {0.f, 0.f, 0.f}, r1[3] = {0.f, 0.f, 0.f};
  float r2[3] = {0.f, 0.f, 0.f}, r3[3] = {0.f, 0.f, 0.f};
  const bool bm = k + 1 < N && topo[T_BMASK * N + k] > 0.5f;
  const bool am = k + 2 < N && topo[T_AMASK * N + k] > 0.5f;
  const bool dm = k + 3 < N && topo[T_DMASK * N + k] > 0.5f;
  if (bm || am || dm) {
    const float b[3] = {S.px[k + 1] - S.px[k], S.py[k + 1] - S.py[k],
                        S.pz[k + 1] - S.pz[k]};
    const float r2b = b[0] * b[0] + b[1] * b[1] + b[2] * b[2];
    if (bm) {  // E = K (r - r0)^2
      const float rb = sqrtf(r2b);
      const float fb = 2.f * topo[T_BK * N + k] * (rb - topo[T_BR0 * N + k]) / rb;
      const float f0[3] = {fb * b[0], fb * b[1], fb * b[2]};
      const float f1[3] = {-f0[0], -f0[1], -f0[2]};
      for (int a = 0; a < 3; ++a) { r0[a] += f0[a]; r1[a] += f1[a]; }
      add_outer(w, f1, b);
    }
    if (am || dm) {
      const float c2[3] = {S.px[k + 2] - S.px[k + 1], S.py[k + 2] - S.py[k + 1],
                           S.pz[k + 2] - S.pz[k + 1]};
      if (am) {  // angle (k, k+1, k+2): r1 = -b_k, r2 = b_{k+1}
        const float d11 = r2b;
        const float d22 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2];
        const float d12 = -(b[0] * c2[0] + b[1] * c2[1] + b[2] * c2[2]);
        const float inv12 = rsqrtf(d11 * d22);
        const float c = fminf(fmaxf(d12 * inv12, -1.f + 1e-7f), 1.f - 1e-7f);
        const float sin_th = sqrtf(fmaxf(1.f - c * c, 1e-30f));
        const float aE = -2.f * topo[T_AK * N + k] * (acosf(c) - topo[T_ATH0 * N + k]) / sin_th;
        float g1[3], g2[3], fa[3], fc[3], mb[3];
        for (int a = 0; a < 3; ++a) {
          g1[a] = c2[a] * inv12 + c * b[a] / d11;
          g2[a] = -b[a] * inv12 - c * c2[a] / d22;
          fa[a] = -aE * g1[a];
          fc[a] = -aE * g2[a];
          mb[a] = -b[a];
          r0[a] += fa[a];
          r1[a] += aE * (g1[a] + g2[a]);
          r2[a] += fc[a];
        }
        add_outer(w, fa, mb);
        add_outer(w, fc, c2);
      }
      if (dm) {  // OPLS dihedral (k..k+3), Blondel-Karplus gradient
        const float* b1 = b;
        const float* b2 = c2;
        const float b3[3] = {S.px[k + 3] - S.px[k + 2], S.py[k + 3] - S.py[k + 2],
                             S.pz[k + 3] - S.pz[k + 2]};
        const float n1[3] = {b1[1] * b2[2] - b1[2] * b2[1], b1[2] * b2[0] - b1[0] * b2[2],
                             b1[0] * b2[1] - b1[1] * b2[0]};
        const float n2[3] = {b2[1] * b3[2] - b2[2] * b3[1], b2[2] * b3[0] - b2[0] * b3[2],
                             b2[0] * b3[1] - b2[1] * b3[0]};
        const float n1sq = n1[0] * n1[0] + n1[1] * n1[1] + n1[2] * n1[2];
        const float n2sq = n2[0] * n2[0] + n2[1] * n2[1] + n2[2] * n2[2];
        const float b2sq = b2[0] * b2[0] + b2[1] * b2[1] + b2[2] * b2[2];
        const float nb2 = sqrtf(b2sq);
        const float inv_nn = rsqrtf(n1sq * n2sq);
        const float cphi = (n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2]) * inv_nn;
        const float cx[3] = {n1[1] * n2[2] - n1[2] * n2[1], n1[2] * n2[0] - n1[0] * n2[2],
                             n1[0] * n2[1] - n1[1] * n2[0]};
        const float s = (cx[0] * b2[0] + cx[1] * b2[1] + cx[2] * b2[2]) * inv_nn / nb2;
        const float sin2 = 2.f * s * cphi;
        const float sin3 = s * (3.f - 4.f * s * s);
        const float cos2 = 1.f - 2.f * s * s;
        const float sin4 = 2.f * sin2 * cos2;
        const float K1 = topo[(T_DK1 + 0) * N + k], K2 = topo[(T_DK1 + 1) * N + k];
        const float K3 = topo[(T_DK1 + 2) * N + k], K4 = topo[(T_DK1 + 3) * N + k];
        const float dE = 0.5f * (-K1 * s + 2.f * K2 * sin2 - 3.f * K3 * sin3 + 4.f * K4 * sin4);
        const float c0 = nb2 / n1sq, c3 = nb2 / n2sq;
        const float ts = (b1[0] * b2[0] + b1[1] * b2[1] + b1[2] * b2[2]) / b2sq;
        const float tu = (b3[0] * b2[0] + b3[1] * b2[1] + b3[2] * b2[2]) / b2sq;
        float F0[3], F1[3], F2[3], F3[3], s12[3], s123[3];
        for (int a = 0; a < 3; ++a) {
          const float dp0 = -c0 * n1[a];
          const float dp3 = c3 * n2[a];
          const float dp1 = -(1.f + ts) * dp0 + tu * dp3;
          const float dp2 = ts * dp0 - (1.f + tu) * dp3;
          F0[a] = -dE * dp0; F1[a] = -dE * dp1; F2[a] = -dE * dp2; F3[a] = -dE * dp3;
          r0[a] += F0[a]; r1[a] += F1[a]; r2[a] += F2[a]; r3[a] += F3[a];
          s12[a] = b1[a] + b2[a];
          s123[a] = s12[a] + b3[a];
        }
        add_outer(w, F1, b1);
        add_outer(w, F2, s12);
        add_outer(w, F3, s123);
      }
    }
  }
  for (int a = 0; a < 3; ++a) {
    S.q[(0 * 3 + a) * N + k] = r0[a];
    S.q[(1 * 3 + a) * N + k] = r1[a];
    S.q[(2 * 3 + a) * N + k] = r2[a];
    S.q[(3 * 3 + a) * N + k] = r3[a];
  }
}

// The chain terms anchored at atom k (bonded_terms on float4 positions;
// md_k1.cu and md_charged.cuh): role r's force on atom k + r into
// q[(3 r + a) qs + slot], and with WV the term's virial into w.
template <bool WV>
__device__ void k1_bonded(const float* __restrict__ topo, int N, const float4* p4, float* q,
                          int qs, int k, int slot, float w[6]) {
  float r0[3] = {0.f, 0.f, 0.f}, r1[3] = {0.f, 0.f, 0.f};
  float r2[3] = {0.f, 0.f, 0.f}, r3[3] = {0.f, 0.f, 0.f};
  const bool bm = k + 1 < N && topo[T_BMASK * N + k] > 0.5f;
  const bool am = k + 2 < N && topo[T_AMASK * N + k] > 0.5f;
  const bool dm = k + 3 < N && topo[T_DMASK * N + k] > 0.5f;
  if (bm || am || dm) {
    const float4 pk = p4[k], pk1 = p4[k + 1];
    const float b[3] = {pk1.x - pk.x, pk1.y - pk.y, pk1.z - pk.z};
    const float r2b = b[0] * b[0] + b[1] * b[1] + b[2] * b[2];
    if (bm) {  // E = K (r - r0)^2
      const float rb = sqrtf(r2b);
      const float fb = 2.f * topo[T_BK * N + k] * (rb - topo[T_BR0 * N + k]) / rb;
      const float f0[3] = {fb * b[0], fb * b[1], fb * b[2]};
      const float f1[3] = {-f0[0], -f0[1], -f0[2]};
      for (int a = 0; a < 3; ++a) { r0[a] += f0[a]; r1[a] += f1[a]; }
      if constexpr (WV) add_outer(w, f1, b);
    }
    if (am || dm) {
      const float4 pk2 = p4[k + 2];
      const float c2[3] = {pk2.x - pk1.x, pk2.y - pk1.y, pk2.z - pk1.z};
      if (am) {  // angle (k, k+1, k+2): r1 = -b_k, r2 = b_{k+1}
        const float d11 = r2b;
        const float d22 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2];
        const float d12 = -(b[0] * c2[0] + b[1] * c2[1] + b[2] * c2[2]);
        const float inv12 = rsqrtf(d11 * d22);
        const float c = fminf(fmaxf(d12 * inv12, -1.f + 1e-7f), 1.f - 1e-7f);
        const float sin_th = sqrtf(fmaxf(1.f - c * c, 1e-30f));
        const float aE = -2.f * topo[T_AK * N + k] * (acosf(c) - topo[T_ATH0 * N + k]) / sin_th;
        float g1[3], g2[3], fa[3], fc[3], mb[3];
        for (int a = 0; a < 3; ++a) {
          g1[a] = c2[a] * inv12 + c * b[a] / d11;
          g2[a] = -b[a] * inv12 - c * c2[a] / d22;
          fa[a] = -aE * g1[a];
          fc[a] = -aE * g2[a];
          mb[a] = -b[a];
          r0[a] += fa[a];
          r1[a] += aE * (g1[a] + g2[a]);
          r2[a] += fc[a];
        }
        if constexpr (WV) {
          add_outer(w, fa, mb);
          add_outer(w, fc, c2);
        }
      }
      if (dm) {  // OPLS dihedral (k..k+3)
        const float4 pk3 = p4[k + 3];
        const float b3[3] = {pk3.x - pk2.x, pk3.y - pk2.y, pk3.z - pk2.z};
        float F0[3], F1[3], F2[3], F3[3];
        dihedral_forces(b, c2, b3, topo[(T_DK1 + 0) * N + k], topo[(T_DK1 + 1) * N + k],
                        topo[(T_DK1 + 2) * N + k], topo[(T_DK1 + 3) * N + k], F0, F1, F2, F3);
        for (int a = 0; a < 3; ++a) {
          r0[a] += F0[a]; r1[a] += F1[a]; r2[a] += F2[a]; r3[a] += F3[a];
        }
        if constexpr (WV) {
          float s12[3], s123[3];
          for (int a = 0; a < 3; ++a) {
            s12[a] = b[a] + c2[a];
            s123[a] = s12[a] + b3[a];
          }
          add_outer(w, F1, b);
          add_outer(w, F2, s12);
          add_outer(w, F3, s123);
        }
      }
    }
  }
  for (int a = 0; a < 3; ++a) {
    q[(0 * 3 + a) * qs + slot] = r0[a];
    q[(1 * 3 + a) * qs + slot] = r1[a];
    q[(2 * 3 + a) * qs + slot] = r2[a];
    q[(3 * 3 + a) * qs + slot] = r3[a];
  }
}

// The bonded role forces that land on atom i (its slot in q), in role order.
__device__ __forceinline__ void k1_gather(const float* q, int qs, int i, int slot, float g[3]) {
  for (int a = 0; a < 3; ++a) {
    float acc = q[(0 * 3 + a) * qs + slot];
    if (i >= 1) acc += q[(1 * 3 + a) * qs + slot - 1];
    if (i >= 2) acc += q[(2 * 3 + a) * qs + slot - 2];
    if (i >= 3) acc += q[(3 * 3 + a) * qs + slot - 3];
    g[a] = acc;
  }
}

// Positions read and written through an accessor, so that the bonded and
// constraint sweeps below serve both layouts: separate x, y, z rows (Smem,
// the first design) and one float4 per atom (md_charged.cuh).
struct SoAPos {
  float *px, *py, *pz;
  __device__ __forceinline__ float& x(int i) const { return px[i]; }
  __device__ __forceinline__ float& y(int i) const { return py[i]; }
  __device__ __forceinline__ float& z(int i) const { return pz[i]; }
  __device__ __forceinline__ float3 at(int i) const { return make_float3(px[i], py[i], pz[i]); }
};

struct F4Pos {
  float4* p;
  __device__ __forceinline__ float& x(int i) const { return p[i].x; }
  __device__ __forceinline__ float& y(int i) const { return p[i].y; }
  __device__ __forceinline__ float& z(int i) const { return p[i].z; }
  __device__ __forceinline__ float3 at(int i) const {
    const float4 v = p[i];
    return make_float3(v.x, v.y, v.z);
  }
};

// One offset pattern anchored at atom a: role forces into q (roles 0..3 at
// offsets 0, off[0], off[1], off[2]; role k's component c at q[(3 k + c) qs
// + slot]).  Terms whose parameters are zero or whose partners fall outside
// the box write zeros.
template <class PA>
__device__ void pattern_term(const float* __restrict__ pat, int N, const Topo3& T, const PA& X,
                             float* q, int qs, int p, int a, int slot) {
  const int kind = T.kind[p];
  const float* rows = pat + (size_t)T.row[p] * N;
  float r[4][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  const int nrole = kind == PAT_BOND ? 2 : (kind == PAT_ANGLE ? 3 : 4);
  bool inside = true;
  for (int k = 1; k < nrole; ++k) {
    const int j = a + T.off[p][k - 1];
    inside = inside && j >= 0 && j < N;
  }
  if (inside) {
    const float3 pa = X.at(a);
    if (kind == PAT_BOND) {
      const float K = rows[a], r0 = rows[N + a];
      if (K > 0.f) {
        const float3 pj = X.at(a + T.off[p][0]);
        const float b[3] = {pj.x - pa.x, pj.y - pa.y, pj.z - pa.z};
        const float rb = sqrtf(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
        const float fb = 2.f * K * (rb - r0) / rb;
        for (int c = 0; c < 3; ++c) { r[0][c] = fb * b[c]; r[1][c] = -fb * b[c]; }
      }
    } else if (kind == PAT_ANGLE) {
      const float K = rows[a], th0 = rows[N + a];
      if (K > 0.f) {
        const float3 pa1 = X.at(a + T.off[p][0]), pb = X.at(a + T.off[p][1]);
        const float r1[3] = {pa1.x - pa.x, pa1.y - pa.y, pa1.z - pa.z};
        const float r2[3] = {pb.x - pa.x, pb.y - pa.y, pb.z - pa.z};
        const float d11 = r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2];
        const float d22 = r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2];
        const float d12 = r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2];
        const float inv12 = rsqrtf(d11 * d22);
        const float c = fminf(fmaxf(d12 * inv12, -1.f + 1e-7f), 1.f - 1e-7f);
        const float sin_th = sqrtf(fmaxf(1.f - c * c, 1e-30f));
        const float aE = -2.f * K * (acosf(c) - th0) / sin_th;
        for (int k = 0; k < 3; ++k) {
          const float g1 = r2[k] * inv12 - c * r1[k] / d11;
          const float g2 = r1[k] * inv12 - c * r2[k] / d22;
          r[0][k] = aE * (g1 + g2);
          r[1][k] = -aE * g1;
          r[2][k] = -aE * g2;
        }
      }
    } else {
      const float K1 = rows[a], K2 = rows[N + a], K3 = rows[2 * N + a], K4 = rows[3 * N + a];
      if (fabsf(K1) + fabsf(K2) + fabsf(K3) + fabsf(K4) > 0.f) {
        const float3 p1 = X.at(a + T.off[p][0]), p2 = X.at(a + T.off[p][1]);
        const float3 p3 = X.at(a + T.off[p][2]);
        const float b1[3] = {p1.x - pa.x, p1.y - pa.y, p1.z - pa.z};
        const float b2[3] = {p2.x - p1.x, p2.y - p1.y, p2.z - p1.z};
        const float b3[3] = {p3.x - p2.x, p3.y - p2.y, p3.z - p2.z};
        dihedral_forces(b1, b2, b3, K1, K2, K3, K4, r[0], r[1], r[2], r[3]);
      }
    }
  }
  for (int k = 0; k < nrole; ++k)
    for (int c = 0; c < 3; ++c) q[(k * 3 + c) * qs + slot] = r[k][c];
}

__device__ __forceinline__ void pattern_term(const Params& P, const Topo3& T, const Smem& S,
                                             int p, int a) {
  pattern_term(P.pat, P.N, T, SoAPos{S.px, S.py, S.pz}, S.q, P.N, p, a, a);
}

// F/r of one pair at squared distance r2 into fp; false (fp untouched)
// unless lj_live or q_live.  The coefficients lj1, lj2 (and qq with COUL)
// are read at offset o only for a live pair.  K1 takes 1/max(r2, r2min);
// with COUL the inverse comes from rsqrt, which the Coulomb term shares.
template <bool COUL, bool EWALD>
__device__ __forceinline__ bool pair_force(const Params& P, float r2, bool lj_live,
                                           bool q_live, const float* lj1, const float* lj2,
                                           const float* qq, size_t o, float& fp) {
  if constexpr (!COUL) {
    if (!lj_live) return false;
    const float a1 = __ldg(lj1 + o), a2 = __ldg(lj2 + o);
    const float inv = 1.f / fmaxf(r2, P.r2min);
    const float u2 = inv * inv;
    const float u3 = u2 * inv;
    fp = (a1 * u3 - a2) * u2 * u2;
    return true;
  } else {
    if (!lj_live && !q_live) return false;
    const float r2c = fmaxf(r2, P.r2min);
    const float inv_r = rsqrtf(r2c);
    const float inv2 = inv_r * inv_r;
    fp = 0.f;
    if (lj_live) {
      const float a1 = __ldg(lj1 + o), a2 = __ldg(lj2 + o);
      const float u2 = inv2 * inv2;
      const float u3 = u2 * inv2;
      fp = (a1 * u3 - a2) * u2 * u2;
    }
    if (q_live) {
      const float q = __ldg(qq + o);
      if constexpr (EWALD) {
        const float x = P.alpha * (r2c * inv_r);
        const float ex = expf(-x * x);
        const float t = 1.f / (1.f + 0.3275911f * x);
        const float erfc_x =
            t * ex * (0.254829592f + t * (-0.284496736f + t * (
                1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
        fp += q * inv2 * (erfc_x * inv_r + EWALD_F * P.alpha * ex);
      } else {
        fp += q * inv_r * inv2;
      }
    }
    return true;
  }
}

// Apply one pair's F/r to atom i's force and (with want_w) half of its
// virial d (x) d.
__device__ __forceinline__ void apply_pair(float fp, float dx, float dy, float dz,
                                           bool want_w, float& fxi, float& fyi,
                                           float& fzi, float wl[6]) {
  fxi -= fp * dx;
  fyi -= fp * dy;
  fzi -= fp * dz;
  if (want_w) {
    const float hp = 0.5f * fp;
    wl[0] += hp * dx * dx;
    wl[1] += hp * dy * dy;
    wl[2] += hp * dz * dz;
    wl[3] += hp * dx * dy;
    wl[4] += hp * dx * dz;
    wl[5] += hp * dy * dz;
  }
}

// Minimum image of d = x_j - x_i in place and its r^2: the sequential
// triclinic rounding (z, then y, then x) of the TPU kernel's
// refresh_images / block_geom, exact while every box height exceeds twice
// the cutoff
__device__ __forceinline__ float min_image_r2(const Box& h, float ilx, float ily, float ilz,
                                              float& dx, float& dy, float& dz) {
  const float n3 = rintf(dz * ilz);
  dz -= n3 * h.lz;
  dy -= n3 * h.yz;
  const float n2 = rintf(dy * ily);
  dy -= n2 * h.ly;
  dx -= n3 * h.xz + n2 * h.xy;
  const float n1 = rintf(dx * ilx);
  dx -= n1 * h.lx;
  return dx * dx + dy * dy + dz * dz;
}

// Pair (+ bonded) forces (and, with want_w, this thread's virial partial
// sums) at the positions in shared memory for box h.  Entry and exit are
// block-synced.  All-pairs (K1/K3): every j with the per-pair minimum
// image.  LIST (K4): this block's job's K list slots, read slot-major so the
// reads coalesce over i.
template <bool COUL, bool EWALD, bool PAT, bool LIST>
__device__ void pair_forces(const Params& P, const Topo3& T, const Smem& S,
                            const Box& h, bool want_w, float w[6]) {
  const int N = P.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  for (int i = tid; i < N; i += nt) {
    const float xi = S.px[i], yi = S.py[i], zi = S.pz[i];
    float fxi = 0.f, fyi = 0.f, fzi = 0.f;
    float wl[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (LIST) {
      const size_t base = (size_t)blockIdx.x * P.K * N + i;
      for (int s = 0; s < P.K; ++s) {
        const size_t o = base + (size_t)s * N;
        const int j = __ldg(P.nidx + o);
        const float nx = __ldg(P.nimx + o), ny = __ldg(P.nimy + o), nz = __ldg(P.nimz + o);
        const float dx = S.px[j] + nx * h.lx + ny * h.xy + nz * h.xz - xi;
        const float dy = S.py[j] + ny * h.ly + nz * h.yz - yi;
        const float dz = S.pz[j] + nz * h.lz - zi;
        const float r2 = dx * dx + dy * dy + dz * dz;
        const bool above = r2 > P.r2min;  // dead self-padded slots: r2 = 0
        float fp;
        if (pair_force<COUL, EWALD>(P, r2, above && r2 < P.cutoff2,
                                    COUL && above && r2 < P.coul_cutoff2, P.nlj1, P.nlj2,
                                    P.nqq, o, fp))
          apply_pair(fp, dx, dy, dz, want_w, fxi, fyi, fzi, wl);
      }
    } else {
      for (int j = 0; j < N; ++j) {
        float dx = S.px[j] - xi, dy = S.py[j] - yi, dz = S.pz[j] - zi;
        const float r2 = min_image_r2(h, ilx, ily, ilz, dx, dy, dz);
        float fp;
        if (pair_force<COUL, EWALD>(P, r2, r2 < P.cutoff2, COUL && r2 < P.coul_cutoff2,
                                    P.lj1, P.lj2, P.qq, (size_t)j * N + i, fp))
          apply_pair(fp, dx, dy, dz, want_w, fxi, fyi, fzi, wl);
      }
    }
    S.fx[i] = fxi;
    S.fy[i] = fyi;
    S.fz[i] = fzi;
    if constexpr (!PAT) bonded_terms(P, S, i, wl);
    if (want_w)
      for (int k = 0; k < 6; ++k) w[k] += wl[k];
  }
  __syncthreads();
  if constexpr (!PAT) {
    for (int i = tid; i < N; i += nt) {
      float g[3];
      for (int a = 0; a < 3; ++a) {
        float acc = S.q[(0 * 3 + a) * N + i];
        if (i >= 1) acc += S.q[(1 * 3 + a) * N + i - 1];
        if (i >= 2) acc += S.q[(2 * 3 + a) * N + i - 2];
        if (i >= 3) acc += S.q[(3 * 3 + a) * N + i - 3];
        g[a] = acc;
      }
      S.fx[i] += g[0];
      S.fy[i] += g[1];
      S.fz[i] += g[2];
    }
    __syncthreads();
  } else {
    // one pass per pattern: every anchor writes its roles, then every atom
    // gathers the roles that land on it; the virial is sum_i f_i (x) r_i
    // over the pattern forces (bonded_pattern_forces)
    for (int p = 0; p < T.n_pat; ++p) {
      for (int a = tid; a < N; a += nt) pattern_term(P, T, S, p, a);
      __syncthreads();
      const int nrole = T.kind[p] == PAT_BOND ? 2 : (T.kind[p] == PAT_ANGLE ? 3 : 4);
      for (int i = tid; i < N; i += nt) {
        float g[3] = {S.q[i], S.q[N + i], S.q[2 * N + i]};
        for (int k = 1; k < nrole; ++k) {
          const int a = i - T.off[p][k - 1];
          if (a >= 0 && a < N)
            for (int c = 0; c < 3; ++c) g[c] += S.q[(k * 3 + c) * N + a];
        }
        S.fx[i] += g[0];
        S.fy[i] += g[1];
        S.fz[i] += g[2];
        if (want_w) {
          const float r[3] = {S.px[i], S.py[i], S.pz[i]};
          add_outer(w, g, r);
        }
      }
      __syncthreads();
    }
  }
}

// K5's w = dT/dd of one ordered pair along u for a centre with adjoints
// a = (a_s, a_mx, a_my, a_mz, a_Qxx, a_Qyy, a_Qzz, a_Qxy, a_Qxz, a_Qyz)
// (w_of, md_fused.py:1011-1029)
__device__ __forceinline__ void sw_w(const SWC& C, float ux, float uy, float uz, float inv_r,
                                     float g, float dg, float radial0, const float a[10],
                                     float wv[3]) {
  const float am_u = a[1] * ux + a[2] * uy + a[3] * uz;
  const float qx = a[4] * ux + a[7] * uy + a[8] * uz;
  const float qy = a[7] * ux + a[5] * uy + a[9] * uz;
  const float qz = a[8] * ux + a[9] * uy + a[6] * uz;
  const float uqu = ux * qx + uy * qy + uz * qz;
  const float radial = radial0 + dg * (a[0] + 2.f * C.a_gsq * g + am_u + uqu);
  const float tang = g * inv_r;
  const float t2 = am_u + 2.f * uqu;
  wv[0] = radial * ux + tang * (a[1] + 2.f * qx - t2 * ux);
  wv[1] = radial * uy + tang * (a[2] + 2.f * qy - t2 * uy);
  wv[2] = radial * uz + tang * (a[3] + 2.f * qz - t2 * uz);
}

// K5: Stillinger-Weber forces (and, with want_w, this thread's share of
// role A's virial) in two all-pairs sweeps; the ten adjoint rows live in
// S.q between them.  Entry and exit are block-synced.
__device__ void sw_forces(const Params& P, const Smem& S, const Box& h, bool want_w,
                          float w[6]) {
  const int N = P.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const SWC& C = P.sw;
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  float* adj = S.q;
  for (int i = tid; i < N; i += nt) {
    const float xi = S.px[i], yi = S.py[i], zi = S.pz[i];
    float m[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < N; ++j) {  // j = i has r2 = 0: never live
      float dx = S.px[j] - xi, dy = S.py[j] - yi, dz = S.pz[j] - zi;
      const float r2 = min_image_r2(h, ilx, ily, ilz, dx, dy, dz);
      if (r2 < C.rc2 && r2 > 1e-8f) {
        const float r = sqrtf(r2);
        const float inv_r = 1.f / r;
        const float g = expf(C.gs / (r - C.rc));
        const float ux = dx * inv_r, uy = dy * inv_r, uz = dz * inv_r;
        const float gx = g * ux, gy = g * uy, gz = g * uz;
        m[0] += g;
        m[1] += gx; m[2] += gy; m[3] += gz;
        m[4] += gx * ux; m[5] += gy * uy; m[6] += gz * uz;
        m[7] += gx * uy; m[8] += gx * uz; m[9] += gy * uz;
      }
    }
    adj[i] = C.k_s * m[0];
    for (int k = 1; k < 4; ++k) adj[k * N + i] = C.k_m * m[k];
    for (int k = 4; k < 10; ++k) adj[k * N + i] = C.lam_eps * m[k];
  }
  __syncthreads();
  for (int i = tid; i < N; i += nt) {
    const float xi = S.px[i], yi = S.py[i], zi = S.pz[i];
    float a[10];
    for (int k = 0; k < 10; ++k) a[k] = adj[k * N + i];
    float fxi = 0.f, fyi = 0.f, fzi = 0.f;
    float wl[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < N; ++j) {
      float dx = S.px[j] - xi, dy = S.py[j] - yi, dz = S.pz[j] - zi;
      const float r2 = min_image_r2(h, ilx, ily, ilz, dx, dy, dz);
      if (r2 < C.rc2 && r2 > 1e-8f) {
        const float r = sqrtf(r2);
        const float inv_r = 1.f / r;
        const float ux = dx * inv_r, uy = dy * inv_r, uz = dz * inv_r;
        const float denom = r - C.rc;
        const float expo = expf(C.sig / denom);
        const float sr = C.sig * inv_r;
        const float sr2 = sr * sr;
        const float srp = sr2 * sr2;  // p = 4
        const float phi2 = C.aeps * (C.b * srp - 1.f) * expo;  // q = 0
        const float id2 = denom * denom;
        const float dphi2 = C.aeps * (C.m4b * srp * inv_r) * expo + phi2 * (-C.sig / id2);
        const float g = expf(C.gs / denom);
        const float dg = g * (-C.gs / id2);
        const float radial0 = 0.5f * dphi2;
        float b[10];
        for (int k = 0; k < 10; ++k) b[k] = adj[k * N + j];
        float wa[3], wb[3];
        sw_w(C, ux, uy, uz, inv_r, g, dg, radial0, a, wa);
        sw_w(C, -ux, -uy, -uz, inv_r, g, dg, radial0, b, wb);
        fxi += wa[0] - wb[0];
        fyi += wa[1] - wb[1];
        fzi += wa[2] - wb[2];
        if (want_w) {  // role A enumerates every ordered pair once
          wl[0] -= wa[0] * dx;
          wl[1] -= wa[1] * dy;
          wl[2] -= wa[2] * dz;
          wl[3] -= 0.5f * (wa[0] * dy + wa[1] * dx);
          wl[4] -= 0.5f * (wa[0] * dz + wa[2] * dx);
          wl[5] -= 0.5f * (wa[1] * dz + wa[2] * dy);
        }
      }
    }
    S.fx[i] = fxi;
    S.fy[i] = fyi;
    S.fz[i] = fzi;
    if (want_w)
      for (int k = 0; k < 6; ++k) w[k] += wl[k];
  }
  __syncthreads();
}

// Forces at the positions in shared memory for box h: K5's sweeps with
// SW, the pair loop (+ bonded terms) otherwise.  Entry and exit are
// block-synced.
template <bool COUL, bool EWALD, bool PAT, bool LIST, bool SW>
__device__ __forceinline__ void compute_forces(const Params& P, const Topo3& T, const Smem& S,
                                               const Box& h, bool want_w, float w[6]) {
  if constexpr (SW)
    sw_forces(P, S, h, want_w, w);
  else
    pair_forces<COUL, EWALD, PAT, LIST>(P, T, S, h, want_w, w);
}

// One half-step of the NHC-3 chain vxi[0..2] (MTK), the scalar twin of
// nhc_half, at twice the kinetic energy ke2; returns the velocity scale.
__device__ __forceinline__ float nhc_chain(float* vxi, float ke2, float dt, float kt,
                                           float ndof, float tdamp) {
  const float q0 = ndof * kt * tdamp * tdamp;
  const float q1 = kt * tdamp * tdamp;
  const float dt2 = dt / 2.f, dt4 = dt / 4.f, dt8 = dt / 8.f;
  // tail -> head
  vxi[2] = vxi[2] + dt4 * ((q1 * vxi[1] * vxi[1] - kt) / q1);
  float s = expf(-dt8 * vxi[2]);
  vxi[1] = s * (s * vxi[1] + dt4 * ((q0 * vxi[0] * vxi[0] - kt) / q1));
  s = expf(-dt8 * vxi[1]);
  vxi[0] = s * (s * vxi[0] + dt4 * ((ke2 - ndof * kt) / q0));
  const float scale = expf(-dt2 * vxi[0]);
  ke2 = ke2 * scale * scale;
  // head -> tail
  s = expf(-dt8 * vxi[1]);
  vxi[0] = s * (s * vxi[0] + dt4 * ((ke2 - ndof * kt) / q0));
  s = expf(-dt8 * vxi[2]);
  vxi[1] = s * (s * vxi[1] + dt4 * ((q0 * vxi[0] * vxi[0] - kt) / q1));
  vxi[2] = vxi[2] + dt4 * ((q1 * vxi[1] * vxi[1] - kt) / q1);
  return scale;
}

// Half-step Nose-Hoover chain (MTK), the scalar twin of nhc_half: the
// block reduces 2 KE, thread 0 advances the chain in S.misc[0..2] and
// broadcasts the velocity scale; every thread rescales its atoms.
__device__ void nhc_half(const Smem& S, const float* __restrict__ mftm, int N,
                         float dt, float kt, float ndof, float tdamp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float ke[1] = {0.f};
  for (int i = tid; i < N; i += nt)
    ke[0] += mftm[i] * (S.vx[i] * S.vx[i] + S.vy[i] * S.vy[i] + S.vz[i] * S.vz[i]);
  block_sum<1>(ke, S.red);
  if (tid == 0) S.misc[NHC] = nhc_chain(S.misc, ke[0], dt, kt, ndof, tdamp);
  __syncthreads();
  const float scale = S.misc[NHC];
  for (int i = tid; i < N; i += nt) {
    S.vx[i] *= scale;
    S.vy[i] *= scale;
    S.vz[i] *= scale;
  }
}

// Jacobi SHAKE (shake_rolls): project the drifted positions X onto the
// constraints, reference directions from the pre-drift positions in
// S.q[0..3N); fold the correction into the velocities.  S.f holds the
// drifted positions meanwhile.  Entry and exit are block-synced.
template <class PA>
__device__ void shake(const float* __restrict__ shk, int N, const Topo3& T, const PA& X,
                      const Smem& S, const float* __restrict__ invm, float inv_dt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float *ox = S.q, *oy = S.q + N, *oz = S.q + 2 * N;
  float* G = S.q + 3 * N;  // n_shk x N Lagrange factors
  for (int it = 0; it < T.shake_iters; ++it) {
    for (int a = tid; a < N; a += nt) {
      for (int k = 0; k < T.n_shk; ++k) {
        const int j = a + T.shk_off[k];
        const float d0sq = j < N ? shk[(size_t)k * N + a] : 0.f;
        float g = 0.f;
        if (d0sq > 0.f) {
          const float3 pj = X.at(j), pa = X.at(a);
          const float rx = pj.x - pa.x, ry = pj.y - pa.y, rz = pj.z - pa.z;
          const float qx = ox[j] - ox[a], qy = oy[j] - oy[a], qz = oz[j] - oz[a];
          const float diff = rx * rx + ry * ry + rz * rz - d0sq;
          const float denom = 2.f * (rx * qx + ry * qy + rz * qz) * (invm[a] + invm[j]) + 1e-30f;
          g = T.relax * diff / denom;
        }
        G[k * N + a] = g;
      }
    }
    __syncthreads();
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      float d[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < T.n_shk; ++k) {
        const int o = T.shk_off[k];
        const int j = i + o, a = i - o;  // i as anchor (partner j); i as partner of a
        float c[3] = {0.f, 0.f, 0.f}, cb[3] = {0.f, 0.f, 0.f};
        if (j < N) {
          const float g = G[k * N + i];
          c[0] = g * (ox[j] - ox[i]); c[1] = g * (oy[j] - oy[i]); c[2] = g * (oz[j] - oz[i]);
        }
        if (a >= 0) {
          const float g = G[k * N + a];
          cb[0] = g * (ox[i] - ox[a]); cb[1] = g * (oy[i] - oy[a]); cb[2] = g * (oz[i] - oz[a]);
        }
        for (int e = 0; e < 3; ++e) d[e] += c[e] * im - cb[e] * im;
      }
      X.x(i) += d[0];
      X.y(i) += d[1];
      X.z(i) += d[2];
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += nt) {
    const float3 p = X.at(i);
    S.vx[i] += (p.x - S.fx[i]) * inv_dt;
    S.vy[i] += (p.y - S.fy[i]) * inv_dt;
    S.vz[i] += (p.z - S.fz[i]) * inv_dt;
  }
  __syncthreads();
}

__device__ __forceinline__ void shake(const Params& P, const Topo3& T, const Smem& S,
                                      const float* __restrict__ invm, float inv_dt) {
  shake(P.shk, P.N, T, SoAPos{S.px, S.py, S.pz}, S, invm, inv_dt);
}

// Jacobi RATTLE (rattle_rolls): remove the relative velocity along every
// constrained bond.  Entry and exit are block-synced.
template <class PA>
__device__ void rattle(const float* __restrict__ shk, int N, const Topo3& T, const PA& X,
                       const Smem& S, const float* __restrict__ invm) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* G = S.q;  // n_shk x N factors
  for (int it = 0; it < T.rattle_iters; ++it) {
    for (int a = tid; a < N; a += nt) {
      for (int k = 0; k < T.n_shk; ++k) {
        const int j = a + T.shk_off[k];
        const float d0sq = j < N ? shk[(size_t)k * N + a] : 0.f;
        float g = 0.f;
        if (d0sq > 0.f) {
          const float3 pj = X.at(j), pa = X.at(a);
          const float rx = pj.x - pa.x, ry = pj.y - pa.y, rz = pj.z - pa.z;
          const float r2 = rx * rx + ry * ry + rz * rz;
          const float dvx = S.vx[j] - S.vx[a], dvy = S.vy[j] - S.vy[a], dvz = S.vz[j] - S.vz[a];
          g = T.relax * (dvx * rx + dvy * ry + dvz * rz) / (r2 * (invm[a] + invm[j]) + 1e-30f);
        }
        G[k * N + a] = g;
      }
    }
    __syncthreads();
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      const float3 pi = X.at(i);
      float d[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < T.n_shk; ++k) {
        const int o = T.shk_off[k];
        const int j = i + o, a = i - o;
        float c[3] = {0.f, 0.f, 0.f}, cb[3] = {0.f, 0.f, 0.f};
        if (j < N) {
          const float g = G[k * N + i];
          const float3 pj = X.at(j);
          c[0] = g * (pj.x - pi.x); c[1] = g * (pj.y - pi.y); c[2] = g * (pj.z - pi.z);
        }
        if (a >= 0) {
          const float g = G[k * N + a];
          const float3 pa = X.at(a);
          cb[0] = g * (pi.x - pa.x); cb[1] = g * (pi.y - pa.y); cb[2] = g * (pi.z - pa.z);
        }
        for (int e = 0; e < 3; ++e) d[e] += c[e] * im - cb[e] * im;
      }
      S.vx[i] += d[0];
      S.vy[i] += d[1];
      S.vz[i] += d[2];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void rattle(const Params& P, const Topo3& T, const Smem& S,
                                       const float* __restrict__ invm) {
  rattle(P.shk, P.N, T, SoAPos{S.px, S.py, S.pz}, S, invm);
}

template <bool FEXT>
__device__ __forceinline__ void add_fext(const Smem& S, const float* __restrict__ fx,
                                         int N) {
  if constexpr (FEXT) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      S.fx[i] += fx[i];
      S.fy[i] += fx[N + i];
      S.fz[i] += fx[2 * N + i];
    }
  }
}

struct RunArgs {
  const float* invm;
  const float* mftm;
  float* state;
  float* vxi;
  float* press;
  const int* n_run;
  const int* gstep0;  // FEXT only
  const int* n_tot;   // FEXT only
  const float* fscal;
  const float* fext;  // (B, 3, N), FEXT only
  int deform, sample;
  float ndof, boltz, nktv2p, tdamp;
};

// __launch_bounds__: the block width each instantiation is compiled for, so
// that ptxas keeps the registers that width allows (65536 / threads) and
// the ported boxes take the fewest rounds of one thread per atom: 1792
// charged atoms in 2 rounds of 896 threads (<= 72 registers), 2240 list
// atoms in 3 of 768 (<= 80), K1's 512 sites in one of 512.  Left to
// itself ptxas spends 82-133 registers on the charged and list
// instances, which narrows the block to 480-736 threads and adds a round
// (one more pass over the pair loop per force call).  K5 (SW) takes 512:
// one round at N = 216 (224 threads) and at N = 512, <= 128 registers for
// sweep 2's 20 adjoints and the pair geometry.
template <bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT, bool LIST, bool SW = false>
__global__ void __launch_bounds__(LIST ? 768 : (COUL ? 896 : 512))
md_run_kernel(Params P, Topo3 T, RunArgs A) {
  extern __shared__ float sm[];
  const int job = blockIdx.x;
  const int N = P.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_run = A.n_run[job];
  if (n_run <= 0) {
    if (tid < 6) A.press[job * 6 + tid] = 0.f;
    return;
  }
  const float* __restrict__ invm = A.invm;
  const float* __restrict__ mftm = A.mftm;
  Smem S = carve(sm, N);
  float* st = A.state + (size_t)job * 6 * N;
  for (int i = tid; i < N; i += nt) {
    S.px[i] = st[i]; S.py[i] = st[N + i]; S.pz[i] = st[2 * N + i];
    S.vx[i] = st[3 * N + i]; S.vy[i] = st[4 * N + i]; S.vz[i] = st[5 * N + i];
  }
  if (tid < NHC) S.misc[tid] = A.vxi[job * NHC + tid];
  const float* fs = A.fscal + (size_t)job * FSCAL;
  const float dt = fs[F_DT];
  const float kt = A.boltz * fs[F_T];
  const Box h0 = {fs[F_H0], fs[F_H0 + 1], fs[F_H0 + 2], fs[F_H0 + 3], fs[F_H0 + 4], fs[F_H0 + 5]};
  float eps[6];
  for (int k = 0; k < 6; ++k) eps[k] = fs[F_EPS + k];
  // per-job step offsets only for chunked runs (FEXT: K3's k-space chunks;
  // LIST: K4's rebuild chunks); K1 runs whole
  const float n_tot = (FEXT || LIST) ? (float)A.n_tot[job] : (float)n_run;
  const int deform = A.deform, sample = A.sample;
  __syncthreads();

  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float pacc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int g0 = 0;
  const float* fext = nullptr;
  if constexpr (FEXT || LIST) {
    g0 = A.gstep0[job];
    if constexpr (FEXT) fext = A.fext + (size_t)job * 3 * N;
    // chunk-start forces at the chunk's own box, with this chunk's fext
    compute_forces<COUL, EWALD, PAT, LIST, SW>(
        P, T, S, deform ? h_at(h0, eps, (float)g0 / n_tot) : h0, false, w);
    add_fext<FEXT>(S, fext, N);
  } else {
    compute_forces<COUL, EWALD, PAT, LIST, SW>(P, T, S, h0, false, w);
  }
  for (int s = 0; s < n_run; ++s) {
    const Box h = deform ? h_at(h0, eps, (float)(g0 + s) / n_tot) : h0;
    nhc_half(S, mftm, N, dt, kt, A.ndof, A.tdamp);
    const float half = 0.5f * dt;
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      S.vx[i] += half * S.fx[i] * im;
      S.vy[i] += half * S.fy[i] * im;
      S.vz[i] += half * S.fz[i] * im;
      if constexpr (SHAKE) {  // positions before the drift: SHAKE's directions
        S.q[i] = S.px[i]; S.q[N + i] = S.py[i]; S.q[2 * N + i] = S.pz[i];
      }
      S.px[i] += dt * S.vx[i];
      S.py[i] += dt * S.vy[i];
      S.pz[i] += dt * S.vz[i];
      if constexpr (SHAKE) {  // drifted positions, for the velocity correction
        S.fx[i] = S.px[i]; S.fy[i] = S.py[i]; S.fz[i] = S.pz[i];
      }
    }
    __syncthreads();
    if constexpr (SHAKE) {
      if (dt > 0.f) shake(P, T, S, invm, 1.f / dt);
    }
    for (int k = 0; k < 6; ++k) w[k] = 0.f;
    compute_forces<COUL, EWALD, PAT, LIST, SW>(P, T, S, h, sample != 0, w);
    add_fext<FEXT>(S, fext, N);
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      S.vx[i] += half * S.fx[i] * im;
      S.vy[i] += half * S.fy[i] * im;
      S.vz[i] += half * S.fz[i] * im;
    }
    if constexpr (SHAKE) {
      __syncthreads();
      if (dt > 0.f) rattle(P, T, S, invm);
    }
    nhc_half(S, mftm, N, dt, kt, A.ndof, A.tdamp);
    if (sample) {
      float r[12];
      for (int k = 0; k < 6; ++k) r[6 + k] = w[k];
      for (int k = 0; k < 6; ++k) r[k] = 0.f;
      for (int i = tid; i < N; i += nt) {
        const float m = mftm[i];
        const float vx = S.vx[i], vy = S.vy[i], vz = S.vz[i];
        r[0] += m * vx * vx;
        r[1] += m * vy * vy;
        r[2] += m * vz * vz;
        r[3] += m * vx * vy;
        r[4] += m * vx * vz;
        r[5] += m * vy * vz;
      }
      block_sum<12>(r, S.red);
      const float conv = A.nktv2p / (h.lx * h.ly * h.lz);
      for (int k = 0; k < 6; ++k) pacc[k] += (r[k] + r[6 + k]) * conv;
    }
    if (deform) {
      const Box hn = h_at(h0, eps, (float)(g0 + s + 1) / n_tot);
      const float i00 = 1.f / h.lx, i11 = 1.f / h.ly, i22 = 1.f / h.lz;
      const float i01 = -h.xy / (h.lx * h.ly);
      const float i12 = -h.yz / (h.ly * h.lz);
      const float i02 = (h.xy * h.yz - h.xz * h.ly) / (h.lx * h.ly * h.lz);
      const float a00 = hn.lx * i00;
      const float a01 = hn.lx * i01 + hn.xy * i11;
      const float a02 = hn.lx * i02 + hn.xy * i12 + hn.xz * i22;
      const float a11 = hn.ly * i11;
      const float a12 = hn.ly * i12 + hn.yz * i22;
      const float a22 = hn.lz * i22;
      for (int i = tid; i < N; i += nt) {
        const float x = S.px[i], y = S.py[i], z = S.pz[i];
        S.px[i] = a00 * x + a01 * y + a02 * z;
        S.py[i] = a11 * y + a12 * z;
        S.pz[i] = a22 * z;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += nt) {
    st[i] = S.px[i]; st[N + i] = S.py[i]; st[2 * N + i] = S.pz[i];
    st[3 * N + i] = S.vx[i]; st[4 * N + i] = S.vy[i]; st[5 * N + i] = S.vz[i];
  }
  if (tid < NHC) A.vxi[job * NHC + tid] = S.misc[tid];
  if (tid < 6) A.press[job * 6 + tid] = pacc[tid];
}

template <bool COUL, bool EWALD, bool PAT, bool LIST, bool SW = false>
__global__ void __launch_bounds__(LIST ? 768 : (COUL ? 896 : 512))
md_forces_kernel(Params P, Topo3 T, const float* __restrict__ pos,
                 const float* __restrict__ h6, float* __restrict__ force,
                 float* __restrict__ virial) {
  extern __shared__ float sm[];
  const int job = blockIdx.x;
  const int N = P.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  Smem S = carve(sm, N);
  const float* p = pos + (size_t)job * 3 * N;
  for (int i = tid; i < N; i += nt) {
    S.px[i] = p[i]; S.py[i] = p[N + i]; S.pz[i] = p[2 * N + i];
  }
  const float* hb = h6 + job * 6;
  const Box h = {hb[0], hb[1], hb[2], hb[3], hb[4], hb[5]};
  __syncthreads();
  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  compute_forces<COUL, EWALD, PAT, LIST, SW>(P, T, S, h, true, w);
  float* f = force + (size_t)job * 3 * N;
  for (int i = tid; i < N; i += nt) {
    f[i] = S.fx[i]; f[N + i] = S.fy[i]; f[2 * N + i] = S.fz[i];
  }
  block_sum<6>(w, S.red);
  if (tid < 6) virial[job * 6 + tid] = w[tid];
}

// K1m: K1's run entry with J jobs per block, the TPU kernel's
// FusedSpec.jobs = J > 1 (scema_tpu/ops/md_fused.py:881-902, :1445-1590;
// entries run_strain_fused_multi :2415 and sample_stress_fused_multi
// :2450).  K1's flag set only (no Coulomb, patterns, SHAKE, fext, list or
// SW), as the TPU asserts.  Block b owns jobs b J .. b J + J - 1, each
// with its own shared-memory set of 21 N floats (86 KB at N = 512, J = 2;
// above 48 KB only with prepare()'s opt-in), its own NHC chain and
// broadcasts (MISC floats), block reductions, pressure sums and n_run;
// the reduction scratch is shared.  One trip loop runs to the longest
// job's count, and at each step the block takes the live jobs' step
// bodies in turn, each K1's own code (the same device functions in the
// same order), so every job's arithmetic is K1's and its result K1's bit
// for bit at the same block width.  A job past its count is skipped (its
// state frozen, no free-wheeling at dt = 0); a job with n_run = 0 is never
// loaded and is left bit-identical.  What bounds it: K1's pair loop, J
// times per block; the design changes how many blocks fill the card (at
// 576 jobs and 132 SMs: K1 4.36 waves of one job per block, K1m J = 2
// 2.18 waves of two) and shares nothing else — the redesign (md_k1m.cu)
// shares each step's barriers between the jobs and interleaves their pair
// loops.
constexpr int MISC = 16;  // per-job NHC chain + broadcasts (floats)

size_t smem_bytes(int N) {
  return sizeof(float) * (size_t)(21 * N + MAXW * NRED + MISC);
}

size_t smem_bytes_multi(int N, int J) {
  return sizeof(float) * ((size_t)J * (21 * N + MISC) + MAXW * NRED);
}

// Job j's views in a block of J shared-memory sets: 21 N floats each, then
// the shared reduction scratch, then J misc slots.
__device__ __forceinline__ Smem carve_job(float* sm, int N, int J, int j) {
  Smem s = carve(sm + (size_t)j * 21 * N, N);
  s.red = sm + (size_t)J * 21 * N;
  s.misc = s.red + MAXW * NRED + j * MISC;
  return s;
}

template <int J>
__global__ void __launch_bounds__(512) md_run_multi_kernel(Params P, Topo3 T, RunArgs A) {
  extern __shared__ float sm[];
  const int N = P.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* __restrict__ invm = A.invm;
  const float* __restrict__ mftm = A.mftm;
  const int deform = A.deform, sample = A.sample;
  int n_run[J];
  int n_max = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int job = blockIdx.x * J + j;
    n_run[j] = A.n_run[job];
    n_max = n_run[j] > n_max ? n_run[j] : n_max;
    if (n_run[j] <= 0) {
      if (tid < 6) A.press[job * 6 + tid] = 0.f;
      continue;
    }
    const Smem S = carve_job(sm, N, J, j);
    const float* st = A.state + (size_t)job * 6 * N;
    for (int i = tid; i < N; i += nt) {
      S.px[i] = st[i]; S.py[i] = st[N + i]; S.pz[i] = st[2 * N + i];
      S.vx[i] = st[3 * N + i]; S.vy[i] = st[4 * N + i]; S.vz[i] = st[5 * N + i];
    }
    if (tid < NHC) S.misc[tid] = A.vxi[job * NHC + tid];
  }
  if (n_max <= 0) return;
  __syncthreads();

  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float pacc[J][6];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    for (int k = 0; k < 6; ++k) pacc[j][k] = 0.f;
    if (n_run[j] <= 0) continue;
    const float* fs = A.fscal + (size_t)(blockIdx.x * J + j) * FSCAL;
    const Box h0 = {fs[F_H0], fs[F_H0 + 1], fs[F_H0 + 2], fs[F_H0 + 3], fs[F_H0 + 4],
                    fs[F_H0 + 5]};
    compute_forces<false, false, false, false, false>(P, T, carve_job(sm, N, J, j), h0, false,
                                                      w);
  }
  for (int s = 0; s < n_max; ++s) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (s >= n_run[j]) continue;  // block-uniform
      const Smem S = carve_job(sm, N, J, j);
      const float* fs = A.fscal + (size_t)(blockIdx.x * J + j) * FSCAL;
      const float dt = fs[F_DT];
      const float kt = A.boltz * fs[F_T];
      const Box h0 = {fs[F_H0], fs[F_H0 + 1], fs[F_H0 + 2], fs[F_H0 + 3], fs[F_H0 + 4],
                      fs[F_H0 + 5]};
      float eps[6];
      for (int k = 0; k < 6; ++k) eps[k] = fs[F_EPS + k];
      const float n_tot = (float)n_run[j];
      // K1's step body (md_run_kernel with every flag off)
      const Box h = deform ? h_at(h0, eps, (float)s / n_tot) : h0;
      nhc_half(S, mftm, N, dt, kt, A.ndof, A.tdamp);
      const float half = 0.5f * dt;
      for (int i = tid; i < N; i += nt) {
        const float im = invm[i];
        S.vx[i] += half * S.fx[i] * im;
        S.vy[i] += half * S.fy[i] * im;
        S.vz[i] += half * S.fz[i] * im;
        S.px[i] += dt * S.vx[i];
        S.py[i] += dt * S.vy[i];
        S.pz[i] += dt * S.vz[i];
      }
      __syncthreads();
      for (int k = 0; k < 6; ++k) w[k] = 0.f;
      compute_forces<false, false, false, false, false>(P, T, S, h, sample != 0, w);
      for (int i = tid; i < N; i += nt) {
        const float im = invm[i];
        S.vx[i] += half * S.fx[i] * im;
        S.vy[i] += half * S.fy[i] * im;
        S.vz[i] += half * S.fz[i] * im;
      }
      nhc_half(S, mftm, N, dt, kt, A.ndof, A.tdamp);
      if (sample) {
        float r[12];
        for (int k = 0; k < 6; ++k) r[6 + k] = w[k];
        for (int k = 0; k < 6; ++k) r[k] = 0.f;
        for (int i = tid; i < N; i += nt) {
          const float m = mftm[i];
          const float vx = S.vx[i], vy = S.vy[i], vz = S.vz[i];
          r[0] += m * vx * vx;
          r[1] += m * vy * vy;
          r[2] += m * vz * vz;
          r[3] += m * vx * vy;
          r[4] += m * vx * vz;
          r[5] += m * vy * vz;
        }
        block_sum<12>(r, S.red);
        const float conv = A.nktv2p / (h.lx * h.ly * h.lz);
        for (int k = 0; k < 6; ++k) pacc[j][k] += (r[k] + r[6 + k]) * conv;
      }
      if (deform) {
        const Box hn = h_at(h0, eps, (float)(s + 1) / n_tot);
        const float i00 = 1.f / h.lx, i11 = 1.f / h.ly, i22 = 1.f / h.lz;
        const float i01 = -h.xy / (h.lx * h.ly);
        const float i12 = -h.yz / (h.ly * h.lz);
        const float i02 = (h.xy * h.yz - h.xz * h.ly) / (h.lx * h.ly * h.lz);
        const float a00 = hn.lx * i00;
        const float a01 = hn.lx * i01 + hn.xy * i11;
        const float a02 = hn.lx * i02 + hn.xy * i12 + hn.xz * i22;
        const float a11 = hn.ly * i11;
        const float a12 = hn.ly * i12 + hn.yz * i22;
        const float a22 = hn.lz * i22;
        for (int i = tid; i < N; i += nt) {
          const float x = S.px[i], y = S.py[i], z = S.pz[i];
          S.px[i] = a00 * x + a01 * y + a02 * z;
          S.py[i] = a11 * y + a12 * z;
          S.pz[i] = a22 * z;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (n_run[j] <= 0) continue;
    const int job = blockIdx.x * J + j;
    const Smem S = carve_job(sm, N, J, j);
    float* st = A.state + (size_t)job * 6 * N;
    for (int i = tid; i < N; i += nt) {
      st[i] = S.px[i]; st[N + i] = S.py[i]; st[2 * N + i] = S.pz[i];
      st[3 * N + i] = S.vx[i]; st[4 * N + i] = S.vy[i]; st[5 * N + i] = S.vz[i];
    }
    if (tid < NHC) A.vxi[job * NHC + tid] = S.misc[tid];
    if (tid < 6) A.press[job * 6 + tid] = pacc[j][tid];
  }
}

// Threads per block: one per atom up to what the kernel's register count
// allows (a multiple of 32).
template <typename K>
cudaError_t prepare(K kernel, int N, size_t bytes, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int t = ((N + 31) / 32) * 32;
  const int cap = (attr.maxThreadsPerBlock / 32) * 32;
  *threads = t < 32 ? 32 : (t > cap ? cap : t);
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT, bool LIST, bool SW = false>
cudaError_t launch_run(const Params& P, const Topo3& T, const RunArgs& A, int B,
                       cudaStream_t stream) {
  auto kernel = md_run_kernel<COUL, EWALD, PAT, SHAKE, FEXT, LIST, SW>;
  const size_t bytes = smem_bytes(P.N);
  int threads = 0;
  cudaError_t err = prepare(kernel, P.N, bytes, &threads);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, bytes, stream>>>(P, T, A);
  return cudaGetLastError();
}

template <bool COUL, bool EWALD, bool PAT, bool LIST, bool SW = false>
cudaError_t launch_forces(const Params& P, const Topo3& T, const float* pos,
                          const float* h6, float* force, float* virial, int B,
                          cudaStream_t stream) {
  auto kernel = md_forces_kernel<COUL, EWALD, PAT, LIST, SW>;
  const size_t bytes = smem_bytes(P.N);
  int threads = 0;
  cudaError_t err = prepare(kernel, P.N, bytes, &threads);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, bytes, stream>>>(P, T, pos, h6, force, virial);
  return cudaGetLastError();
}

template <int J>
cudaError_t launch_run_multi(const Params& P, const Topo3& T, const RunArgs& A, int B,
                             cudaStream_t stream) {
  auto kernel = md_run_multi_kernel<J>;
  const size_t bytes = smem_bytes_multi(P.N, J);
  int threads = 0;
  cudaError_t err = prepare(kernel, P.N, bytes, &threads);
  if (err != cudaSuccess) return err;
  kernel<<<B / J, threads, bytes, stream>>>(P, T, A);
  return cudaGetLastError();
}

// The flag sets make_runner produces from the ported materials, each with
// the all-pairs (K1/K3) and the list (K4) pair loop; any other set is
// refused with cudaErrorInvalidValue (add its instance when a material
// that needs it is ported):
//   none                              K1: united-atom chain melts
//   COUL+PATTERNS(+SHAKE)             all-atom PE with cutoff Coulomb
//   COUL+EWALD+PATTERNS(+SHAKE)+FEXT  all-atom PE with the k-space split
// K5 (SW) is one more instance with every other flag off (run_entry).
template <bool LIST>
cudaError_t dispatch_run(const Params& P, const Topo3& T, const RunArgs& A, bool coul,
                         bool ewald, int B, cudaStream_t s) {
  const bool pat = T.n_pat > 0, shk = T.n_shk > 0, fext = A.fext != nullptr;
  if (!coul && !ewald && !pat && !shk && !fext)
    return launch_run<false, false, false, false, false, LIST>(P, T, A, B, s);
  if (!coul || !pat || ewald != fext) return cudaErrorInvalidValue;
  if (ewald)
    return shk ? launch_run<true, true, true, true, true, LIST>(P, T, A, B, s)
               : launch_run<true, true, true, false, true, LIST>(P, T, A, B, s);
  return shk ? launch_run<true, false, true, true, false, LIST>(P, T, A, B, s)
             : launch_run<true, false, true, false, false, LIST>(P, T, A, B, s);
}

template <bool LIST>
cudaError_t dispatch_forces(const Params& P, const Topo3& T, bool coul, bool ewald,
                            const float* pos, const float* h6, float* force, float* virial,
                            int B, cudaStream_t s) {
  const bool pat = T.n_pat > 0;
  if (!coul && !ewald && !pat)
    return launch_forces<false, false, false, LIST>(P, T, pos, h6, force, virial, B, s);
  if (!coul || !pat) return cudaErrorInvalidValue;
  return ewald ? launch_forces<true, true, true, LIST>(P, T, pos, h6, force, virial, B, s)
               : launch_forces<true, false, true, LIST>(P, T, pos, h6, force, virial, B, s);
}

// Every operand of a K1/K3/K4/K5 launch; mirrored field for field by
// ops/md_fused.py's ctypes structure _MDArgs.  The flags coul and ewald,
// the pattern and SHAKE counts in topo3 and a non-null fext select the
// instantiation; the exported entry (md_allpairs_*, md_list_* or md_sw_*)
// selects the pair loop, or K5's sweeps.
struct MDArgs {
  const float *lj1, *lj2, *topo, *qq, *pat, *shk, *invm, *mftm;
  float *state, *vxi, *press;
  const int *n_run, *gstep0, *n_tot;
  const float *fscal, *fext, *pos, *h6;
  float *force, *virial;
  const int* nidx;
  const float *nlj1, *nlj2, *nqq, *nimx, *nimy, *nimz;
  int B, N, K, deform, sample, coul, ewald;
  float cutoff2, r2min, coul_cutoff2, alpha, ndof, boltz, nktv2p, tdamp;
  Topo3 topo3;
  SWC sw;
};

template <bool LIST, bool SW = false>
bool args_ok(const MDArgs* a) {
  // SHAKE keeps 3 + n_shk rows of N floats in the 12 N role buffer
  if (a->topo3.n_pat > MAXPAT || a->topo3.n_shk > MAXSHK) return false;
  if constexpr (SW) {  // K5 has no planes, Coulomb, patterns, SHAKE or fext
    return a->sw.rc > 0.f && !a->coul && !a->ewald && a->topo3.n_pat == 0 &&
           a->topo3.n_shk == 0 && !a->fext;
  } else if constexpr (LIST) {
    return a->K > 0 && a->nidx && a->nlj1 && a->nlj2 && a->nimx && a->nimy && a->nimz &&
           (!a->coul || a->nqq);
  } else {
    return a->lj1 && a->lj2 && (!a->coul || a->qq);
  }
}

Params params_of(const MDArgs* a) {
  return Params{a->lj1, a->lj2, a->topo, a->N, a->cutoff2, a->r2min, a->qq, a->pat, a->shk,
                a->coul_cutoff2, a->alpha, a->nidx, a->nlj1, a->nlj2, a->nqq, a->nimx,
                a->nimy, a->nimz, a->K, a->sw};
}

// SW: K5's one instance (no other flag); otherwise the flag sets above
template <bool LIST, bool SW = false>
int run_entry(const MDArgs* a, void* stream) {
  if (!args_ok<LIST, SW>(a)) return (int)cudaErrorInvalidValue;
  RunArgs A{a->invm, a->mftm, a->state, a->vxi, a->press, a->n_run, a->gstep0, a->n_tot,
            a->fscal, a->fext, a->deform, a->sample, a->ndof, a->boltz, a->nktv2p, a->tdamp};
  if (LIST && (!a->gstep0 || !a->n_tot)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (SW)
    return static_cast<int>(launch_run<false, false, false, false, false, false, true>(
        params_of(a), a->topo3, A, a->B, s));
  else
    return static_cast<int>(dispatch_run<LIST>(params_of(a), a->topo3, A, a->coul != 0,
                                               a->ewald != 0, a->B, s));
}

template <bool LIST, bool SW = false>
int forces_entry(const MDArgs* a, void* stream) {
  if (!args_ok<LIST, SW>(a)) return (int)cudaErrorInvalidValue;
  if constexpr (SW)
    return static_cast<int>(launch_forces<false, false, false, false, true>(
        params_of(a), a->topo3, a->pos, a->h6, a->force, a->virial, a->B,
        static_cast<cudaStream_t>(stream)));
  else
    return static_cast<int>(dispatch_forces<LIST>(params_of(a), a->topo3, a->coul != 0,
                                                a->ewald != 0, a->pos, a->h6, a->force,
                                                a->virial, a->B,
                                                static_cast<cudaStream_t>(stream)));
}

}  // namespace
