// K3 and K4, redesigned for Hopper: whole NVT + fix-deform or NVT +
// virial-sampling runs of many charged all-atom boxes (the k-space split,
// offset-pattern bonded terms, SHAKE/RATTLE), one thread block per job, and
// the force + virial entry over (tile of rows, box) blocks.  One body,
// templated on LIST: the all-pairs pair loop (K3, md_k3.cu) or the compact
// neighbor-list pair loop (K4, md_k4.cu), and K4's form for boxes above
// one block's shared memory (md_k4_big.cu, below).  ops/md_fused.py
// (md_run and md_forces_virial) sends every runner whose kernel is "K3" or
// "K4" here.
//
// Replaces the charged branches of the TPU kernel
// scema_tpu/ops/md_fused.py::_make_kernel (launched by fused_chunk, :1850):
// the all-pairs Coulomb additions (_ewald_fcoul :260, erfc_poly :249, fext
// :1253, bonded_pattern_forces :674, shake_rolls :523, rattle_rolls :557)
// and, with LIST, the gather-list branch (forces -> pair_tile :1269-1300,
// gather3 :855) and its HBM-streamed job-grid form (_build_streamed_grid_call
// :1603, :1678).  Per job it keeps the semantics of the first design
// (md_kernel.cuh with the COUL/EWALD/PATTERNS/SHAKE/FEXT/LIST flags, still
// built in md_allpairs.cu and md_list.cu for the A/B timings and the
// checks): whole runs in one launch, a job with n_run = 0 left
// bit-identical, fext with per-job step offsets (gstep0, n_tot), the
// sequential triclinic minimum image (K3) or the image integers fixed at the
// list build (K4), deterministic sums, no atomics.
//
// What bounds them.  K4: the list's bytes.  The first design streamed seven
// 4-byte channels per slot (index, lj1, lj2, qq and three float image
// integers), re-read on every step: 70 MB per job-step at N = 2240, K =
// 1112, ~2 TB/s.  K3: issuing the pair loop (N^2 pairs per step, a fifth of
// them inside the 9 A Coulomb cutoff with the erfc form) and reading three
// N x N coefficient planes through L2 for every live pair.
//
// Design (each step was timed as an instance of its own on the card;
// PERF.md keeps those times):
// * One 32-bit word per K4 list slot, slot-major (B, K, N) so that a warp's
//   reads coalesce over i: bits 0-15 the neighbor j, 16-27 the three image
//   integers (4 bits each, -8..7), 28-29 the special-bond order (0 none, 1-3
//   for 1-2, 1-3, 1-4).  The host pack drops the slots whose LJ and Coulomb
//   weights are both 0, keeps the rest in the list's distance order and
//   self-pads the tail; a (B, N) count of live slots lets each row stop at
//   its own count (a warp at its lanes' largest).
// * No coefficient planes: lj1/lj2 from a (T, T) type table and qq from
//   per-atom charges (sqrt(qqr2e) q_i), both in shared memory.  K4 multiplies
//   by the special weights of the slot's order; K3 reads a window of offsets
//   |j - i| <= W of the topology's special partners in the atom's code: an
//   excluded pair (both weights 0) is skipped inside the loop, never
//   subtracted afterwards (an excluded 1-2 pair's LJ force would cancel
//   catastrophically in float32), a pair with other weights reads them from
//   a (N, 2W + 1) array.
// * Positions and type codes share one float4 per atom in shared memory
//   (one 16-byte read per pair).  Shared memory per job is 23 N floats + the
//   table (206 KB at N = 2240).
// * K3: two rows per thread in one pair loop, so that each j (a shared
//   broadcast) serves both.  K4: one row per thread, its next 8 slot words
//   loaded before their pairs are taken (8 list loads in flight per warp:
//   the loop waits on device memory's latency, not its bandwidth).
// * Block widths pinned with __launch_bounds__ (K3_THREADS, K4_THREADS):
//   896 threads at 72 registers and 768 at 80 fill the SM with one job's
//   block (unpinned, ptxas took 107 registers and the block 512 threads,
//   1.5x slower); ptxas spills 0-48 bytes per thread at these widths.
//   The run kernels' local memory (K3 112 bytes, K4 80) is outside the
//   pair loops (cuobjdump -sass): the bonded pattern pass's role arrays,
//   indexed at run time, the per-step virial sums and, in K3, the few
//   per-step values that the pin at 72 registers spills.
// * The force entry fills the card: a (tiles, B) grid, 32 rows of one box
//   per block, 16 warps that each take a slice of the j range (K3) or of the
//   tile's live slot range (K4); the slices' partial forces are summed in
//   slice order; the bonded terms cover the tile's rows plus a halo of the
//   anchors whose roles reach them (recomputed per tile, never read from
//   another block), and each block writes a partial virial to a (B, tiles,
//   6) scratch that a second small kernel sums in tile order.
//
// K4's forms for boxes above one block's shared memory (md_k4_big.cu; the
// JAX list path streams its channels from HBM and has no ceiling,
// scema_tpu/md/material.py:442-470).  The shared form keeps 23 N floats
// per job (2509 atoms at most).  The path's cluster form runs one job on a
// thread-block cluster of C CTAs: each CTA keeps the whole job's float4 of
// position and code, the charges and the type table (what the pair loop
// reads for every pair), and its own rows' velocities, forces and role/
// SHAKE buffer; positions reach the peers through distributed shared
// memory after each drift (design notes in md_k4_big.cu; up to ~9190
// atoms with one type at 16 CTAs per job).  The global form (V_GLOBAL,
// here) keeps the float4, forces and charges of one job in one block and
// its velocities and the 12 N role/SHAKE buffer in a (B, 15, N) per-job
// device scratch, the bonded pattern and SHAKE/RATTLE passes reading and
// writing it between their barriers; only the A/B timings reach it.  The
// force entry keeps 5 N floats and serves every form.
#pragma once
#include "md_kernel.cuh"

namespace {

// an atom's code (the w of its float4): bits 0-5 its type; K3 only: bits
// 6 + d set where partner j = i + d - W is excluded (d = W is the atom)
constexpr int C_TYPE = 0x3f, C_EXCL = 6, C_MAXW = 12;
// the force entry's tile: rows per block, and at most this many warps
constexpr int C_ROWS = 32, C_SLICES = 16;
// the chain terms' reach: anchors k - 3 .. k own the roles on atom k
constexpr int C_CHAIN = 3;
// the design's steps: stop at the row's count (K4), two rows per thread;
// K4: each row's next 8 slot words loaded ahead of their pairs, so that a
// warp keeps 8 list loads in flight; K4's global form (velocities and the
// role/SHAKE buffer in device memory)
constexpr int V_COUNT = 1, V_TWO = 2, V_AHEAD8 = 64, V_GLOBAL = 256;
// block widths of the path's run kernels: K3's 1792 atoms as 896 threads
// of two rows, K4's 2240 as 768 threads of two rows, then one
constexpr int K3_THREADS = 896, K4_THREADS = 768;
// the path's steps: K3 two rows per thread; K4 one row per thread that
// stops at its count, its next 8 slot words loaded ahead
constexpr int K3_PATH = V_TWO, K4_PATH = V_COUNT | V_AHEAD8, K4_BIG_PATH = K4_PATH | V_GLOBAL;
// the shared-memory budget of one Hopper block (opt-in), bytes
constexpr size_t C_MAX_SMEM = 232448;
// rows of N floats per job in the global form's scratch: vx, vy, vz, 12 N
constexpr int C_SCRATCH_ROWS = 15;

// Every operand of a K3/K4 launch; mirrored field for field by
// ops/md_fused.py's ctypes structure _K34Args.
struct CArgs {
  const float* tbl;    // (T, T, 2) lj1, lj2 of (type i, type j) (K4: (type j, type i))
  const float* q;      // (N,) sqrt(qqr2e) q_i (COUL)
  const int* code;     // (N,) atom codes
  const int* spec;     // (N,) K3: window offsets whose weights are read from win
  const float* win;    // (N, 2W + 1, 2) K3: (lj, coul) weights of the window
  const float* topo;   // (16, N) chain rows (without patterns)
  const float* pat;    // (R, N) pattern parameter rows
  const float* shk;    // (n_shk, N) SHAKE d0^2 rows
  const float *invm, *mftm;
  float *state, *vxi, *press;
  const int *n_run, *gstep0, *n_tot;
  const float *fscal, *fext, *pos, *h6;
  float *force, *virial, *partial;  // partial: (B, tiles, 6) virial scratch
  const unsigned* slot;             // (B, K, N) K4 list words
  const int* count;                 // (B, N) K4 live slots per row
  float* scratch;                   // (B, 15, N) K4's global form: vx, vy, vz, role buffer
  int B, N, T, K, W, deform, sample, tiles, coul, ewald, reach_lo, reach_hi;
  float cutoff2, r2min, coul_cutoff2, alpha, ndof, boltz, nktv2p, tdamp;
  float slj[4], sco[4];  // special weights by order (index 0 unused)
  Topo3 topo3;
};

// what the pair loops read
struct CPair {
  const float4* p4;   // shared: positions + codes
  const float2* tbl;  // shared: type table
  const float* qs;    // shared: scaled charges
  const int* spec;
  const float2* win;
  int T, W, nwin;
  float cutoff2, r2min, coul_cutoff2, alpha, rmax2;
  float s1l, s2l, s3l, s1c, s2c, s3c;
  Box h;
  float ilx, ily, ilz;
};

__device__ __forceinline__ CPair c_pair(const CArgs& A, const float4* p4, const float2* tbl,
                                        const float* qs, const Box& h) {
  CPair P;
  P.p4 = p4; P.tbl = tbl; P.qs = qs;
  P.spec = A.spec;
  P.win = reinterpret_cast<const float2*>(A.win);
  P.T = A.T; P.W = A.W; P.nwin = 2 * A.W + 1;
  P.cutoff2 = A.cutoff2; P.r2min = A.r2min;
  P.coul_cutoff2 = A.coul_cutoff2; P.alpha = A.alpha;
  P.rmax2 = A.coul && A.coul_cutoff2 > A.cutoff2 ? A.coul_cutoff2 : A.cutoff2;
  P.s1l = A.slj[1]; P.s2l = A.slj[2]; P.s3l = A.slj[3];
  P.s1c = A.sco[1]; P.s2c = A.sco[2]; P.s3c = A.sco[3];
  P.h = h;
  P.ilx = 1.f / h.lx; P.ily = 1.f / h.ly; P.ilz = 1.f / h.lz;
  return P;
}

// F/r of one pair at r2 (inside the larger cutoff) from its coefficients:
// md_kernel.cuh's pair_force arithmetic (1 / max(r2, r2min) without
// Coulomb; with it rsqrtf, shared with the erfc form), the divides as
// __frcp_rn (the IEEE divide's rounding)
template <bool COUL, bool EWALD>
__device__ __forceinline__ float c_fp(const CPair& P, float r2, float a1, float a2, float qq) {
  if constexpr (!COUL) {
    const float inv = __frcp_rn(fmaxf(r2, P.r2min));
    const float u2 = inv * inv;
    const float u3 = u2 * inv;
    return (a1 * u3 - a2) * u2 * u2;
  } else {
    const float r2c = fmaxf(r2, P.r2min);
    const float inv_r = rsqrtf(r2c);
    const float inv2 = inv_r * inv_r;
    float fp = 0.f;
    if (r2 < P.cutoff2) {
      const float u2 = inv2 * inv2;
      const float u3 = u2 * inv2;
      fp = (a1 * u3 - a2) * u2 * u2;
    }
    if (r2 < P.coul_cutoff2) {
      if constexpr (EWALD) {
        const float x = P.alpha * (r2c * inv_r);
        const float ex = expf(-x * x);
        const float t = __frcp_rn(1.f + 0.3275911f * x);
        const float erfc_x =
            t * ex * (0.254829592f + t * (-0.284496736f + t * (
                1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
        fp += qq * inv2 * (erfc_x * inv_r + EWALD_F * P.alpha * ex);
      } else {
        fp += qq * inv_r * inv2;
      }
    }
    return fp;
  }
}

template <bool WV>
__device__ __forceinline__ void c_apply(float fp, float dx, float dy, float dz, float f[3],
                                        float w[6]) {
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

// K3: pair forces on rows ii[r] (where ok[r]) from every j in [j0, j1) into
// f[r], and with WV half of each pair's virial into w.  Every j is read once
// for the NR rows.
template <bool COUL, bool EWALD, bool WV, int NR>
__device__ __forceinline__ void k3_rows(const CPair& P, const int (&ii)[NR], const bool (&ok)[NR],
                                        int j0, int j1, float (&f)[NR][3], float w[6]) {
  float xi[NR], yi[NR], zi[NR], qi[NR];
  int row[NR];
  unsigned excl[NR], spec[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = ok[r] ? ii[r] : 0;
    const float4 p = P.p4[i];
    const int c = __float_as_int(p.w);
    xi[r] = p.x; yi[r] = p.y; zi[r] = p.z;
    row[r] = (c & C_TYPE) * P.T;
    excl[r] = (unsigned)c >> C_EXCL;
    spec[r] = ok[r] ? (unsigned)__ldg(P.spec + i) : 0u;
    qi[r] = COUL ? P.qs[i] : 0.f;
  }
  for (int j = j0; j < j1; ++j) {
    const float4 pj = P.p4[j];
    const int tj = __float_as_int(pj.w) & C_TYPE;
    const float qj = COUL ? P.qs[j] : 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (NR > 1 && !ok[r]) continue;
      float dx = pj.x - xi[r], dy = pj.y - yi[r], dz = pj.z - zi[r];
      const float r2 = min_image_r2(P.h, P.ilx, P.ily, P.ilz, dx, dy, dz);
      if (!(r2 < P.rmax2)) continue;
      const unsigned d = (unsigned)(j - ii[r] + P.W);
      bool sp = false;
      if (d < (unsigned)P.nwin) {
        if ((excl[r] >> d) & 1u) continue;  // weight 0: skipped, never subtracted
        sp = (spec[r] >> d) & 1u;
      }
      const float2 c = P.tbl[row[r] + tj];
      float a1 = c.x, a2 = c.y, qq = qi[r] * qj;
      if (sp) {
        const float2 wt = __ldg(P.win + (size_t)ii[r] * P.nwin + d);
        a1 *= wt.x;
        a2 *= wt.x;
        qq *= wt.y;
      }
      c_apply<WV>(c_fp<COUL, EWALD>(P, r2, a1, a2, qq), dx, dy, dz, f[r], w);
    }
  }
}

// K4: pair forces on rows ii[r] from their list slots s0 .. cnt[r] - 1
// (slot: the job's (K, N) words) into f[r], and with WV half of each slot's
// virial into w (the list is full: every pair sits in both rows).  With U >
// 1 each row's next U words are loaded before their pairs are taken; a slot
// past the row's count reads as the row's own self-padded word (r2 = 0).
template <bool COUL, bool EWALD, bool WV, int NR, int U = 1>
__device__ __forceinline__ void k4_rows(const CPair& P, const unsigned* __restrict__ slot, int N,
                                        const int (&ii)[NR], const int (&cnt)[NR], int s0,
                                        float (&f)[NR][3], float w[6]) {
  float xi[NR], yi[NR], zi[NR], qi[NR];
  int ti[NR];
  unsigned self[NR];
  int smax = s0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = cnt[r] > s0 ? ii[r] : 0;
    const float4 p = P.p4[i];
    xi[r] = p.x; yi[r] = p.y; zi[r] = p.z;
    ti[r] = __float_as_int(p.w) & C_TYPE;
    qi[r] = COUL ? P.qs[i] : 0.f;
    self[r] = (unsigned)i;
    smax = cnt[r] > smax ? cnt[r] : smax;
  }
  const Box& h = P.h;
  for (int s = s0; s < smax; s += U) {
    unsigned wds[NR][U];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u)
        wds[r][u] = s + u < cnt[r] ? __ldg(slot + (size_t)(s + u) * N + ii[r]) : self[r];
#pragma unroll
    for (int k = 0; k < U * NR; ++k) {
      const int u = k / NR, r = k % NR;
      if (U == 1 && s >= cnt[r]) continue;
      const unsigned wd = wds[r][u];
      const int j = (int)(wd & 0xffffu);
      const float nx = (float)((int)(wd << 12) >> 28);
      const float ny = (float)((int)(wd << 8) >> 28);
      const float nz = (float)((int)(wd << 4) >> 28);
      const float4 pj = P.p4[j];
      const float dx = pj.x + nx * h.lx + ny * h.xy + nz * h.xz - xi[r];
      const float dy = pj.y + ny * h.ly + nz * h.yz - yi[r];
      const float dz = pj.z + nz * h.lz - zi[r];
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (!(r2 > P.r2min && r2 < P.rmax2)) continue;  // dead self-padded slots: r2 = 0
      const float2 c = P.tbl[(__float_as_int(pj.w) & C_TYPE) * P.T + ti[r]];
      float a1 = c.x, a2 = c.y, qq = COUL ? qi[r] * P.qs[j] : 0.f;
      const unsigned o = wd >> 28;
      if (o) {
        const float wl = o == 1u ? P.s1l : (o == 2u ? P.s2l : P.s3l);
        const float wc = o == 1u ? P.s1c : (o == 2u ? P.s2c : P.s3c);
        a1 *= wl;
        a2 *= wl;
        qq *= wc;
      }
      c_apply<WV>(c_fp<COUL, EWALD>(P, r2, a1, a2, qq), dx, dy, dz, f[r], w);
    }
  }
}

// one job's rows: positions + codes, the type table, velocities, forces,
// the 12 N role/SHAKE buffer, the charges, the reduction scratch and the
// NHC chain + broadcast — all in shared memory, or (the global form) the
// velocities and the role/SHAKE buffer in the job's device-memory scratch
struct CSmem {
  float4* p4;
  float2* tbl;
  float *vx, *vy, *vz, *fx, *fy, *fz, *q, *qs, *red, *misc;
};

__host__ __device__ __forceinline__ size_t c_run_smem(int N, int T, bool global) {
  return sizeof(float4) * (size_t)N + sizeof(float2) * (size_t)T * T +
         sizeof(float) * ((size_t)(global ? 4 : 19) * N + MAXW * NRED + NHC + 1);
}

template <bool GLOBAL>
__device__ __forceinline__ CSmem c_carve(float4* sm, int N, int T, float* scratch) {
  CSmem s;
  s.p4 = sm;
  s.tbl = reinterpret_cast<float2*>(sm + N);
  float* f = reinterpret_cast<float*>(s.tbl + T * T);
  if constexpr (GLOBAL) {
    s.vx = scratch; s.vy = s.vx + N; s.vz = s.vy + N;
    s.q = s.vz + N;
  } else {
    s.vx = f; s.vy = s.vx + N; s.vz = s.vy + N;
    f = s.vz + N;
  }
  s.fx = f; s.fy = s.fx + N; s.fz = s.fy + N;
  if constexpr (GLOBAL) {
    s.qs = s.fz + N;
  } else {
    s.q = s.fz + N;
    s.qs = s.q + 12 * N;
  }
  s.red = s.qs + N;
  s.misc = s.red + MAXW * NRED;
  return s;
}

// Pair + bonded forces of every atom at the positions in shared memory for
// box h (with WV this thread's virial partials into w): the pair loop over
// rows (two per thread with V_TWO), then the bonded terms — one pass per
// offset pattern (PAT) or the chain terms (K4 on a chain melt).  Entry and
// exit are block-synced.
template <bool LIST, bool COUL, bool EWALD, bool PAT, int V, bool WV>
__device__ void c_forces(const CArgs& A, const CSmem& S, const Box& h, float w[6]) {
  constexpr bool TWO = (V & V_TWO) != 0;
  constexpr int AHEAD = (V & V_AHEAD8) ? 8 : 1;
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x;
  const CPair P = c_pair(A, S.p4, S.tbl, S.qs, h);
  const unsigned* slot = LIST ? A.slot + (size_t)blockIdx.x * A.K * N : nullptr;
  const int* count = LIST ? A.count + (size_t)blockIdx.x * N : nullptr;
  if constexpr (TWO) {
    for (int i = tid; i < N; i += 2 * nt) {
      const int ii[2] = {i, i + nt};
      float f[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      const bool ok2 = i + nt < N;
      if constexpr (LIST) {
        const int c0 = (V & V_COUNT) ? __ldg(count + i) : A.K;
        const int c1 = ok2 ? ((V & V_COUNT) ? __ldg(count + i + nt) : A.K) : 0;
        const int cnt[2] = {c0, c1};
        k4_rows<COUL, EWALD, WV, 2, AHEAD>(P, slot, N, ii, cnt, 0, f, w);
      } else {
        const bool ok[2] = {true, ok2};
        k3_rows<COUL, EWALD, WV, 2>(P, ii, ok, 0, N, f, w);
      }
      S.fx[i] = f[0][0]; S.fy[i] = f[0][1]; S.fz[i] = f[0][2];
      if (ok2) {
        S.fx[i + nt] = f[1][0]; S.fy[i + nt] = f[1][1]; S.fz[i + nt] = f[1][2];
      }
    }
  } else {
    for (int i = tid; i < N; i += nt) {
      const int ii[1] = {i};
      float f[1][3] = {{0.f, 0.f, 0.f}};
      if constexpr (LIST) {
        const int cnt[1] = {(V & V_COUNT) ? __ldg(count + i) : A.K};
        k4_rows<COUL, EWALD, WV, 1, AHEAD>(P, slot, N, ii, cnt, 0, f, w);
      } else {
        const bool ok[1] = {true};
        k3_rows<COUL, EWALD, WV, 1>(P, ii, ok, 0, N, f, w);
      }
      S.fx[i] = f[0][0]; S.fy[i] = f[0][1]; S.fz[i] = f[0][2];
    }
  }
  const Topo3& T = A.topo3;
  if constexpr (PAT) {
    // one pass per pattern: every anchor writes its roles, then every atom
    // gathers the roles that land on it; the virial is sum_i f_i (x) r_i
    // over the pattern forces (bonded_pattern_forces)
    __syncthreads();
    for (int p = 0; p < T.n_pat; ++p) {
      for (int a = tid; a < N; a += nt) pattern_term(A.pat, N, T, F4Pos{S.p4}, S.q, N, p, a, a);
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
        if constexpr (WV) {
          const float4 pi = S.p4[i];
          const float r[3] = {pi.x, pi.y, pi.z};
          add_outer(w, g, r);
        }
      }
      __syncthreads();
    }
  } else {
    for (int k = tid; k < N; k += nt) k1_bonded<WV>(A.topo, N, S.p4, S.q, N, k, k, w);
    __syncthreads();
    for (int i = tid; i < N; i += nt) {
      float g[3];
      k1_gather(S.q, N, i, i, g);
      S.fx[i] += g[0];
      S.fy[i] += g[1];
      S.fz[i] += g[2];
    }
    __syncthreads();
  }
}

template <bool LIST, bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT, int V>
__device__ __forceinline__ void c_run(const CArgs& A) {
  extern __shared__ float4 c_sm[];
  const int job = blockIdx.x;
  const int N = A.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_run = A.n_run[job];
  if (n_run <= 0) {
    if (tid < 6) A.press[job * 6 + tid] = 0.f;
    return;
  }
  const float* __restrict__ invm = A.invm;
  const float* __restrict__ mftm = A.mftm;
  const CSmem S = c_carve<(V & V_GLOBAL) != 0>(
      c_sm, N, A.T, (V & V_GLOBAL) ? A.scratch + (size_t)job * C_SCRATCH_ROWS * N : nullptr);
  Smem M;  // md_kernel.cuh's view for nhc_half, shake and rattle
  M.px = M.py = M.pz = nullptr;
  M.vx = S.vx; M.vy = S.vy; M.vz = S.vz;
  M.fx = S.fx; M.fy = S.fy; M.fz = S.fz;
  M.q = S.q; M.red = S.red; M.misc = S.misc;
  const F4Pos X{S.p4};
  float* st = A.state + (size_t)job * 6 * N;
  for (int i = tid; i < N; i += nt) {
    S.p4[i] = make_float4(st[i], st[N + i], st[2 * N + i], __int_as_float(A.code[i]));
    S.vx[i] = st[3 * N + i]; S.vy[i] = st[4 * N + i]; S.vz[i] = st[5 * N + i];
    S.qs[i] = COUL ? A.q[i] : 0.f;
  }
  for (int t = tid; t < A.T * A.T; t += nt) S.tbl[t] = make_float2(A.tbl[2 * t], A.tbl[2 * t + 1]);
  if (tid < NHC) S.misc[tid] = A.vxi[job * NHC + tid];
  const float* fs = A.fscal + (size_t)job * FSCAL;
  const float dt = fs[F_DT];
  const float kt = A.boltz * fs[F_T];
  const Box h0 = {fs[F_H0], fs[F_H0 + 1], fs[F_H0 + 2], fs[F_H0 + 3], fs[F_H0 + 4], fs[F_H0 + 5]};
  float eps[6];
  for (int k = 0; k < 6; ++k) eps[k] = fs[F_EPS + k];
  // per-job step offsets of a chunked run (the k-space and list periods)
  const int g0 = A.gstep0[job];
  const float n_tot = (float)A.n_tot[job];
  const float* fext = FEXT ? A.fext + (size_t)job * 3 * N : nullptr;
  const int deform = A.deform, sample = A.sample;
  __syncthreads();

  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float pacc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // chunk-start forces at the chunk's own box, with this chunk's fext
  c_forces<LIST, COUL, EWALD, PAT, V, false>(
      A, S, deform ? h_at(h0, eps, (float)g0 / n_tot) : h0, w);
  add_fext<FEXT>(M, fext, N);
  for (int s = 0; s < n_run; ++s) {
    const Box h = deform ? h_at(h0, eps, (float)(g0 + s) / n_tot) : h0;
    nhc_half(M, mftm, N, dt, kt, A.ndof, A.tdamp);
    const float half = 0.5f * dt;
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      S.vx[i] += half * S.fx[i] * im;
      S.vy[i] += half * S.fy[i] * im;
      S.vz[i] += half * S.fz[i] * im;
      float4 p = S.p4[i];
      if constexpr (SHAKE) {  // positions before the drift: SHAKE's directions
        S.q[i] = p.x; S.q[N + i] = p.y; S.q[2 * N + i] = p.z;
      }
      p.x += dt * S.vx[i];
      p.y += dt * S.vy[i];
      p.z += dt * S.vz[i];
      S.p4[i] = p;
      if constexpr (SHAKE) {  // drifted positions, for the velocity correction
        S.fx[i] = p.x; S.fy[i] = p.y; S.fz[i] = p.z;
      }
    }
    __syncthreads();
    if constexpr (SHAKE) {
      if (dt > 0.f) shake(A.shk, N, A.topo3, X, M, invm, 1.f / dt);
    }
    for (int k = 0; k < 6; ++k) w[k] = 0.f;
    if (sample)
      c_forces<LIST, COUL, EWALD, PAT, V, true>(A, S, h, w);
    else
      c_forces<LIST, COUL, EWALD, PAT, V, false>(A, S, h, w);
    add_fext<FEXT>(M, fext, N);
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      S.vx[i] += half * S.fx[i] * im;
      S.vy[i] += half * S.fy[i] * im;
      S.vz[i] += half * S.fz[i] * im;
    }
    if constexpr (SHAKE) {
      __syncthreads();
      if (dt > 0.f) rattle(A.shk, N, A.topo3, X, M, invm);
    }
    nhc_half(M, mftm, N, dt, kt, A.ndof, A.tdamp);
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
        float4 p = S.p4[i];
        const float x = p.x, y = p.y, z = p.z;
        p.x = a00 * x + a01 * y + a02 * z;
        p.y = a11 * y + a12 * z;
        p.z = a22 * z;
        S.p4[i] = p;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += nt) {
    const float4 p = S.p4[i];
    st[i] = p.x; st[N + i] = p.y; st[2 * N + i] = p.z;
    st[3 * N + i] = S.vx[i]; st[4 * N + i] = S.vy[i]; st[5 * N + i] = S.vz[i];
  }
  if (tid < NHC) A.vxi[job * NHC + tid] = S.misc[tid];
  if (tid < 6) A.press[job * 6 + tid] = pacc[tid];
}

// the run kernel pinned to LB threads per block (one block per SM: the
// shared memory of one job)
template <bool LIST, bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT, int V, int LB>
__global__ void __launch_bounds__(LB, 1) k34_run_kernel(CArgs A) {
  c_run<LIST, COUL, EWALD, PAT, SHAKE, FEXT, V>(A);
}

__host__ __device__ __forceinline__ int c_slices(bool list, int N) {
  const int s = (N + 31) / 32;
  return list || s > C_SLICES ? C_SLICES : s;
}

// anchors per tile: the rows and the halo whose bonded roles reach them
__host__ __device__ __forceinline__ int c_anchors(bool pat, int reach_lo, int reach_hi) {
  return C_ROWS + (pat ? reach_lo + reach_hi : C_CHAIN);
}

__host__ __device__ __forceinline__ size_t c_forces_smem(int N, int T, int ns, int qa) {
  return sizeof(float4) * (size_t)N + sizeof(float2) * (size_t)T * T +
         sizeof(float) * ((size_t)N + (size_t)ns * C_ROWS * 3 + 12 * qa + MAXW * NRED);
}

// Force + virial entry: block (tile, box) computes rows [32 tile, 32 tile +
// 32) of box `box` — warp s sums the pairs of its slice (K3: of the j range;
// K4: of the tile's live slot range), the slices' partials are added in
// slice order, then the bonded roles of the tile's anchors and halo — and
// writes its partial virial (the pair halves of its rows and the bonded
// terms of its rows) to partial[box][tile].
template <bool LIST, bool COUL, bool EWALD, bool PAT>
__global__ void __launch_bounds__(512, 2) k34_forces_kernel(CArgs A) {
  extern __shared__ float4 c_sm[];
  const int N = A.N, T = A.T;
  const int tile = blockIdx.x, box = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ns = nt >> 5, lane = tid & 31, slice = tid >> 5;
  const int start = tile * C_ROWS;
  const int end = start + C_ROWS < N ? start + C_ROWS : N;
  const int lo = PAT ? A.reach_lo : C_CHAIN, hi = PAT ? A.reach_hi : 0;
  const int abeg = start - lo > 0 ? start - lo : 0;
  const int aend = end + hi < N ? end + hi : N;
  const int qa = c_anchors(PAT, A.reach_lo, A.reach_hi);
  float4* p4 = c_sm;
  float2* tbl = reinterpret_cast<float2*>(p4 + N);
  float* qs = reinterpret_cast<float*>(tbl + T * T);
  float* part = qs + N;
  float* q = part + ns * C_ROWS * 3;
  float* red = q + 12 * qa;
  const float* p = A.pos + (size_t)box * 3 * N;
  for (int i = tid; i < N; i += nt) {
    p4[i] = make_float4(p[i], p[N + i], p[2 * N + i], __int_as_float(A.code[i]));
    qs[i] = COUL ? A.q[i] : 0.f;
  }
  for (int t = tid; t < T * T; t += nt) tbl[t] = make_float2(A.tbl[2 * t], A.tbl[2 * t + 1]);
  const float* hb = A.h6 + box * 6;
  const Box h = {hb[0], hb[1], hb[2], hb[3], hb[4], hb[5]};
  __syncthreads();
  const CPair P = c_pair(A, p4, tbl, qs, h);
  float f[1][3] = {{0.f, 0.f, 0.f}};
  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int i = start + lane;
  const int ii[1] = {i};
  if constexpr (LIST) {
    const int c = i < end ? __ldg(A.count + (size_t)box * N + i) : 0;
    const int cmax = __reduce_max_sync(0xffffffffu, c);
    const int len = (cmax + ns - 1) / ns;
    const int s0 = slice * len;
    const int s1 = s0 + len < c ? s0 + len : c;
    const int cnt[1] = {s1};
    k4_rows<COUL, EWALD, true, 1>(P, A.slot + (size_t)box * A.K * N, N, ii, cnt, s0, f, w);
  } else {
    const int jlen = (N + ns - 1) / ns;
    const int j0 = slice * jlen;
    const int j1 = j0 + jlen < N ? j0 + jlen : N;
    const bool ok[1] = {true};
    if (i < end) k3_rows<COUL, EWALD, true, 1>(P, ii, ok, j0, j1, f, w);
  }
  for (int a = 0; a < 3; ++a) part[(slice * C_ROWS + lane) * 3 + a] = f[0][a];
  float g[3] = {0.f, 0.f, 0.f};
  const Topo3& T3 = A.topo3;
  const int r = start + tid;  // the row this thread gathers (tid < end - start)
  if constexpr (PAT) {
    for (int pp = 0; pp < T3.n_pat; ++pp) {
      for (int t = tid; t < aend - abeg; t += nt)
        pattern_term(A.pat, N, T3, F4Pos{p4}, q, qa, pp, abeg + t, t);
      __syncthreads();
      if (tid < end - start) {
        const int nrole = T3.kind[pp] == PAT_BOND ? 2 : (T3.kind[pp] == PAT_ANGLE ? 3 : 4);
        for (int c = 0; c < 3; ++c) g[c] += q[c * qa + r - abeg];
        for (int k = 1; k < nrole; ++k) {
          const int a = r - T3.off[pp][k - 1];
          if (a >= 0 && a < N)
            for (int c = 0; c < 3; ++c) g[c] += q[(k * 3 + c) * qa + a - abeg];
        }
      }
      __syncthreads();
    }
    if (tid < end - start) {
      const float4 pr = p4[r];
      const float rr[3] = {pr.x, pr.y, pr.z};
      add_outer(w, g, rr);
    }
  } else {
    for (int t = tid; t < end - abeg; t += nt) {
      const int k = abeg + t;
      float wb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      k1_bonded<true>(A.topo, N, p4, q, qa, k, t, wb);
      if (k >= start)  // a halo anchor's virial is its own tile's
        for (int c = 0; c < 6; ++c) w[c] += wb[c];
    }
    __syncthreads();
    if (tid < end - start) k1_gather(q, qa, r, r - abeg, g);
  }
  __syncthreads();
  if (tid < end - start) {
    float* fo = A.force + (size_t)box * 3 * N;
    for (int a = 0; a < 3; ++a) {
      float acc = part[tid * 3 + a];
      for (int s = 1; s < ns; ++s) acc += part[(s * C_ROWS + tid) * 3 + a];
      fo[a * N + r] = acc + g[a];
    }
  }
  block_sum<6>(w, red);
  if (tid < 6) A.partial[((size_t)box * A.tiles + tile) * 6 + tid] = w[tid];
}

// virial[box][c] = the tiles' partials of box summed in tile order
__global__ void k34_virial_kernel(const float* __restrict__ partial, int tiles, int n,
                                  float* __restrict__ virial) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // box * 6 + c
  if (t >= n) return;
  const float* pt = partial + (size_t)(t / 6) * tiles * 6 + t % 6;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += pt[k * 6];
  virial[t] = s;
}

template <class K>
cudaError_t c_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool c_args_ok(const CArgs& A, bool list) {
  if (A.N <= 0 || A.B < 0 || A.T < 1 || A.T > C_TYPE + 1 || !A.tbl || !A.code) return false;
  if (A.coul && !A.q) return false;
  if (A.topo3.n_pat > MAXPAT || A.topo3.n_shk > MAXSHK) return false;
  if (A.topo3.n_pat > 0 ? !A.pat : !A.topo) return false;
  if (A.topo3.n_shk > 0 && !A.shk) return false;
  if (list) return A.N <= 65536 && A.K > 0 && A.slot && A.count;
  return A.W >= 0 && A.W <= C_MAXW && A.spec && A.win;
}

// the block width of a run kernel: one thread per row, or per two rows
// with V_TWO, up to the kernel's limit (a multiple of 32)
template <class K>
cudaError_t c_threads(K kernel, int N, bool two, size_t bytes, int* threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int rows = two ? (N + 1) / 2 : N;
  const int t = ((rows + 31) / 32) * 32;
  const int cap = (attr.maxThreadsPerBlock / 32) * 32;
  *threads = t < 32 ? 32 : (t > cap ? cap : t);
  return c_opt_in(kernel, bytes);
}

template <bool LIST, bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT, int V, int LB>
cudaError_t c_launch_run(const CArgs& A, cudaStream_t s) {
  auto kernel = k34_run_kernel<LIST, COUL, EWALD, PAT, SHAKE, FEXT, V, LB>;
  const size_t bytes = c_run_smem(A.N, A.T, (V & V_GLOBAL) != 0);
  int threads = 0;
  cudaError_t err = c_threads(kernel, A.N, (V & V_TWO) != 0, bytes, &threads);
  if (err != cudaSuccess || A.B == 0) return err;
  kernel<<<A.B, threads, bytes, s>>>(A);
  return cudaGetLastError();
}

// a run's operands (every form's)
bool c_run_ptrs_ok(const CArgs& A, bool list) {
  return c_args_ok(A, list) && A.invm && A.mftm && A.state && A.vxi && A.press && A.n_run &&
         A.fscal && A.gstep0 && A.n_tot;
}

// a run's operands, and its form's shared memory within one block's (the
// global form needs its scratch)
bool c_run_args_ok(const CArgs& A, bool list, bool global) {
  if (c_run_smem(A.N, A.T, global) > C_MAX_SMEM || (global && !A.scratch)) return false;
  return c_run_ptrs_ok(A, list);
}

// The flag sets make_runner produces for K3 and K4 (any other is refused
// with cudaErrorInvalidValue):
//   none                              K4 only: a united-atom chain melt
//   COUL+PATTERNS(+SHAKE)             all-atom PE with cutoff Coulomb
//   COUL+EWALD+PATTERNS(+SHAKE)+FEXT  all-atom PE with the k-space split
template <bool LIST, int V, int LB>
cudaError_t c_dispatch_run(const CArgs& A, cudaStream_t s) {
  if (!c_run_args_ok(A, LIST, (V & V_GLOBAL) != 0)) return cudaErrorInvalidValue;
  const bool pat = A.topo3.n_pat > 0, shk = A.topo3.n_shk > 0, fext = A.fext != nullptr;
  if (!A.coul && !A.ewald && !pat && !shk && !fext) {
    if constexpr (LIST) return c_launch_run<true, false, false, false, false, false, V, LB>(A, s);
    return cudaErrorInvalidValue;
  }
  if (!A.coul || !pat || (A.ewald != 0) != fext) return cudaErrorInvalidValue;
  if (A.ewald)
    return shk ? c_launch_run<LIST, true, true, true, true, true, V, LB>(A, s)
               : c_launch_run<LIST, true, true, true, false, true, V, LB>(A, s);
  return shk ? c_launch_run<LIST, true, false, true, true, false, V, LB>(A, s)
             : c_launch_run<LIST, true, false, true, false, false, V, LB>(A, s);
}

template <bool LIST, bool COUL, bool EWALD, bool PAT>
cudaError_t c_launch_forces(const CArgs& A, cudaStream_t s) {
  const int tiles = (A.N + C_ROWS - 1) / C_ROWS;
  if (A.tiles != tiles || !A.pos || !A.h6 || !A.force || !A.virial || !A.partial)
    return cudaErrorInvalidValue;
  auto kernel = k34_forces_kernel<LIST, COUL, EWALD, PAT>;
  const int ns = c_slices(LIST, A.N);
  const size_t bytes =
      c_forces_smem(A.N, A.T, ns, c_anchors(PAT, A.reach_lo, A.reach_hi));
  if (bytes > C_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = c_opt_in(kernel, bytes);
  if (err != cudaSuccess || A.B == 0) return err;
  kernel<<<dim3(tiles, A.B), 32 * ns, bytes, s>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 6 * A.B;
  k34_virial_kernel<<<(n + 127) / 128, 128, 0, s>>>(A.partial, tiles, n, A.virial);
  return cudaGetLastError();
}

template <bool LIST>
cudaError_t c_dispatch_forces(const CArgs& A, cudaStream_t s) {
  if (!c_args_ok(A, LIST)) return cudaErrorInvalidValue;
  const bool pat = A.topo3.n_pat > 0;
  if (pat && (A.reach_lo < 0 || A.reach_hi < 0 || A.reach_lo >= 32 || A.reach_hi >= 32))
    return cudaErrorInvalidValue;
  if (!A.coul && !A.ewald && !pat) {
    if constexpr (LIST) return c_launch_forces<true, false, false, false>(A, s);
    return cudaErrorInvalidValue;
  }
  if (!A.coul || !pat) return cudaErrorInvalidValue;
  return A.ewald ? c_launch_forces<LIST, true, true, true>(A, s)
                 : c_launch_forces<LIST, true, false, true>(A, s);
}

// registers, local (spill) bytes per thread, resident blocks per SM and
// block width of one kernel at N atoms of T types
template <class K>
cudaError_t c_kernel_info(K kernel, int threads, size_t bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = c_opt_in(kernel, bytes);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = threads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, bytes);
}

// out[4] of a run kernel (its charged slices' flag set) at N atoms of T types
template <class K>
cudaError_t c_run_info(K kernel, int N, int T, bool two, bool global, int* out) {
  const size_t bytes = c_run_smem(N, T, global);
  int threads = 0;
  cudaError_t err = c_threads(kernel, N, two, bytes, &threads);
  if (err != cudaSuccess) return err;
  return c_kernel_info(kernel, threads, bytes, out);
}

// out[4] of the force kernel of that flag set (halo as on all-atom PE)
template <bool LIST>
cudaError_t c_forces_info(int N, int T, int* out) {
  const int ns = c_slices(LIST, N);
  return c_kernel_info(k34_forces_kernel<LIST, true, true, true>, 32 * ns,
                       c_forces_smem(N, T, ns, c_anchors(true, 31, 31)), out);
}

}  // namespace
