// K4's run for list boxes above one block's shared memory (md_charged.cuh
// keeps 23 N floats per job in one block: 2509 atoms at most), exported for
// ops/md_fused.py, which sends a K4 run here when its box exceeds the
// shared form's cap.  Two forms:
//
// * the cluster form (the path's): one job on a thread-block cluster of C
//   CTAs, its rows in the CTAs' shared memory (design below);
// * the global form (md_charged.cuh's V_GLOBAL: one block per job, the
//   velocities and the role/SHAKE buffer in a per-job device scratch),
//   kept only for the A/B timings (md_fused.k4_global_run).
//
// Replaces, with md_k4.cu, the gather-list branch of the TPU kernel
// scema_tpu/ops/md_fused.py::_make_kernel (pair_tile :1269-1300) in its
// HBM-streamed job-grid form (_build_streamed_grid_call :1603, :1678),
// which streamed the list in K-chunks and had no ceiling on the box
// (scema_tpu/md/material.py:442-470).  A source of its own, so that nvcc
// builds its instances beside md_k4.cu's.
//
// What bounds the global form on the card: one block per job, so a slice
// of 32 jobs keeps 32 of the 132 SMs busy, and every bonded-pattern pass
// and each of the 30 SHAKE/RATTLE sweeps per step goes to L2 and back.
//
// The cluster form.  Job b is cluster b of C CTAs (cudaLaunchKernelEx with
// a cluster dimension; C a power of two up to CL_MAX, chosen by the host
// from the jobs, the box and its type count, md_fused.k4_cluster_size).
// CTA r owns the rows [cut[r], cut[r + 1]), which the host sets at even
// splits moved to where no SHAKE constraint crosses (PEAA4096's cuts fall
// between chains).
// * Each CTA keeps the whole job's float4 of position and code, the charges
//   and the type table (20 N bytes + the table), so the pair loop reads
//   only its own shared memory, as the shared form's does; and its own
//   rows' velocities, forces and the 12-row role/SHAKE buffer over its rows
//   and a halo of CL_HALO rows on each side.  Nothing of a job lives in
//   device memory between passes.
// * Positions: after the drift and SHAKE each CTA writes its rows' float4s
//   into every peer's copy through distributed shared memory, then the
//   cluster syncs; the deform remap is one affine map, applied by every CTA
//   to its whole copy.
// * The bonded terms of a CTA's rows come from the anchors of its rows and
//   the halo whose roles reach them, recomputed from its own copy of the
//   positions (as the force entry's tiles do): no exchange.
// * SHAKE/RATTLE: Jacobi sweeps over the CTA's own anchors.  Where a
//   constraint crosses a cut (cross = 1: no clean cut near the even split)
//   each sweep reads the partner's position or velocity and the peer's
//   factors through distributed shared memory, with a cluster sync per
//   pass; elsewhere the sweeps stay inside the CTA (block syncs).
// * The NHC kinetic energy and the sampled kinetic and virial sums: each CTA
//   reduces its rows (block_sum), pushes its partials into every peer's
//   slot, the cluster syncs, and every CTA adds the C partials in rank
//   order — no atomics, the same bits on every CTA and from run to run;
//   every CTA advances its own copy of the chain with those sums.
// * Each row's arithmetic is the shared form's (the pair sum in slot
//   order, the A&S erfc, the bonded terms); only the reductions' order
//   differs.  A job with n_run = 0 returns before any cluster sync.
#include <cooperative_groups.h>

#include "md_charged.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL_MAX = 16;      // CTAs per job at most (above 8: non-portable cluster sizes)
constexpr int CL_HALO = 32;     // halo rows on each side (pattern reach < 32, SHAKE offsets < 8)
constexpr int CL_THREADS = 1024;  // one row per thread up to 1024 rows per CTA
constexpr int CL_AHEAD = 8;       // list words in flight per row, as the shared form's

// a cluster-form launch: K4's operands, C CTAs per job and their row cuts;
// mirrored by ops/md_fused.py's ctypes structure _K4ClArgs
struct ClArgs {
  CArgs a;
  int C;      // CTAs per job (a power of two, <= CL_MAX)
  int rmax;   // the most rows one CTA owns (the length of its row arrays)
  int cross;  // 1 where a SHAKE constraint crosses a cut
  int cut[CL_MAX + 1];  // CTA r owns rows [cut[r], cut[r + 1])
};

// one CTA's shared memory; the same carve on every CTA of a cluster, so a
// pointer maps to the same array of a peer (map_shared_rank)
struct ClSmem {
  float4* p4;   // (N) the whole job's positions + codes
  float2* tbl;  // (T, T) the type table
  float* qs;    // (N) scaled charges
  float *vx, *vy, *vz, *fx, *fy, *fz;  // (rmax) own rows, index i - lo
  float* q;     // 12 x qa: role forces / SHAKE scratch over rows lo - CL_HALO ..
  float* red;   // MAXW x NRED block reduction
  float* cred;  // 2 x CL_MAX x NRED: the cluster's partials, two buffers
  float* misc;  // NHC chain + broadcast
  int qa;
};

// which CTA of the job and which rows
struct ClCtx {
  int rank, C, job, lo, hi;
  bool cross;
};

__host__ __device__ __forceinline__ int cl_qa(int rmax) { return rmax + 2 * CL_HALO; }

__host__ __device__ __forceinline__ size_t cl_smem(int N, int T, int rmax) {
  return sizeof(float4) * (size_t)N + sizeof(float2) * (size_t)T * T +
         sizeof(float) * ((size_t)N + 6 * (size_t)rmax + 12 * (size_t)cl_qa(rmax) +
                          MAXW * NRED + 2 * CL_MAX * NRED + NHC + 1);
}

__device__ __forceinline__ ClSmem cl_carve(float4* sm, int N, int T, int rmax) {
  ClSmem s;
  s.p4 = sm;
  s.tbl = reinterpret_cast<float2*>(sm + N);
  s.qs = reinterpret_cast<float*>(s.tbl + T * T);
  s.vx = s.qs + N; s.vy = s.vx + rmax; s.vz = s.vy + rmax;
  s.fx = s.vz + rmax; s.fy = s.fx + rmax; s.fz = s.fy + rmax;
  s.qa = cl_qa(rmax);
  s.q = s.fz + rmax;
  s.red = s.q + 12 * s.qa;
  s.cred = s.red + MAXW * NRED;
  s.misc = s.cred + 2 * CL_MAX * NRED;
  return s;
}

// the CTA that owns row i
__device__ __forceinline__ int cl_owner(const ClArgs& K, int i) {
  int r = 0;
  while (r + 1 < K.C && K.cut[r + 1] <= i) ++r;
  return r;
}

// a pass boundary: the whole cluster where peers read this CTA's rows
__device__ __forceinline__ void cl_barrier(bool cluster) {
  if (cluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Sum KV values over the cluster; every thread of every CTA receives the
// same totals: the block's sum (block_sum), pushed into slot `rank` of
// every CTA's buffer `par`, added in rank order after the cluster sync.  A
// buffer is written again two sums later, after every CTA passed the sync
// between, so its reads are done.
template <int KV>
__device__ __forceinline__ void cl_sum(float (&v)[KV], const ClSmem& S, const ClCtx& X,
                                       int& par) {
  block_sum<KV>(v, S.red);
  float* buf = S.cred + par * CL_MAX * NRED;
  cg::cluster_group cl = cg::this_cluster();
  if ((int)threadIdx.x < X.C) {
    float* dst = cl.map_shared_rank(buf, threadIdx.x) + X.rank * NRED;
#pragma unroll
    for (int k = 0; k < KV; ++k) dst[k] = v[k];
  }
  cl.sync();
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    float s = 0.f;
    for (int r = 0; r < X.C; ++r) s += buf[r * NRED + k];
    v[k] = s;
  }
  par ^= 1;
}

// the half-step NHC chain (md_kernel.cuh nhc_half) over the cluster: the
// kinetic energy summed by cl_sum, every CTA's chain advanced alike
__device__ void cl_nhc_half(const ClSmem& S, const ClCtx& X, const float* __restrict__ mftm,
                            float dt, float kt, float ndof, float tdamp, int& par) {
  const int tid = threadIdx.x, nt = blockDim.x, R = X.hi - X.lo;
  float ke[1] = {0.f};
  for (int r = tid; r < R; r += nt)
    ke[0] += mftm[X.lo + r] * (S.vx[r] * S.vx[r] + S.vy[r] * S.vy[r] + S.vz[r] * S.vz[r]);
  cl_sum<1>(ke, S, X, par);
  if (tid == 0) S.misc[NHC] = nhc_chain(S.misc, ke[0], dt, kt, ndof, tdamp);
  __syncthreads();
  const float scale = S.misc[NHC];
  for (int r = tid; r < R; r += nt) {
    S.vx[r] *= scale;
    S.vy[r] *= scale;
    S.vz[r] *= scale;
  }
}

// Pair + bonded forces of the CTA's rows (c_forces' arithmetic) at the
// positions of its copy, with WV its virial partials into w: the pair loop
// one row per thread, then one pass per offset pattern over the anchors of
// its rows and halo (or the chain terms, anchors k - 3 .. k), each halo
// anchor's virial left to its own CTA.  Entry and exit are block-synced.
template <bool COUL, bool EWALD, bool PAT, bool WV>
__device__ void cl_forces(const CArgs& A, const ClSmem& S, const ClCtx& X, const Box& h,
                          float w[6]) {
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x, lo = X.lo, hi = X.hi, qa = S.qa;
  const CPair P = c_pair(A, S.p4, S.tbl, S.qs, h);
  const unsigned* slot = A.slot + (size_t)X.job * A.K * N;
  const int* count = A.count + (size_t)X.job * N;
  for (int i = lo + tid; i < hi; i += nt) {
    const int ii[1] = {i};
    const int cnt[1] = {__ldg(count + i)};
    float f[1][3] = {{0.f, 0.f, 0.f}};
    k4_rows<COUL, EWALD, WV, 1, CL_AHEAD>(P, slot, N, ii, cnt, 0, f, w);
    S.fx[i - lo] = f[0][0];
    S.fy[i - lo] = f[0][1];
    S.fz[i - lo] = f[0][2];
  }
  const Topo3& T = A.topo3;
  __syncthreads();
  if constexpr (PAT) {
    const int abeg = lo - A.reach_lo > 0 ? lo - A.reach_lo : 0;
    const int aend = hi + A.reach_hi < N ? hi + A.reach_hi : N;
    for (int p = 0; p < T.n_pat; ++p) {
      for (int a = abeg + tid; a < aend; a += nt)
        pattern_term(A.pat, N, T, F4Pos{S.p4}, S.q, qa, p, a, a - abeg);
      __syncthreads();
      const int nrole = T.kind[p] == PAT_BOND ? 2 : (T.kind[p] == PAT_ANGLE ? 3 : 4);
      for (int i = lo + tid; i < hi; i += nt) {
        const int t = i - abeg;
        float g[3] = {S.q[t], S.q[qa + t], S.q[2 * qa + t]};
        for (int k = 1; k < nrole; ++k) {
          const int a = i - T.off[p][k - 1];
          if (a >= 0 && a < N)
            for (int c = 0; c < 3; ++c) g[c] += S.q[(k * 3 + c) * qa + a - abeg];
        }
        S.fx[i - lo] += g[0];
        S.fy[i - lo] += g[1];
        S.fz[i - lo] += g[2];
        if constexpr (WV) {
          const float4 pi = S.p4[i];
          const float r[3] = {pi.x, pi.y, pi.z};
          add_outer(w, g, r);
        }
      }
      __syncthreads();
    }
  } else {
    const int abeg = lo - C_CHAIN > 0 ? lo - C_CHAIN : 0;
    for (int t = tid; t < hi - abeg; t += nt) {
      float wb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      k1_bonded<WV>(A.topo, N, S.p4, S.q, qa, abeg + t, t, wb);
      if (WV && abeg + t >= lo)  // a halo anchor's virial is its own CTA's
        for (int c = 0; c < 6; ++c) w[c] += wb[c];
    }
    __syncthreads();
    for (int i = lo + tid; i < hi; i += nt) {
      float g[3];
      k1_gather(S.q, qa, i, i - abeg, g);
      S.fx[i - lo] += g[0];
      S.fy[i - lo] += g[1];
      S.fz[i - lo] += g[2];
    }
    __syncthreads();
  }
}

template <bool FEXT>
__device__ __forceinline__ void cl_add_fext(const ClSmem& S, const float* __restrict__ fx,
                                            int N, const ClCtx& X) {
  if constexpr (FEXT) {
    for (int i = X.lo + threadIdx.x; i < X.hi; i += blockDim.x) {
      S.fx[i - X.lo] += fx[i];
      S.fy[i - X.lo] += fx[N + i];
      S.fz[i - X.lo] += fx[2 * N + i];
    }
  }
}

// Jacobi SHAKE (md_kernel.cuh shake) over the CTA's anchors: reference
// directions from the pre-drift positions of its rows and halo (q rows 0-2,
// index i - lo + CL_HALO), the factors of its anchors in q + 3 qa; S.f
// holds its rows' drifted positions meanwhile.  With X.cross a partner's
// position and a peer anchor's factor come from the owning CTA.  Entry and
// exit are block-synced.
__device__ void cl_shake(const ClArgs& K, const ClSmem& S, const ClCtx& X,
                         const float* __restrict__ invm, float inv_dt) {
  const CArgs& A = K.a;
  const Topo3& T = A.topo3;
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x, lo = X.lo, hi = X.hi;
  const int qa = S.qa, rm = K.rmax, base = lo - CL_HALO;
  const float *ox = S.q, *oy = S.q + qa, *oz = S.q + 2 * qa;
  float* G = S.q + 3 * qa;
  cg::cluster_group cl = cg::this_cluster();
  if (X.cross) cl.sync();  // every CTA's rows drifted before a peer reads them
  for (int it = 0; it < T.shake_iters; ++it) {
    for (int a = lo + tid; a < hi; a += nt) {
      const float4 pa = S.p4[a];
      for (int k = 0; k < T.n_shk; ++k) {
        const int j = a + T.shk_off[k];
        const float d0sq = j < N ? A.shk[(size_t)k * N + a] : 0.f;
        float g = 0.f;
        if (d0sq > 0.f) {
          const float4 pj = j < hi ? S.p4[j] : cl.map_shared_rank(S.p4, cl_owner(K, j))[j];
          const float rx = pj.x - pa.x, ry = pj.y - pa.y, rz = pj.z - pa.z;
          const float qx = ox[j - base] - ox[a - base], qy = oy[j - base] - oy[a - base];
          const float qz = oz[j - base] - oz[a - base];
          const float diff = rx * rx + ry * ry + rz * rz - d0sq;
          const float denom = 2.f * (rx * qx + ry * qy + rz * qz) * (invm[a] + invm[j]) + 1e-30f;
          g = T.relax * diff / denom;
        }
        G[k * rm + a - lo] = g;
      }
    }
    cl_barrier(X.cross);
    for (int i = lo + tid; i < hi; i += nt) {
      const float im = invm[i];
      float d[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < T.n_shk; ++k) {
        const int o = T.shk_off[k];
        const int j = i + o, a = i - o;  // i as anchor (partner j); i as partner of a
        float c[3] = {0.f, 0.f, 0.f}, cb[3] = {0.f, 0.f, 0.f};
        if (j < N && (j < hi || X.cross)) {  // a clean cut's far side: g = 0
          const float g = G[k * rm + i - lo];
          c[0] = g * (ox[j - base] - ox[i - base]);
          c[1] = g * (oy[j - base] - oy[i - base]);
          c[2] = g * (oz[j - base] - oz[i - base]);
        }
        if (a >= 0 && (a >= lo || X.cross)) {  // a clean cut's far side: g = 0
          float g;
          if (a >= lo) {
            g = G[k * rm + a - lo];
          } else {
            const int r = cl_owner(K, a);
            g = cl.map_shared_rank(G, r)[k * rm + a - K.cut[r]];
          }
          cb[0] = g * (ox[i - base] - ox[a - base]);
          cb[1] = g * (oy[i - base] - oy[a - base]);
          cb[2] = g * (oz[i - base] - oz[a - base]);
        }
        for (int e = 0; e < 3; ++e) d[e] += c[e] * im - cb[e] * im;
      }
      float4 p = S.p4[i];
      p.x += d[0];
      p.y += d[1];
      p.z += d[2];
      S.p4[i] = p;
    }
    cl_barrier(X.cross);
  }
  for (int i = lo + tid; i < hi; i += nt) {
    const float4 p = S.p4[i];
    S.vx[i - lo] += (p.x - S.fx[i - lo]) * inv_dt;
    S.vy[i - lo] += (p.y - S.fy[i - lo]) * inv_dt;
    S.vz[i - lo] += (p.z - S.fz[i - lo]) * inv_dt;
  }
  __syncthreads();
}

// Jacobi RATTLE (md_kernel.cuh rattle) over the CTA's anchors, positions
// from its copy (whole since the exchange), the factors in q; with X.cross
// a partner's velocity and a peer anchor's factor come from the owning CTA.
// Entry and exit are block-synced.
__device__ void cl_rattle(const ClArgs& K, const ClSmem& S, const ClCtx& X,
                          const float* __restrict__ invm) {
  const CArgs& A = K.a;
  const Topo3& T = A.topo3;
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x, lo = X.lo, hi = X.hi, rm = K.rmax;
  float* G = S.q;
  cg::cluster_group cl = cg::this_cluster();
  if (X.cross) cl.sync();  // every CTA's velocities kicked before a peer reads them
  for (int it = 0; it < T.rattle_iters; ++it) {
    for (int a = lo + tid; a < hi; a += nt) {
      const float4 pa = S.p4[a];
      const float vax = S.vx[a - lo], vay = S.vy[a - lo], vaz = S.vz[a - lo];
      for (int k = 0; k < T.n_shk; ++k) {
        const int j = a + T.shk_off[k];
        const float d0sq = j < N ? A.shk[(size_t)k * N + a] : 0.f;
        float g = 0.f;
        if (d0sq > 0.f) {
          const float4 pj = S.p4[j];
          const float rx = pj.x - pa.x, ry = pj.y - pa.y, rz = pj.z - pa.z;
          const float r2 = rx * rx + ry * ry + rz * rz;
          float vjx, vjy, vjz;
          if (j < hi) {
            vjx = S.vx[j - lo]; vjy = S.vy[j - lo]; vjz = S.vz[j - lo];
          } else {
            const int r = cl_owner(K, j), o = j - K.cut[r];
            vjx = cl.map_shared_rank(S.vx, r)[o];
            vjy = cl.map_shared_rank(S.vy, r)[o];
            vjz = cl.map_shared_rank(S.vz, r)[o];
          }
          const float dvx = vjx - vax, dvy = vjy - vay, dvz = vjz - vaz;
          g = T.relax * (dvx * rx + dvy * ry + dvz * rz) / (r2 * (invm[a] + invm[j]) + 1e-30f);
        }
        G[k * rm + a - lo] = g;
      }
    }
    cl_barrier(X.cross);
    for (int i = lo + tid; i < hi; i += nt) {
      const float im = invm[i];
      const float4 pi = S.p4[i];
      float d[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < T.n_shk; ++k) {
        const int o = T.shk_off[k];
        const int j = i + o, a = i - o;
        float c[3] = {0.f, 0.f, 0.f}, cb[3] = {0.f, 0.f, 0.f};
        if (j < N && (j < hi || X.cross)) {
          const float g = G[k * rm + i - lo];
          const float4 pj = S.p4[j];
          c[0] = g * (pj.x - pi.x); c[1] = g * (pj.y - pi.y); c[2] = g * (pj.z - pi.z);
        }
        if (a >= 0 && (a >= lo || X.cross)) {
          float g;
          if (a >= lo) {
            g = G[k * rm + a - lo];
          } else {
            const int r = cl_owner(K, a);
            g = cl.map_shared_rank(G, r)[k * rm + a - K.cut[r]];
          }
          const float4 pa = S.p4[a];
          cb[0] = g * (pi.x - pa.x); cb[1] = g * (pi.y - pa.y); cb[2] = g * (pi.z - pa.z);
        }
        for (int e = 0; e < 3; ++e) d[e] += c[e] * im - cb[e] * im;
      }
      S.vx[i - lo] += d[0];
      S.vy[i - lo] += d[1];
      S.vz[i - lo] += d[2];
    }
    cl_barrier(X.cross);
  }
}

// one job's whole run on its cluster (c_run's steps, per CTA its rows)
template <bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT>
__device__ __forceinline__ void cl_run(const ClArgs& K) {
  extern __shared__ float4 cl_sm[];
  const CArgs& A = K.a;
  cg::cluster_group cl = cg::this_cluster();
  ClCtx X;
  X.C = K.C;
  X.rank = (int)cl.block_rank();
  X.job = blockIdx.x / K.C;
  X.lo = K.cut[X.rank];
  X.hi = K.cut[X.rank + 1];
  X.cross = K.cross != 0;
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x, lo = X.lo, R = X.hi - X.lo;
  const int job = X.job;
  const int n_run = A.n_run[job];
  if (n_run <= 0) {  // the whole cluster leaves, before any cluster sync
    if (X.rank == 0 && tid < 6) A.press[job * 6 + tid] = 0.f;
    return;
  }
  const float* __restrict__ invm = A.invm;
  const float* __restrict__ mftm = A.mftm;
  const ClSmem S = cl_carve(cl_sm, N, A.T, K.rmax);
  const int qa = S.qa;
  float* st = A.state + (size_t)job * 6 * N;
  for (int i = tid; i < N; i += nt) {
    S.p4[i] = make_float4(st[i], st[N + i], st[2 * N + i], __int_as_float(A.code[i]));
    S.qs[i] = COUL ? A.q[i] : 0.f;
  }
  for (int r = tid; r < R; r += nt) {
    S.vx[r] = st[3 * N + lo + r];
    S.vy[r] = st[4 * N + lo + r];
    S.vz[r] = st[5 * N + lo + r];
  }
  for (int t = tid; t < A.T * A.T; t += nt) S.tbl[t] = make_float2(A.tbl[2 * t], A.tbl[2 * t + 1]);
  if (tid < NHC) S.misc[tid] = A.vxi[job * NHC + tid];
  const float* fs = A.fscal + (size_t)job * FSCAL;
  const float dt = fs[F_DT];
  const float kt = A.boltz * fs[F_T];
  const Box h0 = {fs[F_H0], fs[F_H0 + 1], fs[F_H0 + 2], fs[F_H0 + 3], fs[F_H0 + 4], fs[F_H0 + 5]};
  float eps[6];
  for (int k = 0; k < 6; ++k) eps[k] = fs[F_EPS + k];
  const int g0 = A.gstep0[job];
  const float n_tot = (float)A.n_tot[job];
  const float* fext = FEXT ? A.fext + (size_t)job * 3 * N : nullptr;
  const int deform = A.deform, sample = A.sample;
  cl.sync();  // every CTA of the job has started (and loaded) before peers touch its memory

  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float pacc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int par = 0;
  cl_forces<COUL, EWALD, PAT, false>(A, S, X, deform ? h_at(h0, eps, (float)g0 / n_tot) : h0,
                                        w);
  cl_add_fext<FEXT>(S, fext, N, X);
  for (int s = 0; s < n_run; ++s) {
    const Box h = deform ? h_at(h0, eps, (float)(g0 + s) / n_tot) : h0;
    cl_nhc_half(S, X, mftm, dt, kt, A.ndof, A.tdamp, par);
    const float half = 0.5f * dt;
    if constexpr (SHAKE) {  // positions before the drift: SHAKE's directions, of the
      // CTA's rows and, where constraints cross a cut, its halo (which no
      // peer writes before the cluster syncs in cl_shake)
      const int b0 = X.cross && lo > CL_HALO ? lo - CL_HALO : (X.cross ? 0 : lo);
      const int b1 = X.cross ? (X.hi + CL_HALO < N ? X.hi + CL_HALO : N) : X.hi;
      for (int i = b0 + tid; i < b1; i += nt) {
        const float4 p = S.p4[i];
        const int t = i - lo + CL_HALO;
        S.q[t] = p.x; S.q[qa + t] = p.y; S.q[2 * qa + t] = p.z;
      }
      __syncthreads();
    }
    for (int r = tid; r < R; r += nt) {
      const int i = lo + r;
      const float im = invm[i];
      S.vx[r] += half * S.fx[r] * im;
      S.vy[r] += half * S.fy[r] * im;
      S.vz[r] += half * S.fz[r] * im;
      float4 p = S.p4[i];
      p.x += dt * S.vx[r];
      p.y += dt * S.vy[r];
      p.z += dt * S.vz[r];
      S.p4[i] = p;
      if constexpr (SHAKE) {  // drifted positions, for the velocity correction
        S.fx[r] = p.x; S.fy[r] = p.y; S.fz[r] = p.z;
      }
    }
    __syncthreads();
    if constexpr (SHAKE) {
      if (dt > 0.f) cl_shake(K, S, X, invm, 1.f / dt);
    }
    // the CTA's rows into every peer's copy
    for (int r = 1; r < X.C; ++r) {
      float4* dst = cl.map_shared_rank(S.p4, (X.rank + r) % X.C);
      for (int i = lo + tid; i < X.hi; i += nt) dst[i] = S.p4[i];
    }
    cl.sync();
    for (int k = 0; k < 6; ++k) w[k] = 0.f;
    if (sample)
      cl_forces<COUL, EWALD, PAT, true>(A, S, X, h, w);
    else
      cl_forces<COUL, EWALD, PAT, false>(A, S, X, h, w);
    cl_add_fext<FEXT>(S, fext, N, X);
    for (int r = tid; r < R; r += nt) {
      const float im = invm[lo + r];
      S.vx[r] += half * S.fx[r] * im;
      S.vy[r] += half * S.fy[r] * im;
      S.vz[r] += half * S.fz[r] * im;
    }
    if constexpr (SHAKE) {
      __syncthreads();
      if (dt > 0.f) cl_rattle(K, S, X, invm);
    }
    cl_nhc_half(S, X, mftm, dt, kt, A.ndof, A.tdamp, par);
    if (sample) {
      float r12[12];
      for (int k = 0; k < 6; ++k) r12[6 + k] = w[k];
      for (int k = 0; k < 6; ++k) r12[k] = 0.f;
      for (int r = tid; r < R; r += nt) {
        const float m = mftm[lo + r];
        const float vx = S.vx[r], vy = S.vy[r], vz = S.vz[r];
        r12[0] += m * vx * vx;
        r12[1] += m * vy * vy;
        r12[2] += m * vz * vz;
        r12[3] += m * vx * vy;
        r12[4] += m * vx * vz;
        r12[5] += m * vy * vz;
      }
      cl_sum<12>(r12, S, X, par);
      const float conv = A.nktv2p / (h.lx * h.ly * h.lz);
      for (int k = 0; k < 6; ++k) pacc[k] += (r12[k] + r12[6 + k]) * conv;
    }
    if (deform) {  // the whole copy: the same affine map on every CTA
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
  for (int r = tid; r < R; r += nt) {
    const float4 p = S.p4[lo + r];
    st[lo + r] = p.x; st[N + lo + r] = p.y; st[2 * N + lo + r] = p.z;
    st[3 * N + lo + r] = S.vx[r]; st[4 * N + lo + r] = S.vy[r]; st[5 * N + lo + r] = S.vz[r];
  }
  if (X.rank == 0) {
    if (tid < NHC) A.vxi[job * NHC + tid] = S.misc[tid];
    if (tid < 6) A.press[job * 6 + tid] = pacc[tid];
  }
  cl.sync();  // no CTA leaves while a peer may still touch its shared memory
}

// one CTA per SM (its shared memory), one row per thread up to CL_THREADS
template <bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT>
__global__ void __launch_bounds__(CL_THREADS, 1) k4_cluster_run_kernel(ClArgs K) {
  cl_run<COUL, EWALD, PAT, SHAKE, FEXT>(K);
}

// the launch configuration of a cluster-form kernel at rmax rows per CTA
// and C CTAs per job over `blocks` blocks, and how many such clusters the
// card holds at once (cudaOccupancyMaxActiveClusters)
template <class Kern>
cudaError_t cl_config(Kern kernel, int N, int T, int rmax, int C, int blocks, cudaStream_t s,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* at, int* active) {
  const size_t bytes = cl_smem(N, T, rmax);
  if (bytes > C_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = c_opt_in(kernel, bytes);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int t = ((rmax + 31) / 32) * 32;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks, 1, 1);
  cfg->blockDim = dim3(t < CL_THREADS ? t : CL_THREADS, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = s;
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = C;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg->attrs = at;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, kernel, cfg);
}

template <bool COUL, bool EWALD, bool PAT, bool SHAKE, bool FEXT>
cudaError_t cl_launch(const ClArgs& K, cudaStream_t s) {
  auto kernel = k4_cluster_run_kernel<COUL, EWALD, PAT, SHAKE, FEXT>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at;
  int active = 0;
  const int B = K.a.B > 0 ? K.a.B : 1;
  cudaError_t err = cl_config(kernel, K.a.N, K.a.T, K.rmax, K.C, B * K.C, s, &cfg, &at, &active);
  if (err != cudaSuccess) return err;
  // a cluster the card cannot hold is refused: no other form runs the job
  if (active < 1) return cudaErrorLaunchOutOfResources;
  if (K.a.B == 0) return cudaSuccess;
  err = cudaLaunchKernelEx(&cfg, kernel, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the cuts and the halo the kernel assumes, and its run operands
bool cl_args_ok(const ClArgs& K) {
  const CArgs& A = K.a;
  if (K.C < 1 || K.C > CL_MAX || (K.C & (K.C - 1)))
    return false;
  if (K.cut[0] != 0 || K.cut[K.C] != A.N) return false;
  int rmax = 0;
  for (int r = 0; r < K.C; ++r) {
    const int n = K.cut[r + 1] - K.cut[r];
    if (n < 1) return false;
    rmax = n > rmax ? n : rmax;
  }
  if (rmax != K.rmax || cl_smem(A.N, A.T, rmax) > C_MAX_SMEM) return false;
  for (int k = 0; k < A.topo3.n_shk; ++k)
    if (A.topo3.shk_off[k] < 1 || A.topo3.shk_off[k] >= CL_HALO) return false;
  if (A.topo3.n_pat > 0 && (A.reach_lo < 0 || A.reach_hi < 0 || A.reach_lo >= CL_HALO ||
                            A.reach_hi >= CL_HALO))
    return false;
  return c_run_ptrs_ok(A, true);
}

// the flag sets of c_dispatch_run (md_charged.cuh); any other is refused
cudaError_t cl_dispatch(const ClArgs& K, cudaStream_t s) {
  if (!cl_args_ok(K)) return cudaErrorInvalidValue;
  const CArgs& A = K.a;
  const bool pat = A.topo3.n_pat > 0, shk = A.topo3.n_shk > 0, fext = A.fext != nullptr;
  if (!A.coul && !A.ewald && !pat && !shk && !fext)
    return cl_launch<false, false, false, false, false>(K, s);
  if (!A.coul || !pat || (A.ewald != 0) != fext) return cudaErrorInvalidValue;
  if (A.ewald)
    return shk ? cl_launch<true, true, true, true, true>(K, s)
               : cl_launch<true, true, true, false, true>(K, s);
  return shk ? cl_launch<true, false, true, true, false>(K, s)
             : cl_launch<true, false, true, false, false>(K, s);
}

}  // namespace

// the argument structures have internal linkage: the entries take them untyped
extern "C" int md_k4_cluster_run_f32(const void* k, void* stream) {
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cl_dispatch(*static_cast<const ClArgs*>(k), static_cast<cudaStream_t>(stream));
}

// out[5] = (registers, local bytes per thread, clusters the card holds at
// once, threads per CTA, shared bytes per CTA) of the cluster form's run
// kernel (the charged slices' flag set) at N atoms of T types, rmax rows
// per CTA and C CTAs per job
extern "C" int md_k4_cluster_info(int N, int T, int rmax, int C, int* out) {
  if (out == nullptr || N <= 0 || T < 1 || rmax < 1 || C < 1 || C > CL_MAX)
    return (int)cudaErrorInvalidValue;
  auto kernel = k4_cluster_run_kernel<true, true, true, true, true>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at;
  int active = 0;
  err = cl_config(kernel, N, T, rmax, C, C, 0, &cfg, &at, &active);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = active;
  out[3] = (int)cfg.blockDim.x;
  out[4] = (int)cfg.dynamicSmemBytes;
  return 0;
}

// the global form (the A/B partner): CArgs and the stream
extern "C" int md_k4_big_run_f32(const void* a, void* stream) {
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)c_dispatch_run<true, K4_BIG_PATH, K4_THREADS>(*static_cast<const CArgs*>(a),
                                                             static_cast<cudaStream_t>(stream));
}

// out[4] as md_k4_info's, for the global form's run kernel (the charged
// slices' flag set) at N atoms of T types
extern "C" int md_k4_big_info(int N, int T, int* out) {
  if (out == nullptr || N <= 0 || T < 1) return (int)cudaErrorInvalidValue;
  return (int)c_run_info(
      k34_run_kernel<true, true, true, true, true, true, K4_BIG_PATH, K4_THREADS>, N, T, false,
      true, out);
}
