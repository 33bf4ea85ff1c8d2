// K5, redesigned for Hopper: whole NVT + fix-deform or NVT + virial-sampling
// runs of many Stillinger-Weber boxes (p = 4, q = 0, one element), one
// thread block per job, and the force + virial entry over (tile of rows,
// box) blocks.  Exported for ops/md_fused.py (md_run and md_forces_virial
// send every runner whose kernel is "K5" here).
//
// Replaces the TPU kernel's SW branch, scema_tpu/ops/md_fused.py FusedSpec.sw
// -> forces_allpairs_sw (:910-1081), launched by the pallas_call at :1850.
// Per job it keeps the semantics of the first design (md_kernel.cuh's SW
// flag, still built in md_sw.cu for the A/B): whole runs in one launch, a
// job with n_run = 0 left bit-identical, the per-pair sequential triclinic
// minimum image, live pairs r2 < (rc - 1e-6)^2 and r2 > 1e-8, the exps taken
// on live pairs only, deterministic sums, no atomics in any sum.
//
// What bounds it: finding the live pairs.  A force call is two sweeps per
// atom, the three-body moments (s, m, Q) and then the ordered pairs' w =
// dT/dd from both atoms' adjoints; in the diamond box about 4 of the 215
// other atoms are live, so the function's arithmetic is a few percent of
// the N^2 geometry.  The first design scanned all N js in both sweeps and
// ran the live body in a warp whenever any lane had a live j.
//
// Design:
// * Sweep 1 scans every j (the minimum image of each pair), sums the
//   moments of the live ones and writes their js, in j order, to a
//   per-atom list in shared memory (cap slots of 16 bits per atom, the cap
//   a launch argument, 16 on the path).  Sweep 2 walks only that list: the
//   same pairs in the same order as the full scan, so the same sums.  An
//   atom with more live js than the cap walks all N js in sweep 2 (same
//   order and arithmetic again) and is counted, with the most live js of
//   an atom, in a (B, 2) stats row per job.
// * Positions in a float4 per atom (one 16-byte shared read per j).
// * The run kernel's block is one thread per atom rounded up to a warp,
//   and its launch bound is fitted to that width: 256 threads at four
//   blocks per SM for boxes up to 256 atoms (the slice's 216: 224 threads),
//   512 at two blocks for up to 640 (the fused gate); 64 registers either
//   way (the first design was compiled for 512 threads at one block and
//   launched at 224).
// * The force entry fills the card: a (tiles, B) grid of 32 rows of one
//   box per block, 16 warps that each take a slice of the j range — a
//   moments kernel (the slices' partial moments summed in slice order,
//   adjoints to a (B, 10, N) scratch), a forces kernel (each row's pairs over
//   the j slices against the staged adjoints, the partial forces summed in
//   slice order, a partial virial per tile) and a small kernel that sums the
//   tiles' virials in tile order.
#include "md_kernel.cuh"

namespace {

// the force entry's tile: rows per block, and at most this many warps,
// each a slice of the j range
constexpr int K5_ROWS = 32, K5_SLICES = 16;
// the largest live-list cap (slots per atom) a run takes
constexpr int K5_MAX_CAP = 64;
// the largest box: the list holds 16-bit js
constexpr int K5_MAX_ATOMS = 65535;

// Every operand of a K5 launch; mirrored field for field by
// ops/md_fused.py's ctypes structure _K5Args.
struct K5Args {
  const float *invm, *mftm;
  float *state, *vxi, *press;
  const int* n_run;
  const float *fscal, *pos, *h6;
  float *force, *virial, *partial;  // partial: (B, tiles, 6) virial scratch
  float* adj;                       // (B, 10, N) the force entry's adjoints
  int* stats;                       // (B, 2) a run's overflowing atom-calls, most live js
  int B, N, cap, deform, sample, tiles;
  float ndof, boltz, nktv2p, tdamp;
  SWC sw;
};

// Sweep 1's pair: if j is live for centre i (d = r_j - r_i by the minimum
// image), add its moments (g, g u, g u (x) u) into m and return true.
__device__ __forceinline__ bool k5_moments(const SWC& C, const Box& h, float ilx, float ily,
                                           float ilz, const float4& pi, const float4& pj,
                                           float m[10]) {
  float dx = pj.x - pi.x, dy = pj.y - pi.y, dz = pj.z - pi.z;
  const float r2 = min_image_r2(h, ilx, ily, ilz, dx, dy, dz);
  if (!(r2 < C.rc2 && r2 > 1e-8f)) return false;
  const float r = sqrtf(r2);
  const float inv_r = 1.f / r;
  const float g = expf(C.gs / (r - C.rc));
  const float ux = dx * inv_r, uy = dy * inv_r, uz = dz * inv_r;
  const float gx = g * ux, gy = g * uy, gz = g * uz;
  m[0] += g;
  m[1] += gx; m[2] += gy; m[3] += gz;
  m[4] += gx * ux; m[5] += gy * uy; m[6] += gz * uz;
  m[7] += gx * uy; m[8] += gx * uz; m[9] += gy * uz;
  return true;
}

// the ten adjoints of a centre with moments m (a_s, a_m, a_Q), written at
// out[k * stride]
__device__ __forceinline__ void k5_adjoints(const SWC& C, const float m[10], float* out,
                                            int stride) {
  out[0] = C.k_s * m[0];
  for (int k = 1; k < 4; ++k) out[k * stride] = C.k_m * m[k];
  for (int k = 4; k < 10; ++k) out[k * stride] = C.lam_eps * m[k];
}

// Sweep 2's pair: if j is live for centre i, add w_A (centre adjoints a) -
// w_B (atom j's, adj[k N + j]) into f and, with WV, role A's virial
// -sym(w_A (x) d) into wl (md_kernel.cuh's sw_forces arithmetic).
template <bool WV>
__device__ __forceinline__ void k5_pair(const SWC& C, const Box& h, float ilx, float ily,
                                        float ilz, const float4& pi, const float4& pj,
                                        const float a[10], const float* adj, int N, int j,
                                        float f[3], float wl[6]) {
  float dx = pj.x - pi.x, dy = pj.y - pi.y, dz = pj.z - pi.z;
  const float r2 = min_image_r2(h, ilx, ily, ilz, dx, dy, dz);
  if (!(r2 < C.rc2 && r2 > 1e-8f)) return;
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
  f[0] += wa[0] - wb[0];
  f[1] += wa[1] - wb[1];
  f[2] += wa[2] - wb[2];
  if constexpr (WV) {  // role A enumerates every ordered pair once
    wl[0] -= wa[0] * dx;
    wl[1] -= wa[1] * dy;
    wl[2] -= wa[2] * dz;
    wl[3] -= 0.5f * (wa[0] * dy + wa[1] * dx);
    wl[4] -= 0.5f * (wa[0] * dz + wa[2] * dx);
    wl[5] -= 0.5f * (wa[1] * dz + wa[2] * dy);
  }
}

// one job's shared memory: positions (float4), velocities, forces, the ten
// adjoint rows, the reduction scratch, the NHC chain + broadcast and two
// counters, then each atom's live count and its list (slot-major, 16 bits)
struct K5Smem {
  float4* p4;
  float *vx, *vy, *vz, *fx, *fy, *fz, *adj, *red, *misc;
  int* ist;  // [0] atom-calls above the cap, [1] most live js of an atom
  unsigned short *cnt, *list;
};

constexpr int K5_MISC = 8;  // NHC chain (3), scale, the two counters (ints), pad

__host__ __device__ __forceinline__ size_t k5_run_smem(int N, int cap) {
  return sizeof(float4) * (size_t)N + sizeof(float) * ((size_t)16 * N + MAXW * NRED + K5_MISC) +
         sizeof(unsigned short) * (size_t)(cap + 1) * N;
}

__device__ __forceinline__ K5Smem k5_carve(float4* sm, int N) {
  K5Smem s;
  s.p4 = sm;
  s.vx = reinterpret_cast<float*>(sm + N);
  s.vy = s.vx + N; s.vz = s.vy + N;
  s.fx = s.vz + N; s.fy = s.fx + N; s.fz = s.fy + N;
  s.adj = s.fz + N;
  s.red = s.adj + 10 * N;
  s.misc = s.red + MAXW * NRED;
  s.ist = reinterpret_cast<int*>(s.misc + NHC + 1);
  s.cnt = reinterpret_cast<unsigned short*>(s.misc + K5_MISC);
  s.list = s.cnt + N;
  return s;
}

// SW forces (and, with WV, this thread's share of role A's virial in w) at
// the positions in shared memory for box h: sweep 1 over every j writes the
// moments' adjoints and the live lists, sweep 2 walks the lists (all N js
// for an atom above the cap, counted in over).  Entry and exit are
// block-synced.
template <bool WV>
__device__ __forceinline__ void k5_forces(const K5Args& A, const K5Smem& S, const Box& h,
                                          float w[6], int& over, int& most) {
  const int N = A.N, cap = A.cap, tid = threadIdx.x, nt = blockDim.x;
  const SWC& C = A.sw;
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  for (int i = tid; i < N; i += nt) {
    const float4 pi = S.p4[i];
    float m[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int c = 0;
    for (int j = 0; j < N; ++j) {  // j = i has r2 = 0: never live
      if (k5_moments(C, h, ilx, ily, ilz, pi, S.p4[j], m)) {
        if (c < cap) S.list[c * N + i] = (unsigned short)j;
        ++c;
      }
    }
    k5_adjoints(C, m, S.adj + i, N);
    S.cnt[i] = (unsigned short)(c < 0xffff ? c : 0xffff);
    over += c > cap;
    most = c > most ? c : most;
  }
  __syncthreads();
  for (int i = tid; i < N; i += nt) {
    const float4 pi = S.p4[i];
    float a[10];
    for (int k = 0; k < 10; ++k) a[k] = S.adj[k * N + i];
    float f[3] = {0.f, 0.f, 0.f};
    float wl[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int c = S.cnt[i];
    if (c <= cap) {
      for (int s = 0; s < c; ++s) {
        const int j = S.list[s * N + i];
        k5_pair<WV>(C, h, ilx, ily, ilz, pi, S.p4[j], a, S.adj, N, j, f, wl);
      }
    } else {
      for (int j = 0; j < N; ++j)
        k5_pair<WV>(C, h, ilx, ily, ilz, pi, S.p4[j], a, S.adj, N, j, f, wl);
    }
    S.fx[i] = f[0];
    S.fy[i] = f[1];
    S.fz[i] = f[2];
    if constexpr (WV)
      for (int k = 0; k < 6; ++k) w[k] += wl[k];
  }
  __syncthreads();
}

template <int LB>
__global__ void __launch_bounds__(LB, LB <= 256 ? 4 : 2) k5_run_kernel(K5Args A) {
  extern __shared__ float4 k5_sm[];
  const int job = blockIdx.x;
  const int N = A.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_run = A.n_run[job];
  if (n_run <= 0) {
    if (tid < 6) A.press[job * 6 + tid] = 0.f;
    if (tid < 2) A.stats[job * 2 + tid] = 0;
    return;
  }
  const float* __restrict__ invm = A.invm;
  const float* __restrict__ mftm = A.mftm;
  const K5Smem S = k5_carve(k5_sm, N);
  Smem V;  // md_kernel.cuh's view for nhc_half: velocities and scratch
  V.vx = S.vx; V.vy = S.vy; V.vz = S.vz; V.red = S.red; V.misc = S.misc;
  float* st = A.state + (size_t)job * 6 * N;
  for (int i = tid; i < N; i += nt) {
    S.p4[i] = make_float4(st[i], st[N + i], st[2 * N + i], 0.f);
    S.vx[i] = st[3 * N + i]; S.vy[i] = st[4 * N + i]; S.vz[i] = st[5 * N + i];
  }
  if (tid < NHC) S.misc[tid] = A.vxi[job * NHC + tid];
  if (tid < 2) S.ist[tid] = 0;
  const float* fs = A.fscal + (size_t)job * FSCAL;
  const float dt = fs[F_DT];
  const float kt = A.boltz * fs[F_T];
  const Box h0 = {fs[F_H0], fs[F_H0 + 1], fs[F_H0 + 2], fs[F_H0 + 3], fs[F_H0 + 4], fs[F_H0 + 5]};
  float eps[6];
  for (int k = 0; k < 6; ++k) eps[k] = fs[F_EPS + k];
  const float n_tot = (float)n_run;
  const int deform = A.deform, sample = A.sample;
  __syncthreads();

  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float pacc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int over = 0, most = 0;
  k5_forces<false>(A, S, h0, w, over, most);
  for (int s = 0; s < n_run; ++s) {
    const Box h = deform ? h_at(h0, eps, (float)s / n_tot) : h0;
    nhc_half(V, mftm, N, dt, kt, A.ndof, A.tdamp);
    const float half = 0.5f * dt;
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      S.vx[i] += half * S.fx[i] * im;
      S.vy[i] += half * S.fy[i] * im;
      S.vz[i] += half * S.fz[i] * im;
      float4 p = S.p4[i];
      p.x += dt * S.vx[i];
      p.y += dt * S.vy[i];
      p.z += dt * S.vz[i];
      S.p4[i] = p;
    }
    __syncthreads();
    for (int k = 0; k < 6; ++k) w[k] = 0.f;
    if (sample)
      k5_forces<true>(A, S, h, w, over, most);
    else
      k5_forces<false>(A, S, h, w, over, most);
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
      S.vx[i] += half * S.fx[i] * im;
      S.vy[i] += half * S.fy[i] * im;
      S.vz[i] += half * S.fz[i] * im;
    }
    nhc_half(V, mftm, N, dt, kt, A.ndof, A.tdamp);
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
  // the counters are integers: their shared atomics give the same totals in
  // any order
  if (over) atomicAdd(&S.ist[0], over);
  atomicMax(&S.ist[1], most);
  for (int i = tid; i < N; i += nt) {
    const float4 p = S.p4[i];
    st[i] = p.x; st[N + i] = p.y; st[2 * N + i] = p.z;
    st[3 * N + i] = S.vx[i]; st[4 * N + i] = S.vy[i]; st[5 * N + i] = S.vz[i];
  }
  if (tid < NHC) A.vxi[job * NHC + tid] = S.misc[tid];
  if (tid < 6) A.press[job * 6 + tid] = pacc[tid];
  __syncthreads();
  if (tid < 2) A.stats[job * 2 + tid] = S.ist[tid];
}

__host__ __device__ __forceinline__ int k5_slices(int N) {
  const int s = (N + 31) / 32;
  return s < K5_SLICES ? s : K5_SLICES;
}

// Force entry, moments: block (tile, box) sums the moments of rows [32
// tile, 32 tile + 32) of box `box` — warp s over the js of its slice, the
// slices' partials added in slice order — and writes their adjoints to
// adj[box].
__global__ void __launch_bounds__(512) k5_moments_kernel(K5Args A) {
  extern __shared__ float4 k5_sm[];
  const int N = A.N;
  const int tile = blockIdx.x, box = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ns = nt >> 5, lane = tid & 31, slice = tid >> 5;
  const int start = tile * K5_ROWS;
  const int end = start + K5_ROWS < N ? start + K5_ROWS : N;
  float4* p4 = k5_sm;
  float* part = reinterpret_cast<float*>(p4 + N);
  const float* p = A.pos + (size_t)box * 3 * N;
  for (int i = tid; i < N; i += nt) p4[i] = make_float4(p[i], p[N + i], p[2 * N + i], 0.f);
  const float* hb = A.h6 + box * 6;
  const Box h = {hb[0], hb[1], hb[2], hb[3], hb[4], hb[5]};
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  __syncthreads();
  float m[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int i = start + lane;
  const int jlen = (N + ns - 1) / ns;
  const int j0 = slice * jlen;
  const int j1 = j0 + jlen < N ? j0 + jlen : N;
  if (i < end) {
    const float4 pi = p4[i];
    for (int j = j0; j < j1; ++j) k5_moments(A.sw, h, ilx, ily, ilz, pi, p4[j], m);
  }
  for (int k = 0; k < 10; ++k) part[(slice * K5_ROWS + lane) * 10 + k] = m[k];
  __syncthreads();
  if (tid < end - start) {
    float acc[10];
    for (int k = 0; k < 10; ++k) {
      acc[k] = part[tid * 10 + k];
      for (int s = 1; s < ns; ++s) acc[k] += part[(s * K5_ROWS + tid) * 10 + k];
    }
    k5_adjoints(A.sw, acc, A.adj + (size_t)box * 10 * N + start + tid, N);
  }
}

// Force entry, forces: block (tile, box) computes rows [32 tile, 32 tile +
// 32) of box `box` against the box's adjoints (staged in shared memory) —
// warp s over the js of its slice, the slices' partial forces added in slice
// order — and writes its partial virial (role A of its rows' ordered pairs)
// to partial[box][tile].
__global__ void __launch_bounds__(512) k5_forces_kernel(K5Args A) {
  extern __shared__ float4 k5_sm[];
  const int N = A.N;
  const int tile = blockIdx.x, box = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ns = nt >> 5, lane = tid & 31, slice = tid >> 5;
  const int start = tile * K5_ROWS;
  const int end = start + K5_ROWS < N ? start + K5_ROWS : N;
  float4* p4 = k5_sm;
  float* adj = reinterpret_cast<float*>(p4 + N);
  float* part = adj + 10 * N;
  float* red = part + ns * K5_ROWS * 3;
  const float* p = A.pos + (size_t)box * 3 * N;
  const float* ab = A.adj + (size_t)box * 10 * N;
  for (int i = tid; i < N; i += nt) p4[i] = make_float4(p[i], p[N + i], p[2 * N + i], 0.f);
  for (int t = tid; t < 10 * N; t += nt) adj[t] = ab[t];
  const float* hb = A.h6 + box * 6;
  const Box h = {hb[0], hb[1], hb[2], hb[3], hb[4], hb[5]};
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  __syncthreads();
  float f[3] = {0.f, 0.f, 0.f};
  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int i = start + lane;
  const int jlen = (N + ns - 1) / ns;
  const int j0 = slice * jlen;
  const int j1 = j0 + jlen < N ? j0 + jlen : N;
  if (i < end) {
    const float4 pi = p4[i];
    float a[10];
    for (int k = 0; k < 10; ++k) a[k] = adj[k * N + i];
    for (int j = j0; j < j1; ++j)
      k5_pair<true>(A.sw, h, ilx, ily, ilz, pi, p4[j], a, adj, N, j, f, w);
  }
  for (int c = 0; c < 3; ++c) part[(slice * K5_ROWS + lane) * 3 + c] = f[c];
  __syncthreads();
  if (tid < end - start) {
    float* fo = A.force + (size_t)box * 3 * N;
    for (int c = 0; c < 3; ++c) {
      float acc = part[tid * 3 + c];
      for (int s = 1; s < ns; ++s) acc += part[(s * K5_ROWS + tid) * 3 + c];
      fo[c * N + start + tid] = acc;
    }
  }
  block_sum<6>(w, red);
  if (tid < 6) A.partial[((size_t)box * A.tiles + tile) * 6 + tid] = w[tid];
}

// virial[box][c] = the tiles' partials of box summed in tile order
__global__ void k5_virial_kernel(const float* __restrict__ partial, int tiles, int n,
                                 float* __restrict__ virial) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // box * 6 + c
  if (t >= n) return;
  const float* pt = partial + (size_t)(t / 6) * tiles * 6 + t % 6;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += pt[k * 6];
  virial[t] = s;
}

__host__ __device__ __forceinline__ size_t k5_moments_smem(int N) {
  return sizeof(float4) * (size_t)N + sizeof(float) * (size_t)k5_slices(N) * K5_ROWS * 10;
}

__host__ __device__ __forceinline__ size_t k5_forces_smem(int N) {
  return sizeof(float4) * (size_t)N +
         sizeof(float) * ((size_t)10 * N + (size_t)k5_slices(N) * K5_ROWS * 3 + MAXW * NRED);
}

template <class K>
cudaError_t k5_opt_in(K kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool k5_args_ok(const K5Args* a) {
  return a != nullptr && a->N > 0 && a->N <= K5_MAX_ATOMS && a->B >= 0 && a->sw.rc > 0.f;
}

// the run kernel for N atoms (the instance whose launch bound covers one
// thread per atom, up to 512) and its block width
template <class F>
cudaError_t k5_with_run_kernel(int N, int cap, F&& fn) {
  const size_t bytes = k5_run_smem(N, cap);
  if (bytes > 232448) return cudaErrorInvalidValue;
  const int t = ((N + 31) / 32) * 32;
  if (t <= 256) {
    auto kernel = k5_run_kernel<256>;
    cudaError_t err = k5_opt_in(kernel, bytes);
    return err != cudaSuccess ? err : fn(kernel, t, bytes);
  }
  auto kernel = k5_run_kernel<512>;
  cudaError_t err = k5_opt_in(kernel, bytes);
  return err != cudaSuccess ? err : fn(kernel, t < 512 ? t : 512, bytes);
}

cudaError_t k5_launch_run(const K5Args& A, cudaStream_t s) {
  if (!k5_args_ok(&A) || A.cap < 1 || A.cap > K5_MAX_CAP || !A.invm || !A.mftm || !A.state ||
      !A.vxi || !A.press || !A.n_run || !A.fscal || !A.stats)
    return cudaErrorInvalidValue;
  return k5_with_run_kernel(A.N, A.cap, [&](auto kernel, int threads, size_t bytes) {
    if (A.B == 0) return cudaSuccess;
    kernel<<<A.B, threads, bytes, s>>>(A);
    return cudaGetLastError();
  });
}

cudaError_t k5_launch_forces(const K5Args& A, cudaStream_t s) {
  const int tiles = (A.N + K5_ROWS - 1) / K5_ROWS;
  if (!k5_args_ok(&A) || A.tiles != tiles || !A.pos || !A.h6 || !A.force || !A.virial ||
      !A.partial || !A.adj)
    return cudaErrorInvalidValue;
  const int threads = 32 * k5_slices(A.N);
  const size_t mb = k5_moments_smem(A.N), fb = k5_forces_smem(A.N);
  cudaError_t err = k5_opt_in(k5_moments_kernel, mb);
  if (err == cudaSuccess) err = k5_opt_in(k5_forces_kernel, fb);
  if (err != cudaSuccess || A.B == 0) return err;
  k5_moments_kernel<<<dim3(tiles, A.B), threads, mb, s>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k5_forces_kernel<<<dim3(tiles, A.B), threads, fb, s>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = 6 * A.B;
  k5_virial_kernel<<<(n + 127) / 128, 128, 0, s>>>(A.partial, tiles, n, A.virial);
  return cudaGetLastError();
}

// registers, local (spill) bytes per thread, resident blocks per SM and
// block width of one kernel
template <class K>
cudaError_t k5_kernel_info(K kernel, int threads, size_t bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = k5_opt_in(kernel, bytes);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = threads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, bytes);
}

}  // namespace

// the argument structure has internal linkage: the entries take it untyped
extern "C" int md_k5_run_f32(const void* args, void* stream) {
  const K5Args* a = static_cast<const K5Args*>(args);
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)k5_launch_run(*a, static_cast<cudaStream_t>(stream));
}

extern "C" int md_k5_forces_f32(const void* args, void* stream) {
  const K5Args* a = static_cast<const K5Args*>(args);
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)k5_launch_forces(*a, static_cast<cudaStream_t>(stream));
}

// out[4] = (registers, local bytes, blocks per SM, threads) of the run
// kernel at N atoms and a live-list cap of cap (entry 0), or of the force
// entry's moments (1) or forces (2) kernel at N atoms
extern "C" int md_k5_info(int entry, int N, int cap, int* out) {
  if (out == nullptr || N <= 0 || N > K5_MAX_ATOMS || cap < 1 || cap > K5_MAX_CAP)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * k5_slices(N);
  switch (entry) {
    case 0:
      return (int)k5_with_run_kernel(N, cap, [&](auto kernel, int t, size_t bytes) {
        return k5_kernel_info(kernel, t, bytes, out);
      });
    case 1: return (int)k5_kernel_info(k5_moments_kernel, threads, k5_moments_smem(N), out);
    case 2: return (int)k5_kernel_info(k5_forces_kernel, threads, k5_forces_smem(N), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
