// K1, redesigned for Hopper: whole NVT + fix-deform or NVT + virial-sampling
// runs of many all-pairs LJ/OPLS chain boxes, one thread block per job, and
// the force + virial entry over (box, tile of rows) blocks.  Exported for
// ops/md_fused.py (md_run and md_forces_virial send every runner whose
// kernel is "K1" here).
//
// Replaces the all-pairs LJ/OPLS chain branch of the TPU kernel
// scema_tpu/ops/md_fused.py::_make_kernel (launched by fused_chunk,
// :1850): forces_allpairs (:1135) with the minimum image of refresh_images
// (:1101), bonded_chain_forces (:349), nhc_half (:1413), the deform path
// _h_at (:814) / _remap_coeffs (:827) and the sampling accumulation.  Per
// job it keeps the semantics of the earlier design (md_kernel.cuh with every
// flag off, still built in md_allpairs.cu for the A/B and for K1m's first
// design's bit-for-bit checks; K1m's redesign, md_k1m.cu, runs this pair
// arithmetic from md_k1.cuh):
// whole runs in one launch, a job with n_run = 0 left bit-identical, the
// per-pair sequential triclinic minimum image, deterministic sums, no
// atomics.
//
// What bounds it: the pair loop.  A job does N^2 pair evaluations per step
// (full rows, no Newton halving: halving lost on this card, PERF.md);
// at N = 512 a quarter of the pairs lie inside the 10 A cutoff, but a warp
// runs the live body whenever any of its 32 lanes has a live pair, so
// nearly every pair pays it.  The work is issuing ~40 instructions per
// pair, far above the bytes (the state in and out).
//
// Design (each lever was timed on its own on the card before the next was
// taken; PERF.md keeps those times):
// * Two 512-thread blocks per SM: __launch_bounds__(512, 2) holds the run
//   and force kernels to 64 registers, 32 resident warps per SM.  Shared
//   memory per job is 22 N floats + the type table (45 KB at N = 512).
// * The chain bonded terms in a pass of their own after the pair loop, so
//   their registers (a dihedral's four positions and role forces) do not
//   share the pair loop's live range.  The pass writes the 12 N role buffer
//   as md_kernel.cuh's bonded_terms does, one barrier, then every atom
//   gathers its roles at offsets 0..3; the virial keeps the earlier split
//   (half of each ordered pair, plus the bonded add_outer terms).
// * No N x N plane reads: positions and the atom's code share one float4
//   (one 16-byte shared broadcast per j); lj1/lj2 come from a (T, T) type
//   table in shared memory (built on the host in float64, then cast, as
//   dense_planes builds the planes); the special-bond weights come from a
//   window of chain offsets |j - i| <= 3 in the atom's code: excluded pairs
//   (weight 0) are skipped inside the loop — never subtracted afterwards,
//   where an excluded 1-2 pair's LJ force would cancel catastrophically —
//   and a weight other than 0 or 1 multiplies the table entry in float32.
//   make_runner refuses a special partner outside the window.
// * The inverse square distance 1 / max(r2, r2min): rsqrtf squared in the
//   run (faster than the IEEE forms, within the run's rule against float64),
//   __frcp_rn (the IEEE divide's rounding) in the force entry, whose virials
//   the stiffness probe differences at +-1e-3 strain.
// * The force entry fills the card: a (tiles, B) grid, 32 rows of one box
//   per block and 16 warps that each take a slice of the j range for those
//   rows; the slices' partial forces are summed in slice order in shared
//   memory, the bonded pass covers the tile's rows plus a halo of the 3
//   anchors before it (recomputed, never read from another block), and each
//   block writes its partial virial to a (B, tiles, 6) scratch that a second
//   small kernel sums in tile order.
#include "md_k1.cuh"

namespace {

// one job's shared memory: 22 N floats, the type table, the reduction
// scratch and the NHC chain + broadcasts
struct K1Smem {
  float4* p4;
  float *vx, *vy, *vz, *fx, *fy, *fz, *q;
  float2* tbl;
  float *red, *misc;
};

__host__ __device__ __forceinline__ size_t k1_run_smem(int N, int T) {
  return sizeof(float) * ((size_t)22 * N + 2 * T * T + MAXW * NRED + NHC + 1);
}

__device__ __forceinline__ K1Smem k1_carve(float4* sm, int N, int T) {
  K1Smem s;
  s.p4 = sm;
  s.vx = reinterpret_cast<float*>(sm + N);
  s.vy = s.vx + N; s.vz = s.vy + N;
  s.fx = s.vz + N; s.fy = s.fx + N; s.fz = s.fy + N;
  s.q = s.fz + N;
  s.tbl = reinterpret_cast<float2*>(s.q + 12 * N);  // 22 N floats: 8-byte aligned
  s.red = reinterpret_cast<float*>(s.tbl + T * T);
  s.misc = s.red + MAXW * NRED;
  return s;
}

// Pair + chain forces of every atom at the positions in shared memory for
// box h (with WV this thread's virial partials into w): the pair loop, then
// the chain terms in a pass of their own.  Entry and exit are block-synced.
template <bool WV>
__device__ void k1_forces(const K1Args& A, const K1Smem& S, const Box& h, float w[6]) {
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x;
  const K1Pair P = k1_pair(A, S.p4, S.tbl, h);
  for (int i = tid; i < N; i += nt) {
    float f[3] = {0.f, 0.f, 0.f};
    k1_row<true, WV>(P, i, 0, N, f, w);
    S.fx[i] = f[0];
    S.fy[i] = f[1];
    S.fz[i] = f[2];
  }
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

__global__ void __launch_bounds__(512, 2) k1_run_kernel(K1Args A) {
  extern __shared__ float4 k1_sm[];
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
  const K1Smem S = k1_carve(k1_sm, N, A.T);
  Smem V;  // md_kernel.cuh's view for nhc_half: velocities and scratch
  V.vx = S.vx; V.vy = S.vy; V.vz = S.vz; V.red = S.red; V.misc = S.misc;
  float* st = A.state + (size_t)job * 6 * N;
  for (int i = tid; i < N; i += nt) {
    S.p4[i] = make_float4(st[i], st[N + i], st[2 * N + i],
                          __int_as_float(A.code[i]));
    S.vx[i] = st[3 * N + i]; S.vy[i] = st[4 * N + i]; S.vz[i] = st[5 * N + i];
  }
  for (int t = tid; t < A.T * A.T; t += nt) S.tbl[t] = make_float2(A.tbl[2 * t], A.tbl[2 * t + 1]);
  if (tid < NHC) S.misc[tid] = A.vxi[job * NHC + tid];
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
  k1_forces<false>(A, S, h0, w);
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
      k1_forces<true>(A, S, h, w);
    else
      k1_forces<false>(A, S, h, w);
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
  for (int i = tid; i < N; i += nt) {
    const float4 p = S.p4[i];
    st[i] = p.x; st[N + i] = p.y; st[2 * N + i] = p.z;
    st[3 * N + i] = S.vx[i]; st[4 * N + i] = S.vy[i]; st[5 * N + i] = S.vz[i];
  }
  if (tid < NHC) A.vxi[job * NHC + tid] = S.misc[tid];
  if (tid < 6) A.press[job * 6 + tid] = pacc[tid];
}

__host__ __device__ __forceinline__ int k1_slices(int N) {
  const int s = (N + 31) / 32;
  return s < K1_SLICES ? s : K1_SLICES;
}

__host__ __device__ __forceinline__ size_t k1_forces_smem(int N, int T) {
  return sizeof(float4) * (size_t)N + sizeof(float2) * (size_t)T * T +
         sizeof(float) * ((size_t)k1_slices(N) * K1_ROWS * 3 + 12 * K1_Q + MAXW * NRED);
}

// Force + virial entry: block (tile, box) computes rows [32 tile, 32 tile +
// 32) of box `box` — warp s sums the pairs with j in its slice, the slices'
// partials are added in slice order, then the chain roles of anchors
// start - 3 .. end - 1 — and writes its partial virial (the pair halves of
// its rows and the terms of the anchors it owns) to partial[box][tile].
__global__ void __launch_bounds__(512, 2) k1_forces_kernel(K1Args A) {
  extern __shared__ float4 k1_sm[];
  const int N = A.N, T = A.T;
  const int tile = blockIdx.x, box = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ns = nt >> 5, lane = tid & 31, slice = tid >> 5;
  const int start = tile * K1_ROWS;
  const int end = start + K1_ROWS < N ? start + K1_ROWS : N;
  const int kbeg = start - K1_REACH > 0 ? start - K1_REACH : 0;
  float4* p4 = k1_sm;
  float2* tbl = reinterpret_cast<float2*>(p4 + N);
  float* part = reinterpret_cast<float*>(tbl + T * T);
  float* q = part + ns * K1_ROWS * 3;
  float* red = q + 12 * K1_Q;
  const float* p = A.pos + (size_t)box * 3 * N;
  for (int i = tid; i < N; i += nt)
    p4[i] = make_float4(p[i], p[N + i], p[2 * N + i], __int_as_float(A.code[i]));
  for (int t = tid; t < T * T; t += nt) tbl[t] = make_float2(A.tbl[2 * t], A.tbl[2 * t + 1]);
  const float* hb = A.h6 + box * 6;
  const Box h = {hb[0], hb[1], hb[2], hb[3], hb[4], hb[5]};
  __syncthreads();
  const K1Pair P = k1_pair(A, p4, tbl, h);
  float f[3] = {0.f, 0.f, 0.f};
  float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int i = start + lane;
  const int jlen = (N + ns - 1) / ns;
  const int j0 = slice * jlen;
  const int j1 = j0 + jlen < N ? j0 + jlen : N;
  if (i < end) k1_row<false, true>(P, i, j0, j1, f, w);
  for (int a = 0; a < 3; ++a) part[(slice * K1_ROWS + lane) * 3 + a] = f[a];
  if (tid < end - kbeg) {
    const int k = kbeg + tid;
    float wb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    k1_bonded<true>(A.topo, N, p4, q, K1_Q, k, tid, wb);
    if (k >= start)  // a halo anchor's virial is its own tile's
      for (int c = 0; c < 6; ++c) w[c] += wb[c];
  }
  __syncthreads();
  if (tid < end - start) {
    const int r = start + tid;
    float g[3];
    k1_gather(q, K1_Q, r, r - kbeg, g);
    float* fo = A.force + (size_t)box * 3 * N;
    for (int a = 0; a < 3; ++a) {
      float acc = part[tid * 3 + a];
      for (int s = 1; s < ns; ++s) acc += part[(s * K1_ROWS + tid) * 3 + a];
      fo[a * N + r] = acc + g[a];
    }
  }
  block_sum<6>(w, red);
  if (tid < 6) A.partial[((size_t)box * A.tiles + tile) * 6 + tid] = w[tid];
}

// virial[box][c] = the tiles' partials of box summed in tile order
__global__ void k1_virial_kernel(const float* __restrict__ partial, int tiles, int n,
                                 float* __restrict__ virial) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // box * 6 + c
  if (t >= n) return;
  const float* pt = partial + (size_t)(t / 6) * tiles * 6 + t % 6;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += pt[k * 6];
  virial[t] = s;
}

bool k1_args_ok(const K1Args* a) {
  if (a == nullptr || a->N <= 0 || a->B < 0 || a->T < 1 || a->T > K1_TYPE + 1 || !a->topo)
    return false;
  if (k1_run_smem(a->N, a->T) > 232448) return false;
  return a->tbl && a->code && a->win;
}

cudaError_t k1_launch_run(const K1Args& A, cudaStream_t s) {
  if (!k1_args_ok(&A) || !A.invm || !A.mftm || !A.state || !A.vxi || !A.press || !A.n_run ||
      !A.fscal)
    return cudaErrorInvalidValue;
  auto kernel = k1_run_kernel;
  const size_t bytes = k1_run_smem(A.N, A.T);
  int threads = 0;
  cudaError_t err = prepare(kernel, A.N, bytes, &threads);
  if (err != cudaSuccess) return err;
  if (A.B == 0) return cudaSuccess;
  kernel<<<A.B, threads, bytes, s>>>(A);
  return cudaGetLastError();
}

cudaError_t k1_launch_forces(const K1Args& A, cudaStream_t s) {
  const int tiles = (A.N + K1_ROWS - 1) / K1_ROWS;
  if (!k1_args_ok(&A) || A.tiles != tiles || !A.pos || !A.h6 || !A.force || !A.virial ||
      !A.partial)
    return cudaErrorInvalidValue;
  auto kernel = k1_forces_kernel;
  const size_t bytes = k1_forces_smem(A.N, A.T);
  cudaError_t err = opt_in(kernel, bytes);
  if (err != cudaSuccess || A.B == 0) return err;
  kernel<<<dim3(tiles, A.B), 32 * k1_slices(A.N), bytes, s>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 6 * A.B;
  k1_virial_kernel<<<(n + 127) / 128, 128, 0, s>>>(A.partial, tiles, n, A.virial);
  return cudaGetLastError();
}

}  // namespace

extern "C" int md_k1_run_f32(const void* args, void* stream) {
  const K1Args* a = static_cast<const K1Args*>(args);
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)k1_launch_run(*a, static_cast<cudaStream_t>(stream));
}

extern "C" int md_k1_forces_f32(const void* args, void* stream) {
  const K1Args* a = static_cast<const K1Args*>(args);
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  return (int)k1_launch_forces(*a, static_cast<cudaStream_t>(stream));
}

// out[4] = (registers, local bytes, blocks per SM, threads) of the run
// kernel (entry 0) or of the force entry's (entry 1) at N atoms of T types
extern "C" int md_k1_info(int entry, int N, int T, int* out) {
  if (out == nullptr || N <= 0 || T < 1 || entry < 0 || entry > 1)
    return (int)cudaErrorInvalidValue;
  if (entry == 1)
    return (int)kernel_info(k1_forces_kernel, 32 * k1_slices(N), k1_forces_smem(N, T), out);
  const int threads = ((N + 31) / 32) * 32 < 512 ? ((N + 31) / 32) * 32 : 512;
  return (int)kernel_info(k1_run_kernel, threads, k1_run_smem(N, T), out);
}
