// K1m, redesigned for Hopper: K1's run (md_k1.cu) with J = 2 or 4 jobs per
// thread block, exported for ops/md_fused.py (md_run_multi).  Replaces the
// TPU kernel's FusedSpec.jobs > 1 program, scema_tpu/ops/md_fused.py:1850
// (:881-902, :1445-1590; entries run_strain_fused_multi :2415 and
// sample_stress_fused_multi :2450).
//
// The jobs of a block share their topology: the atom codes (type and
// special-bond window), the type table and the chain rows.  Only positions,
// velocities, boxes and thermostats differ.  So:
// * each thread owns atom i in each of the block's J jobs; the pair loop
//   decodes j's window once per j, takes the J jobs' distances, and loads
//   j's table entry once only where one of them is live (with the entry
//   read for every j, J = 2 ran 4.9 ms and J = 4 7.5; PERF.md) — J
//   independent accumulator sets, J chains in a latency-bound loop (ILP);
// * one set of barriers per step serves all J jobs: the NHC halves and the
//   sampling sums are J-wide block reductions, the bonded pass (md_k1.cu's
//   own k1_bonded / k1_gather) one barrier for all jobs;
// * shared memory is J x 22 N floats (K1's rows per job) and one type table:
//   93 KB at N = 512, J = 2, two blocks per SM (__launch_bounds__(512, 2):
//   64 registers, as K1); 183 KB at J = 4, one block per SM (128);
// * the sampling runs and the deform runs are kernels of their own
//   (SAMPLE), so that the deform run's pair loop does not carry the J
//   virial accumulators (with both loops in one kernel, J = 2 spilled at 64
//   registers).
// Per job each step's arithmetic and summation order are K1's: the same pair
// term (k1_apply), bonded pass, NHC chain (nhc_chain) and reductions per
// value in warp order, at K1's block width; the two bodies compile
// differently, so a job's result differs from K1's in the last float32
// bits, and the card checks hold K1m to K1's run rule against float64.  A
// job past its count is skipped (its state frozen); a job with n_run = 0 is
// never loaded and is left bit-identical.  What bounds it: K1's pair loop,
// ~40 instructions per pair; J jobs per block share each j's decode and
// fill the loop's latency.  The first K1m (md_multi.cu: J copies of K1's
// first design in turn) stays built for the A/B.
#include "md_k1.cuh"

namespace {

// per job in misc: the NHC chain (3) and the velocity-scale broadcast
constexpr int K1M_MISC = 4;
// values per job of the sampling sums: the kinetic tensor and the virial
constexpr int K1M_RED = 12;

template <int J>
__host__ __device__ __forceinline__ size_t k1m_smem(int N, int T) {
  return sizeof(float) * ((size_t)22 * J * N + 2 * (size_t)T * T + (size_t)MAXW * K1M_RED * J +
                          K1M_MISC * J);
}

// A block's shared memory: J jobs' rows field by field (job jj's atom i at
// [jj N + i]; velocities and forces component-major, [(c J + jj) N + i]),
// the type table, the reduction scratch and the jobs' NHC slots.
template <int J>
struct K1mSmem {
  float4* p4;  // positions + codes
  float* v;    // velocities
  float* f;    // forces
  float* q;    // role buffers, 12 N per job
  float2* tbl;
  float *red, *misc;
  __device__ __forceinline__ float* vc(int c, int jj, int N) const { return v + (c * J + jj) * N; }
  __device__ __forceinline__ float* fc(int c, int jj, int N) const { return f + (c * J + jj) * N; }
};

template <int J>
__device__ __forceinline__ K1mSmem<J> k1m_carve(float4* sm, int N, int T) {
  K1mSmem<J> s;
  s.p4 = sm;
  s.v = reinterpret_cast<float*>(sm + J * N);
  s.f = s.v + 3 * J * N;
  s.q = s.f + 3 * J * N;
  s.tbl = reinterpret_cast<float2*>(s.q + 12 * J * N);  // 22 J N floats: 8-byte aligned
  s.red = reinterpret_cast<float*>(s.tbl + T * T);
  s.misc = s.red + MAXW * K1M_RED * J;
  return s;
}

// Sum K values over the block; every thread receives the totals: block_sum's
// arithmetic per value (warp shuffles, then the warp partials in warp
// order), with K values of scratch per warp.
template <int K>
__device__ __forceinline__ void k1m_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w * K + k];
    v[k] = s;
  }
  __syncthreads();
}

// a job's box at fraction frac of its deform path (K1's h_at), or its
// start box
__device__ __forceinline__ Box k1m_box(const float* fs, bool deform, float frac) {
  const Box h0 = {fs[F_H0], fs[F_H0 + 1], fs[F_H0 + 2], fs[F_H0 + 3], fs[F_H0 + 4], fs[F_H0 + 5]};
  if (!deform) return h0;
  float eps[6];
  for (int k = 0; k < 6; ++k) eps[k] = fs[F_EPS + k];
  return h_at(h0, eps, frac);
}

// Pair + chain forces of the active jobs (bit jj of act) at the positions
// in shared memory for boxes h (with WV each job's virial partials into
// w[jj]): one pair loop for all jobs, then the chain terms in a pass of
// their own (K1's k1_forces per job).  Entry and exit are block-synced.
template <int J, bool WV>
__device__ __forceinline__ void k1m_forces(const K1Args& A, const K1mSmem<J>& S,
                                           const Box (&h)[J], unsigned act, float (&w)[J][6]) {
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x;
  float il[J][3];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    il[jj][0] = 1.f / h[jj].lx;
    il[jj][1] = 1.f / h[jj].ly;
    il[jj][2] = 1.f / h[jj].lz;
  }
  for (int i = tid; i < N; i += nt) {
    float xi[J], yi[J], zi[J], f[J][3];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float4 p = S.p4[jj * N + i];
      xi[jj] = p.x; yi[jj] = p.y; zi[jj] = p.z;
      f[jj][0] = f[jj][1] = f[jj][2] = 0.f;
    }
    const int ci = __float_as_int(S.p4[i].w);
    const int row = (ci & K1_TYPE) * A.T;
    const unsigned excl = (ci >> K1_EXCL) & 0x7fu, spec = (ci >> K1_SPEC) & 0x7fu;
    for (int j = 0; j < N; ++j) {
      const unsigned d = (unsigned)(j - i + K1_REACH);
      bool sp = false;
      if (d < (unsigned)K1_WIN) {
        if ((excl >> d) & 1u) continue;  // weight 0: skipped, never subtracted
        sp = (spec >> d) & 1u;
      }
      // the J distances first; the table entry only when a job's pair is
      // live (three quarters of the pairs lie outside the cutoff)
      const float4 pj0 = S.p4[j];
      float dx[J], dy[J], dz[J], r2[J];
      bool any_live = false;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float4 pj = jj == 0 ? pj0 : S.p4[jj * N + j];
        dx[jj] = pj.x - xi[jj];
        dy[jj] = pj.y - yi[jj];
        dz[jj] = pj.z - zi[jj];
        r2[jj] = min_image_r2(h[jj], il[jj][0], il[jj][1], il[jj][2], dx[jj], dy[jj], dz[jj]);
        any_live |= ((act >> jj) & 1u) && r2[jj] < A.cutoff2;
      }
      if (!any_live) continue;
      const float2 c = S.tbl[row + (__float_as_int(pj0.w) & K1_TYPE)];
      float a1 = c.x, a2 = c.y;
      if (sp) {
        const float wt = __ldg(A.win + (size_t)i * K1_WIN + d);
        a1 *= wt;
        a2 *= wt;
      }
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (!((act >> jj) & 1u) || !(r2[jj] < A.cutoff2)) continue;
        k1_apply<true, WV>(a1, a2, r2[jj], A.r2min, dx[jj], dy[jj], dz[jj], f[jj], w[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      if (!((act >> jj) & 1u)) continue;
      S.fc(0, jj, N)[i] = f[jj][0];
      S.fc(1, jj, N)[i] = f[jj][1];
      S.fc(2, jj, N)[i] = f[jj][2];
    }
  }
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    if (!((act >> jj) & 1u)) continue;
    for (int k = tid; k < N; k += nt)
      k1_bonded<WV>(A.topo, N, S.p4 + jj * N, S.q + (size_t)jj * 12 * N, N, k, k, w[jj]);
  }
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    if (!((act >> jj) & 1u)) continue;
    for (int i = tid; i < N; i += nt) {
      float g[3];
      k1_gather(S.q + (size_t)jj * 12 * N, N, i, i, g);
      S.fc(0, jj, N)[i] += g[0];
      S.fc(1, jj, N)[i] += g[1];
      S.fc(2, jj, N)[i] += g[2];
    }
  }
  __syncthreads();
}

// nhc_half of the active jobs: one J-wide reduction of 2 KE, thread jj
// advances job jj's chain, one barrier, every thread rescales its atoms.
template <int J>
__device__ __forceinline__ void k1m_nhc(const K1Args& A, const K1mSmem<J>& S,
                                        const float* __restrict__ mftm, const float (&dt)[J],
                                        unsigned act, int job0) {
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x;
  float ke[J];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) ke[jj] = 0.f;
  for (int i = tid; i < N; i += nt) {
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      if (!((act >> jj) & 1u)) continue;
      const float vx = S.vc(0, jj, N)[i], vy = S.vc(1, jj, N)[i], vz = S.vc(2, jj, N)[i];
      ke[jj] += mftm[i] * (vx * vx + vy * vy + vz * vz);
    }
  }
  k1m_sum<J>(ke, S.red);
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    if (tid == jj && ((act >> jj) & 1u)) {
      const float kt = A.boltz * A.fscal[(size_t)(job0 + jj) * FSCAL + F_T];
      float* vxi = S.misc + jj * K1M_MISC;
      vxi[NHC] = nhc_chain(vxi, ke[jj], dt[jj], kt, A.ndof, A.tdamp);
    }
  }
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    if (!((act >> jj) & 1u)) continue;
    const float scale = S.misc[jj * K1M_MISC + NHC];
    for (int i = tid; i < N; i += nt) {
      S.vc(0, jj, N)[i] *= scale;
      S.vc(1, jj, N)[i] *= scale;
      S.vc(2, jj, N)[i] *= scale;
    }
  }
}

template <int J, bool SAMPLE>
__global__ void __launch_bounds__(512, J == 2 ? 2 : 1) k1m_run_kernel(K1Args A) {
  extern __shared__ float4 k1m_sm[];
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x;
  const int job0 = blockIdx.x * J;
  const K1mSmem<J> S = k1m_carve<J>(k1m_sm, N, A.T);
  const float* __restrict__ invm = A.invm;
  const float* __restrict__ mftm = A.mftm;
  const int deform = A.deform;
  int n_run[J];
  float dt[J];
  int n_max = 0;
  unsigned live = 0;
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    n_run[jj] = A.n_run[job0 + jj];
    dt[jj] = A.fscal[(size_t)(job0 + jj) * FSCAL + F_DT];
    n_max = n_run[jj] > n_max ? n_run[jj] : n_max;
    if (n_run[jj] > 0)
      live |= 1u << jj;
    else if (tid < 6)
      A.press[(job0 + jj) * 6 + tid] = 0.f;
  }
  if (n_max <= 0) return;
  // every job slot carries the codes (the pair loop reads job 0's); only
  // the live jobs load their state
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    const bool ld = (live >> jj) & 1u;
    const float* st = A.state + (size_t)(job0 + jj) * 6 * N;
    for (int i = tid; i < N; i += nt) {
      const float c = __int_as_float(A.code[i]);
      S.p4[jj * N + i] = ld ? make_float4(st[i], st[N + i], st[2 * N + i], c)
                            : make_float4(0.f, 0.f, 0.f, c);
      if (ld) {
        S.vc(0, jj, N)[i] = st[3 * N + i];
        S.vc(1, jj, N)[i] = st[4 * N + i];
        S.vc(2, jj, N)[i] = st[5 * N + i];
      }
    }
    if (ld && tid < NHC) S.misc[jj * K1M_MISC + tid] = A.vxi[(job0 + jj) * NHC + tid];
  }
  for (int t = tid; t < A.T * A.T; t += nt) S.tbl[t] = make_float2(A.tbl[2 * t], A.tbl[2 * t + 1]);
  __syncthreads();

  float w[J][6], pacc[J][6];
  Box h[J];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    for (int k = 0; k < 6; ++k) w[jj][k] = pacc[jj][k] = 0.f;
    h[jj] = k1m_box(A.fscal + (size_t)(job0 + jj) * FSCAL, false, 0.f);
  }
  k1m_forces<J, false>(A, S, h, live, w);
  for (int s = 0; s < n_max; ++s) {
    unsigned act = 0;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      if (s >= n_run[jj]) continue;
      act |= 1u << jj;
      h[jj] = k1m_box(A.fscal + (size_t)(job0 + jj) * FSCAL, deform != 0,
                      (float)s / (float)n_run[jj]);
    }
    k1m_nhc<J>(A, S, mftm, dt, act, job0);
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (!((act >> jj) & 1u)) continue;
        const float half = 0.5f * dt[jj];
        float* vx = S.vc(0, jj, N);
        float* vy = S.vc(1, jj, N);
        float* vz = S.vc(2, jj, N);
        vx[i] += half * S.fc(0, jj, N)[i] * im;
        vy[i] += half * S.fc(1, jj, N)[i] * im;
        vz[i] += half * S.fc(2, jj, N)[i] * im;
        float4 p = S.p4[jj * N + i];
        p.x += dt[jj] * vx[i];
        p.y += dt[jj] * vy[i];
        p.z += dt[jj] * vz[i];
        S.p4[jj * N + i] = p;
      }
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      for (int k = 0; k < 6; ++k) w[jj][k] = 0.f;
    k1m_forces<J, SAMPLE>(A, S, h, act, w);
    for (int i = tid; i < N; i += nt) {
      const float im = invm[i];
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (!((act >> jj) & 1u)) continue;
        const float half = 0.5f * dt[jj];
        S.vc(0, jj, N)[i] += half * S.fc(0, jj, N)[i] * im;
        S.vc(1, jj, N)[i] += half * S.fc(1, jj, N)[i] * im;
        S.vc(2, jj, N)[i] += half * S.fc(2, jj, N)[i] * im;
      }
    }
    k1m_nhc<J>(A, S, mftm, dt, act, job0);
    if constexpr (SAMPLE) {
      float r[K1M_RED * J];
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        for (int k = 0; k < 6; ++k) {
          r[K1M_RED * jj + k] = 0.f;
          r[K1M_RED * jj + 6 + k] = w[jj][k];
        }
      for (int i = tid; i < N; i += nt) {
        const float m = mftm[i];
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          if (!((act >> jj) & 1u)) continue;
          const float vx = S.vc(0, jj, N)[i], vy = S.vc(1, jj, N)[i], vz = S.vc(2, jj, N)[i];
          float* rj = r + K1M_RED * jj;
          rj[0] += m * vx * vx;
          rj[1] += m * vy * vy;
          rj[2] += m * vz * vz;
          rj[3] += m * vx * vy;
          rj[4] += m * vx * vz;
          rj[5] += m * vy * vz;
        }
      }
      k1m_sum<K1M_RED * J>(r, S.red);
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (!((act >> jj) & 1u)) continue;
        const float conv = A.nktv2p / (h[jj].lx * h[jj].ly * h[jj].lz);
        for (int k = 0; k < 6; ++k)
          pacc[jj][k] += (r[K1M_RED * jj + k] + r[K1M_RED * jj + 6 + k]) * conv;
      }
    }
    if (deform) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (!((act >> jj) & 1u)) continue;
        const Box& hb = h[jj];
        const Box hn = k1m_box(A.fscal + (size_t)(job0 + jj) * FSCAL, true,
                               (float)(s + 1) / (float)n_run[jj]);
        const float i00 = 1.f / hb.lx, i11 = 1.f / hb.ly, i22 = 1.f / hb.lz;
        const float i01 = -hb.xy / (hb.lx * hb.ly);
        const float i12 = -hb.yz / (hb.ly * hb.lz);
        const float i02 = (hb.xy * hb.yz - hb.xz * hb.ly) / (hb.lx * hb.ly * hb.lz);
        const float a00 = hn.lx * i00;
        const float a01 = hn.lx * i01 + hn.xy * i11;
        const float a02 = hn.lx * i02 + hn.xy * i12 + hn.xz * i22;
        const float a11 = hn.ly * i11;
        const float a12 = hn.ly * i12 + hn.yz * i22;
        const float a22 = hn.lz * i22;
        for (int i = tid; i < N; i += nt) {
          float4 p = S.p4[jj * N + i];
          const float x = p.x, y = p.y, z = p.z;
          p.x = a00 * x + a01 * y + a02 * z;
          p.y = a11 * y + a12 * z;
          p.z = a22 * z;
          S.p4[jj * N + i] = p;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    if (!((live >> jj) & 1u)) continue;
    const int job = job0 + jj;
    float* st = A.state + (size_t)job * 6 * N;
    for (int i = tid; i < N; i += nt) {
      const float4 p = S.p4[jj * N + i];
      st[i] = p.x; st[N + i] = p.y; st[2 * N + i] = p.z;
      st[3 * N + i] = S.vc(0, jj, N)[i];
      st[4 * N + i] = S.vc(1, jj, N)[i];
      st[5 * N + i] = S.vc(2, jj, N)[i];
    }
    if (tid < NHC) A.vxi[job * NHC + tid] = S.misc[jj * K1M_MISC + tid];
    for (int k = 0; k < 6; ++k)
      if (tid == k) A.press[job * 6 + k] = pacc[jj][k];
  }
}

template <int J>
bool k1m_args_ok(const K1Args* a) {
  if (a == nullptr || a->N <= 0 || a->B < 0 || a->B % J != 0 || a->T < 1 || a->T > K1_TYPE + 1)
    return false;
  if (k1m_smem<J>(a->N, a->T) > 232448) return false;
  return a->tbl && a->code && a->win && a->topo && a->invm && a->mftm && a->state && a->vxi &&
         a->press && a->n_run && a->fscal;
}

// the block width: one thread per atom up to the kernel's limit, as K1's
// (so that each job's strided rows and reductions are K1's)
template <int J, bool SAMPLE>
cudaError_t k1m_prepare(int N, int T, int* threads, size_t* bytes) {
  *bytes = k1m_smem<J>(N, T);
  return prepare(k1m_run_kernel<J, SAMPLE>, N, *bytes, threads);
}

template <int J, bool SAMPLE>
cudaError_t k1m_launch_kernel(const K1Args& A, cudaStream_t s) {
  int threads = 0;
  size_t bytes = 0;
  cudaError_t err = k1m_prepare<J, SAMPLE>(A.N, A.T, &threads, &bytes);
  if (err != cudaSuccess || A.B == 0) return err;
  k1m_run_kernel<J, SAMPLE><<<A.B / J, threads, bytes, s>>>(A);
  return cudaGetLastError();
}

template <int J>
cudaError_t k1m_launch(const K1Args& A, cudaStream_t s) {
  if (!k1m_args_ok<J>(&A)) return cudaErrorInvalidValue;
  return A.sample ? k1m_launch_kernel<J, true>(A, s) : k1m_launch_kernel<J, false>(A, s);
}

// out[4] of the J-job deform-run kernel (sample = 0) or sampling kernel
template <int J, bool SAMPLE>
cudaError_t k1m_info(int N, int T, int* out) {
  int threads = 0;
  size_t bytes = 0;
  cudaError_t err = k1m_prepare<J, SAMPLE>(N, T, &threads, &bytes);
  return err != cudaSuccess ? err : kernel_info(k1m_run_kernel<J, SAMPLE>, threads, bytes, out);
}

}  // namespace

// K1's flag set only (md_fused.check_multi), J = 2 or 4 jobs per block, B a
// multiple of J; the argument structure (K1Args) has internal linkage, so
// the entry takes it untyped
extern "C" int md_k1m_run_f32(const void* args, int jobs, void* stream) {
  const K1Args* a = static_cast<const K1Args*>(args);
  if (a == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (jobs) {
    case 2: return (int)k1m_launch<2>(*a, s);
    case 4: return (int)k1m_launch<4>(*a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[4] = (registers, local bytes, blocks per SM, threads) of the J-job
// deform-run kernel (sample 0) or sampling kernel (1) at N atoms of T types
extern "C" int md_k1m_info(int jobs, int sample, int N, int T, int* out) {
  if (out == nullptr || N <= 0 || T < 1) return (int)cudaErrorInvalidValue;
  switch (jobs * 2 + (sample != 0)) {
    case 4: return (int)k1m_info<2, false>(N, T, out);
    case 5: return (int)k1m_info<2, true>(N, T, out);
    case 8: return (int)k1m_info<4, false>(N, T, out);
    case 9: return (int)k1m_info<4, true>(N, T, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
