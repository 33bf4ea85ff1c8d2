// P1's first design: the slim all-pairs LJ run of the kernel lab, variants
// v1-v8, exported for ops/md_slim.py (slim_run_first).  It ported the TPU
// kernel of scripts/probe_allpairs.py (run_slim -> make_slim_kernel, the
// pl.pallas_call at :616) and stays as the A/B partner of its Hopper
// redesign, md_slim_ring.cu (slim_run); the shared code is md_slim.cuh.
//
// One thread block per program.  A program runs n_run steps of J boxes of N
// atoms (J = 1 but for v7, v7d4, v7p) that share one NHC-3 chain: NHC
// half-step, half-kick, drift, all-pairs LJ forces, half-kick, NHC
// half-step, the fix-deform remap from h(g) to h(g + 1).  Positions,
// velocities, forces, 1/m and m of all J N atoms live in shared memory for
// the whole run (11 J N floats: 22.5 KB at N = 512, 90 KB at J = 4); the
// chain and its 2 KE sums are block reductions in a fixed order, advanced by
// thread 0 exactly as the lab's nhc_half.
//
// What bounds it on an H100: the pair loop, N^2 ordered pairs per box and
// step (N(N - 1)/2 with Newton halving), ~30 FLOP each, about a quarter of
// them inside the 10 A cutoff on the g0 box.  The function itself moves a
// few MB (the state, two 1 MB planes), so the bound is the operations.
//
// Each variant is one instance of md_slim_kernel and stays the design it
// names (the lab's TPU mechanism -> its counterpart here):
//   v1    per-pair sequential triclinic minimum image (rintf, half to even
//         like jnp.round) at every step; each thread sums its atom's full
//         row, planes read as plane[j N + i] (coalesced, the planes are
//         symmetric) only for a live pair.  K1's structure.
//   v2-v4 the TPU kept (n1, n2, n3) per pair in VMEM; here an int8 image
//         cache in device memory, one char4 per pair slot (1 MB per job at
//         N = 512; 604 MB for 576 jobs), refreshed at every 20-step chunk
//         start (and before the first force call: the lab reads it before
//         writing it, ROADMAP §3), read coalesced in the row order of the
//         loop.  Positions are never wrapped, so |n| grows as atoms drift:
//         an image beyond int8 marks the program and its positions come
//         back NaN.  v3 drops the r2 > R2MIN test and keeps the x6 in the
//         plane; v4 reads sig2 from an argument instead of the plane.
//   v5, v5p, v5r  Newton halving: the TPU took the blocks u >= t of 128 x
//         128 tiles and added the reaction transposed (XLU); here the half
//         shell: thread i takes j = i + d mod N for d = 1 .. N/2 (the pair
//         at d = N/2 once), its own force in registers and the reaction
//         through a shared-memory atomicAdd (distinct addresses across the
//         warp at each d).  Planes and images in the same (d - 1, i) slot
//         layout, reordered once per call on the host: half the cache.
//         v5p/v5r: the lj1/lj2 form; v5r takes 1/r^2 from rsqrtf.
//   v5m   the TPU accumulated the reaction untransposed and reduced it once
//         per tile by an MXU matvec; here per-warp partials: each warp adds
//         its reactions to its own 3 J N rows of shared memory (no atomics,
//         __syncwarp between shell steps), reduced once per force call in
//         warp order (deterministic).
//   v7, v7d4, v7p  J boxes per block (1024 threads, 64 registers), the
//         v5/v5p pair loop within each box, one chain over all of them.
//   v8    the TPU reduced each block's reaction by an MXU matvec; here 32 x
//         32 tile pairs (a <= b) dealt to warps: lane l holds atom i of tile
//         a and one atom j of tile b with the reaction accumulated for it,
//         and j with its reaction rotates one lane per step by shuffles, so
//         after 32 steps each lane adds one reaction per tile pair (the
//         diagonal tile pair in full, no reaction).  Planes and images in
//         the (tile pair, step, lane) slot layout.
#include "md_slim.cuh"

namespace {

struct Sm {
  float *px, *py, *pz, *vx, *vy, *vz, *fx, *fy, *fz, *invm, *mftm;
  float* red;   // MAXW reduction scratch
  float* misc;  // MISC
  float* R;     // v5m: per-warp reaction rows, 3 M each
};

__device__ __forceinline__ Sm carve(float* sm, int M) {
  Sm s;
  float* p[11];
  for (int k = 0; k < 11; ++k) p[k] = sm + (size_t)k * M;
  s.px = p[0]; s.py = p[1]; s.pz = p[2]; s.vx = p[3]; s.vy = p[4]; s.vz = p[5];
  s.fx = p[6]; s.fy = p[7]; s.fz = p[8]; s.invm = p[9]; s.mftm = p[10];
  s.red = sm + (size_t)11 * M;
  s.misc = s.red + MAXW;
  s.R = s.misc + MISC;
  return s;
}

// F/r of one pair at r^2 (0 for a dead pair); the planes are read at slot o
// only for a live pair
template <bool TRIM, bool UNISIG, int FORM>
__device__ __forceinline__ float fpair(const SlimArgs& A, float r2, size_t o) {
  const bool live = TRIM ? r2 < A.cutoff2 : (r2 < A.cutoff2 && r2 > A.r2min);
  if (!live) return 0.f;
  const float r2c = fmaxf(r2, A.r2min);
  const float a = __ldg(A.w4e + o);
  if constexpr (FORM == SIG) {
    const float inv = 1.f / r2c;
    const float s2 = (UNISIG ? A.sig2u : __ldg(A.sig2 + o)) * inv;
    const float s6 = s2 * s2 * s2;
    const float f = a * (2.f * s6 * s6 - s6) * inv;
    return TRIM ? f : 6.f * f;
  } else {
    float inv;
    if constexpr (FORM == RSQRT) {
      const float ir = rsqrtf(r2c);
      inv = ir * ir;
    } else {
      inv = 1.f / r2c;
    }
    const float u2 = inv * inv, u3 = u2 * inv;
    return (a * u3 - __ldg(A.sig2 + o)) * u2 * u2;
  }
}

// Store every pair's images for box h at the current positions: the slots
// of all J jobs dealt over the block (coalesced stores).  Exit is
// block-synced.
template <int NEWTON>
__device__ void refresh(const SlimArgs& A, const Sm& S, char4* img, const Box& h, int J) {
  const int N = A.N, slots = slots_per_job<NEWTON>(N);
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  bool over = false;
  for (int s = threadIdx.x; s < J * slots; s += blockDim.x) {
    const int job = s / slots, o = s - job * slots;
    int i, j;
    char4 n = make_char4(0, 0, 0, 0);
    if (slot_pair<NEWTON>(o, N, i, j)) {
      const int a = job * N + i, b = job * N + j;
      n = images(h, ilx, ily, ilz, S.px[b] - S.px[a], S.py[b] - S.py[a], S.pz[b] - S.pz[a],
                 over);
    }
    img[s] = n;
  }
  if (over) S.misc[NHC + 1] = 1.f;
  __syncthreads();
}

// v1-v4: each thread sums its atom's full row.  Exit is block-synced.
template <bool CACHE, bool TRIM, bool UNISIG, int FORM>
__device__ void forces_full(const SlimArgs& A, const Sm& S, const char4* img, const Box& h,
                            int M) {
  const int N = A.N;
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  for (int a = threadIdx.x; a < M; a += blockDim.x) {
    const int job = a / N, i = a - job * N, base = job * N;
    const float xi = S.px[a], yi = S.py[a], zi = S.pz[a];
    const char4* im = CACHE ? img + (size_t)job * N * N + i : nullptr;
    float fx = 0.f, fy = 0.f, fz = 0.f;
    for (int jl = 0; jl < N; ++jl) {
      const int b = base + jl;
      float dx = S.px[b] - xi, dy = S.py[b] - yi, dz = S.pz[b] - zi;
      float r2;
      if constexpr (CACHE)
        r2 = disp_cached(h, im[(size_t)jl * N], dx, dy, dz);
      else
        r2 = min_image(h, ilx, ily, ilz, dx, dy, dz);
      const float fp = fpair<TRIM, UNISIG, FORM>(A, r2, (size_t)jl * N + i);
      if constexpr (TRIM) {  // one accumulator, negated once (forces_cached)
        fx += fp * dx;
        fy += fp * dy;
        fz += fp * dz;
      } else {
        fx -= fp * dx;
        fy -= fp * dy;
        fz -= fp * dz;
      }
    }
    S.fx[a] = TRIM ? -fx : fx;
    S.fy[a] = TRIM ? -fy : fy;
    S.fz[a] = TRIM ? -fz : fz;
  }
  __syncthreads();
}

// v5, v5p, v5r, v7, v7d4, v7p (ATOMIC) and v5m (PARTIALS): the half shell
// j = i + d mod N, d = 1 .. N/2, each unordered pair once.  Exit is
// block-synced.
template <bool TRIM, bool UNISIG, int FORM, int NEWTON>
__device__ void forces_half(const SlimArgs& A, const Sm& S, const char4* img, const Box& h,
                            int M) {
  const int N = A.N, half = N / 2, tid = threadIdx.x, nt = blockDim.x;
  const int nw = nt >> 5;
  float* R = S.R + (size_t)(tid >> 5) * 3 * M;  // PARTIALS: this warp's rows
  if constexpr (NEWTON == PARTIALS) {
    for (int k = tid; k < nw * 3 * M; k += nt) S.R[k] = 0.f;
  } else {
    for (int a = tid; a < M; a += nt) S.fx[a] = S.fy[a] = S.fz[a] = 0.f;
  }
  __syncthreads();
  // M and the block width are multiples of 32: a warp leaves the loop whole
  for (int a = tid; a < M; a += nt) {
    const int job = a / N, i = a - job * N, base = job * N;
    const float xi = S.px[a], yi = S.py[a], zi = S.pz[a];
    const char4* im = img + (size_t)job * half * N;
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int d = 1; d <= half; ++d) {
      int jl = i + d;
      if (jl >= N) jl -= N;
      const int b = base + jl;
      const size_t o = (size_t)(d - 1) * N + i;
      float dx = 0.f, dy = 0.f, dz = 0.f, fp = 0.f;
      if (2 * d != N || 2 * i < N) {  // the pair at d = N/2 once
        dx = S.px[b] - xi;
        dy = S.py[b] - yi;
        dz = S.pz[b] - zi;
        const float r2 = disp_cached(h, im[o], dx, dy, dz);
        fp = fpair<TRIM, UNISIG, FORM>(A, r2, o);
      }
      if (fp != 0.f) {
        const float wx = fp * dx, wy = fp * dy, wz = fp * dz;
        ax += wx;
        ay += wy;
        az += wz;
        if constexpr (NEWTON == PARTIALS) {
          R[b] += wx;
          R[M + b] += wy;
          R[2 * M + b] += wz;
        } else {
          atomicAdd(S.fx + b, wx);
          atomicAdd(S.fy + b, wy);
          atomicAdd(S.fz + b, wz);
        }
      }
      if constexpr (NEWTON == PARTIALS) __syncwarp();
    }
    if constexpr (NEWTON == PARTIALS) {
      S.fx[a] = -ax;
      S.fy[a] = -ay;
      S.fz[a] = -az;
    } else {
      atomicAdd(S.fx + a, -ax);
      atomicAdd(S.fy + a, -ay);
      atomicAdd(S.fz + a, -az);
    }
  }
  __syncthreads();
  if constexpr (NEWTON == PARTIALS) {  // one reduction of the partials, warp order
    for (int a = tid; a < M; a += nt) {
      float sx = 0.f, sy = 0.f, sz = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float* Rw = S.R + (size_t)w * 3 * M;
        sx += Rw[a];
        sy += Rw[M + a];
        sz += Rw[2 * M + a];
      }
      S.fx[a] += sx;
      S.fy[a] += sy;
      S.fz[a] += sz;
    }
    __syncthreads();
  }
}

// v8: 32 x 32 tile pairs dealt to warps, j and its reaction rotating by
// shuffles.  Exit is block-synced.
template <bool TRIM, bool UNISIG, int FORM>
__device__ void forces_shuffle(const SlimArgs& A, const Sm& S, const char4* img, const Box& h,
                               int M, int J) {
  const int N = A.N, T = N / TILE, TP = T * (T + 1) / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  for (int a = tid; a < M; a += blockDim.x) S.fx[a] = S.fy[a] = S.fz[a] = 0.f;
  __syncthreads();
  for (int qg = warp; qg < J * TP; qg += nw) {
    const int job = qg / TP, q = qg - job * TP;
    int ta, tb;
    tile_pair(q, T, ta, tb);
    const int a = job * N + ta * TILE + lane, b = job * N + tb * TILE + lane;
    const float xi = S.px[a], yi = S.py[a], zi = S.pz[a];
    float xj = S.px[b], yj = S.py[b], zj = S.pz[b];
    float ax = 0.f, ay = 0.f, az = 0.f, rx = 0.f, ry = 0.f, rz = 0.f;
    const size_t o0 = (size_t)q * TILE * TILE + lane;
    const char4* im = img + (size_t)job * TP * TILE * TILE + o0;
    const int src = (lane + 1) & 31;
    for (int k = 0; k < TILE; ++k) {
      float dx = xj - xi, dy = yj - yi, dz = zj - zi;
      const float r2 = disp_cached(h, im[k * TILE], dx, dy, dz);
      const float fp = fpair<TRIM, UNISIG, FORM>(A, r2, o0 + k * TILE);
      const float wx = fp * dx, wy = fp * dy, wz = fp * dz;
      ax += wx;
      ay += wy;
      az += wz;
      rx += wx;
      ry += wy;
      rz += wz;
      xj = __shfl_sync(0xffffffffu, xj, src);
      yj = __shfl_sync(0xffffffffu, yj, src);
      zj = __shfl_sync(0xffffffffu, zj, src);
      rx = __shfl_sync(0xffffffffu, rx, src);
      ry = __shfl_sync(0xffffffffu, ry, src);
      rz = __shfl_sync(0xffffffffu, rz, src);
    }
    atomicAdd(S.fx + a, -ax);
    atomicAdd(S.fy + a, -ay);
    atomicAdd(S.fz + a, -az);
    if (ta != tb) {  // back at its own lane after 32 rotations
      atomicAdd(S.fx + b, rx);
      atomicAdd(S.fy + b, ry);
      atomicAdd(S.fz + b, rz);
    }
  }
  __syncthreads();
}

template <bool CACHE, bool TRIM, bool UNISIG, int FORM, int NEWTON, int J>
__device__ __forceinline__ void forces(const SlimArgs& A, const Sm& S, const char4* img,
                                       const Box& h) {
  const int M = J * A.N;
  if constexpr (NEWTON == FULL)
    forces_full<CACHE, TRIM, UNISIG, FORM>(A, S, img, h, M);
  else if constexpr (NEWTON == SHUFFLE)
    forces_shuffle<TRIM, UNISIG, FORM>(A, S, img, h, M, J);
  else
    forces_half<TRIM, UNISIG, FORM, NEWTON>(A, S, img, h, M);
}

// __launch_bounds__: one box per block runs 512 threads and asks for two
// blocks per SM, J boxes run 1024 threads and one block: 64 registers and
// 32 resident warps per SM for every variant, so the levers are compared at
// one occupancy (v5m's per-warp partials, 98 KB at N = 512, hold it to one
// block per SM whatever its registers; md_slim_occupancy reports it).
template <bool CACHE, bool TRIM, bool UNISIG, int FORM, int NEWTON, int J>
__global__ void __launch_bounds__(J == 1 ? 512 : 1024, J == 1 ? 2 : 1)
    md_slim_kernel(SlimArgs A) {
  extern __shared__ float sm[];
  const int prog = blockIdx.x, N = A.N, M = J * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Sm S = carve(sm, M);
  const float* st = A.state + (size_t)prog * 8 * M;
  for (int a = tid; a < M; a += nt) {
    S.px[a] = st[a]; S.py[a] = st[M + a]; S.pz[a] = st[2 * M + a];
    S.vx[a] = st[3 * M + a]; S.vy[a] = st[4 * M + a]; S.vz[a] = st[5 * M + a];
    S.invm[a] = st[6 * M + a]; S.mftm[a] = st[7 * M + a];
  }
  const float* fs = A.fscal + (size_t)prog * FS;
  const int n_run = A.iscal[prog * IS], n_tot = A.iscal[prog * IS + 1];
  if (tid < NHC) S.misc[tid] = fs[14 + tid];
  if (tid == 0) S.misc[NHC + 1] = 0.f;
  const float dt = fs[0], kt = A.boltz * fs[1];
  float h0[6], eps[6];
  for (int k = 0; k < 6; ++k) {
    h0[k] = fs[2 + k];
    eps[k] = fs[8 + k];
  }
  char4* img = CACHE ? A.img + (size_t)prog * J * slots_per_job<NEWTON>(N) : nullptr;
  const float ntot = (float)n_tot;
  __syncthreads();
  if (n_run > 0) {
    Box h = h_at(h0, eps, 0.f / ntot);
    if constexpr (CACHE) refresh<NEWTON>(A, S, img, h, J);
    forces<CACHE, TRIM, UNISIG, FORM, NEWTON, J>(A, S, img, h);
    for (int s = 0; s < n_run; ++s) {
      h = h_at(h0, eps, (float)s / ntot);
      if constexpr (CACHE) {
        if (s > 0 && s % R_REFRESH == 0) refresh<NEWTON>(A, S, img, h, J);
      }
      nhc_half(S.vx, S.vy, S.vz, S.mftm, S.red, S.misc, M, dt, kt, A.ndof, A.tdamp);
      const float half = 0.5f * dt;
      for (int a = tid; a < M; a += nt) {
        const float im = S.invm[a];
        S.vx[a] = S.vx[a] + half * S.fx[a] * im;
        S.vy[a] = S.vy[a] + half * S.fy[a] * im;
        S.vz[a] = S.vz[a] + half * S.fz[a] * im;
        S.px[a] += dt * S.vx[a];
        S.py[a] += dt * S.vy[a];
        S.pz[a] += dt * S.vz[a];
      }
      __syncthreads();
      forces<CACHE, TRIM, UNISIG, FORM, NEWTON, J>(A, S, img, h);
      for (int a = tid; a < M; a += nt) {
        const float im = S.invm[a];
        S.vx[a] = S.vx[a] + half * S.fx[a] * im;
        S.vy[a] = S.vy[a] + half * S.fy[a] * im;
        S.vz[a] = S.vz[a] + half * S.fz[a] * im;
      }
      nhc_half(S.vx, S.vy, S.vz, S.mftm, S.red, S.misc, M, dt, kt, A.ndof, A.tdamp);
      const Remap r = remap(h, h_at(h0, eps, (float)(s + 1) / ntot));
      for (int a = tid; a < M; a += nt) {
        const float x = S.px[a], y = S.py[a], z = S.pz[a];
        S.px[a] = r.a00 * x + r.a01 * y + r.a02 * z;
        S.py[a] = r.a11 * y + r.a12 * z;
        S.pz[a] = r.a22 * z;
      }
      __syncthreads();
    }
  }
  const bool bad = S.misc[NHC + 1] != 0.f;  // an image beyond int8
  float* o = A.out + (size_t)prog * 8 * M;
  float ke = 0.f;
  for (int a = tid; a < M; a += nt) {
    o[a] = bad ? nanf("") : S.px[a];
    o[M + a] = bad ? nanf("") : S.py[a];
    o[2 * M + a] = bad ? nanf("") : S.pz[a];
    o[3 * M + a] = S.vx[a]; o[4 * M + a] = S.vy[a]; o[5 * M + a] = S.vz[a];
    o[6 * M + a] = S.invm[a]; o[7 * M + a] = S.mftm[a];
    ke += S.mftm[a] * (S.vx[a] * S.vx[a] + S.vy[a] * S.vy[a] + S.vz[a] * S.vz[a]);
  }
  ke = block_sum(ke, S.red);
  float* sacc = A.sacc + (size_t)prog * SACC;
  if (tid < NHC) sacc[tid] = S.misc[tid];
  if (tid == NHC) sacc[NHC] = ke;
  if (tid > NHC && tid < SACC) sacc[tid] = 0.f;
}

#define SLIM_KERNEL(V) md_slim_kernel<V::CACHE, V::TRIM, V::UNISIG, V::FORM, V::NEWTON, V::J>

// Block width and shared memory of the variant at N atoms per box; opts the
// kernel into more than 48 KB of shared memory where it needs it.
template <class V>
cudaError_t block_shape(int N, int& threads, size_t& bytes) {
  const int M = V::J * N;
  const int cap = V::J == 1 ? 512 : 1024;
  threads = ((M + 31) / 32) * 32 < cap ? ((M + 31) / 32) * 32 : cap;
  size_t floats = (size_t)11 * M + MAXW + MISC;
  if (V::NEWTON == PARTIALS) floats += (size_t)(threads / 32) * 3 * M;
  bytes = floats * sizeof(float);
  auto kernel = SLIM_KERNEL(V);
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

template <class V>
cudaError_t launch(const SlimArgs& A, cudaStream_t stream) {
  if (A.J != V::J || (V::CACHE && A.img == nullptr)) return cudaErrorInvalidValue;
  int threads;
  size_t bytes;
  cudaError_t err = block_shape<V>(A.N, threads, bytes);
  if (err != cudaSuccess) return err;
  auto kernel = SLIM_KERNEL(V);
  kernel<<<A.P, threads, bytes, stream>>>(A);
  return cudaGetLastError();
}

template <class V>
cudaError_t occupancy(int N, int* blocks) {
  int threads;
  size_t bytes;
  cudaError_t err = block_shape<V>(N, threads, bytes);
  if (err != cudaSuccess) return err;
  auto kernel = SLIM_KERNEL(V);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, bytes);
}

}  // namespace

extern "C" int md_slim_run_f32(const void* args, int variant, void* stream) {
  const SlimArgs* a = static_cast<const SlimArgs*>(args);
  if (a == nullptr || a->P <= 0 || a->N <= 0 || a->N % 128 != 0 || !a->state || !a->out ||
      !a->sacc || !a->w4e || !a->sig2 || !a->iscal || !a->fscal)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_variant(variant, [&](auto v) { return launch<decltype(v)>(*a, s); });
}

// Resident blocks per SM of the variant's kernel at N atoms per box (its
// registers, block width and shared memory), into *blocks.
extern "C" int md_slim_occupancy(int variant, int N, int* blocks) {
  if (blocks == nullptr || N <= 0 || N % 128 != 0) return (int)cudaErrorInvalidValue;
  return (int)by_variant(variant, [&](auto v) { return occupancy<decltype(v)>(N, blocks); });
}
