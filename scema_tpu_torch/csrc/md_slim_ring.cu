// P1 redesigned for Hopper: the slim all-pairs LJ run of the kernel lab,
// variants v1-v8, exported for ops/md_slim.py (slim_run).  Replaces the TPU
// kernel of scripts/probe_allpairs.py:616 (run_slim -> make_slim_kernel);
// its first design, md_slim.cu, stays as the A/B partner (slim_run_first),
// and both include md_slim.cuh, so they run the same arithmetic.
//
// The function is the first design's, variant for variant: one block per
// program (J boxes for v7, v7d4, v7p) and the whole run in one launch; NHC-3,
// Verlet and the fix-deform remap; the int8 images n = -round(.) refreshed
// before the first force call and every R_REFRESH steps, an image beyond
// +-127 turning the program's positions NaN; v3+'s trims, v4's uniform
// sigma^2, the sig/lj/rsqrt forms and the four pair schedules (full rows,
// the half shell with shared atomics, v5m's per-warp partials in warp
// order, v8's shuffles).  The planes stay inputs in the variant's slot
// layout (ops/md_slim.layout_pairs), one copy for every program.
//
// What bounds it on an H100: the operations of the pair loop (~30 FLOP per
// pair, N^2 or N(N - 1)/2 pairs per box and step, a quarter of them live on
// the g0 box); the function moves a few MB.  The first design reached 3-8%
// of that bound because its pair loop waited on memory: each live pair read
// its plane values from L2 (__ldg, ~2 MB per job and step, in the chain of
// the iteration) and each cached variant one char4 per slot from its
// program's image cache in device memory (1 MB per job and step on full
// rows, 604 MB per step at 576 jobs), loads that the loop never kept in
// flight; and three shared loads per j for the positions.
//
// The levers of this design, each timed on its own on the card before the
// next (PERF.md's P1 findings; ops/md_slim.ring_layout mirrors the layout):
//   (a) float4 positions (x, y, z, 1/m) in shared memory: one 16-byte
//       broadcast per j (v8: per lane) in place of three loads.  Velocities
//       and masses stay in their thread's registers (one atom per thread,
//       two for v7d4), and so do full rows' forces: only the positions, the
//       forces that other threads add to and the ring live in shared memory.
//   (b) the full-row and half-shell schedules: a ring of `depth` stages in
//       shared memory, each 8 consecutive layout rows (j for full rows,
//       d - 1 for the half shell) of every plane the variant reads and of
//       the images of the jobs the block is walking.  One thread fills a
//       stage with one 1-D bulk copy per array
//       (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes)
//       on the stage's "full" mbarrier.  Each warp, done with a stage, adds
//       one to the stage's release count in shared memory, and the warp whose
//       add completes the count refills the stage at once: no warp waits for
//       another (an "empty" mbarrier that thread 0 waited on before each
//       refill held the block in lockstep and ran v1 slower than the first
//       design).  No __syncthreads per slab: warps drift by up to the depth.
//       The pair loop reads planes and images from shared memory only.
//       Each stage boundary costs a thread ~100 instructions (the wait, the
//       release, the cursor), against ~55 per pair, so the rows per stage
//       are a compile-time 8 (the loop unrolls) and the state moved to
//       registers to make room for them at two blocks per SM.
//       A box of J N > 1024 atoms (v7d4 at N = 512) is walked in groups of
//       whole jobs, so a stage holds the images of one group's jobs.
//   (c) v8: its warps each walk their own 32 x 32 tile pairs, so each warp
//       keeps its own ring: lane 0 bulk-copies 4 shuffle steps of its tile
//       pair's slots per stage on the warp's own mbarrier and refills a
//       stage after a __syncwarp.
//   (d) the refresh writes four slots (16 bytes) per thread, then a
//       fence.proxy.async orders those writes before the bulk copies that
//       read them.
// Each variant has two instances, with every lever: md_slim_ring_kernel
// for N <= SMALL_N = 512 atoms per box (levers (a)-(d) as above), and
// md_slim_big_kernel from 640 up to the variant's n_max (5248 atoms per box
// for one box, 2176 for v5m, 2560 for J = 2, 1280 for J = 4), whose notes
// are at its code: velocities in device memory, column-tiled stages of 4
// rows, v5m's per-warp window.
//
// Bits: full rows keep each thread's order of the sum over j in both
// instances, and v5m in the first, so v1-v4 (every N) and v5m (N <= 512)
// give the first design's bits; the shared atomics of v5, v5p, v5r, v7,
// v7d4, v7p and v8, and of v5m's windows above 512, add in an order that
// changes from run to run.
#include <stdint.h>

#include "md_slim.cuh"

namespace {

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a Hopper block can opt into
constexpr int INFO = 14;          // ints md_slim_ring_info writes

// Layout rows per stage of the block ring, 8, and v8's shuffle steps per
// stage of a warp's ring, 4: fixed per instance so the row loop unrolls
// (ops/md_slim.ring_rows)
template <class V>
__host__ __device__ constexpr int ring_rows() {
  return V::NEWTON == SHUFFLE ? 4 : 8;
}

// Atoms per thread of the instance for N <= SMALL_N: each thread keeps its
// atoms' velocities and masses in registers (two atoms for v7d4's 4 N >
// 1024, else one), so that instance runs at most 512 atoms per box for every
// J; the big-box instance keeps them in device memory
template <class V>
__host__ __device__ constexpr int atoms_per_thread() {
  return V::J == 4 ? 2 : 1;
}

// mirrored field for field by ops/md_slim._RingArgs
struct RingArgs {
  SlimArgs a;
  int depth;  // stages of the ring (v8: of each warp's ring)
};

// The block's shared memory, mirrored by ops/md_slim.ring_layout.  The
// instance for N <= SMALL_N (512 atoms per box, every J): float4 positions
// (x, y, z, 1/m), the ring, the forces (but for full rows, whose forces stay
// in their thread's registers), the reduction scratch and chain, v5m's
// per-warp partials, the mbarriers and the block ring's release counts;
// velocities and masses stay in registers.  The big-box instance
// (big_layout): the same with the forces of every schedule in shared memory,
// v5m's per-warp windows in place of its partials, and column-tiled stages.
struct Layout {
  int threads, warps;
  int jg, groups;  // jobs walked at once, groups of them
  int chunks;      // stages per group (v8: per tile pair)
  int arrays;      // bulk copies per stage (big-box instance: per stage row)
  int rows;        // layout rows per stage (v8: shuffle steps), ring_rows
  int bars;
  size_t stage, ring, flt, part, bar, bytes;
  bool ok;
  int cols, tiles;  // big-box instance: columns per stage, column tiles per job
};

template <class V>
__host__ __device__ Layout ring_layout(int N, int depth) {
  Layout L{};
  const int M = V::J * N, cap = V::J == 1 ? 512 : 1024;
  L.threads = M < cap ? M : cap;
  L.warps = L.threads / 32;
  L.rows = ring_rows<V>();
  L.ok = N > 0 && N % 128 == 0 && N <= L.threads && M <= atoms_per_thread<V>() * L.threads &&
         depth > 0;
  if (!L.ok) return L;
  const int planes = V::UNISIG ? 1 : 2;
  if (V::NEWTON == SHUFFLE) {
    L.jg = V::J;
    L.groups = 1;
    L.arrays = planes + (V::CACHE ? 1 : 0);
    L.chunks = TILE / L.rows;
    L.stage = (size_t)L.arrays * L.rows * TILE * 4;
    L.ring = (size_t)L.warps * depth * L.stage;
    L.bars = L.warps * depth;
  } else {
    L.jg = V::J < L.threads / N ? V::J : L.threads / N;
    L.groups = V::J / L.jg;
    const int R = V::NEWTON == FULL ? N : N / 2;
    L.ok = V::J % L.jg == 0 && R % L.rows == 0;
    L.arrays = planes + (V::CACHE ? L.jg : 0);
    L.chunks = R / L.rows;
    L.stage = (size_t)L.arrays * L.rows * N * 4;
    L.ring = (size_t)depth * L.stage;
    L.bars = depth;
  }
  L.flt = (size_t)16 * M + L.ring;
  L.part = L.flt + 4 * ((size_t)(V::NEWTON == FULL ? 0 : 3) * M + MAXW + MISC);
  L.bar = L.part + (V::NEWTON == PARTIALS ? (size_t)4 * L.warps * 3 * M : 0);
  L.bar = (L.bar + 7) / 8 * 8;
  L.bytes = L.bar + (size_t)8 * L.bars;
  if (V::NEWTON != SHUFFLE) L.bytes += (size_t)4 * depth;  // release counts
  L.ok = L.ok && L.bytes <= (size_t)SMEM_MAX;
  return L;
}

struct St {
  float4* p4;  // (x, y, z, 1/m)
  float *fx, *fy, *fz;  // not for full rows
  float* red;   // MAXW reduction scratch
  float* misc;  // MISC
  float* R;     // v5m: per-warp reaction rows, 3 M each
  unsigned char* ring;
  uint64_t* bar;  // block ring: full[depth]; v8: full[warps][depth]
  int* cnt;       // block ring: warps that released each stage, cumulative
};

template <class V>
__device__ __forceinline__ St carve(unsigned char* sm, const Layout& L, int M) {
  St s;
  s.p4 = reinterpret_cast<float4*>(sm);
  s.ring = sm + (size_t)16 * M;
  float* f = reinterpret_cast<float*>(sm + L.flt);
  const int nf = V::NEWTON == FULL ? 0 : M;
  s.fx = f;
  s.fy = f + nf;
  s.fz = f + 2 * nf;
  s.red = f + 3 * nf;
  s.misc = s.red + MAXW;
  s.R = reinterpret_cast<float*>(sm + L.part);
  s.bar = reinterpret_cast<uint64_t*>(sm + L.bar);
  s.cnt = reinterpret_cast<int*>(s.bar + L.bars);
  return s;
}

// A position in a ring: its stage, and how many times the ring has wrapped
// before it (the stage's use, whose parity the stage's mbarrier phase
// carries).  Advanced without division: the depth is a runtime value.
struct Cursor {
  int st;
  uint32_t wrap;
  __device__ __forceinline__ void next(int depth) {
    if (++st == depth) {
      st = 0;
      ++wrap;
    }
  }
  __device__ __forceinline__ int ahead(int k, int depth) const {  // the stage k uses on
    return st + k < depth ? st + k : st + k - depth;
  }
};

// ---- mbarriers and bulk copies (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

// arrive and expect `bytes` of bulk copies on this phase
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, completing on mbarrier b
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// ---- the pair arithmetic (the first design's, operand for operand)

// F/r of one pair at r^2 (0 for a dead pair); the plane values are read
// from the ring only for a live pair
template <class V>
__device__ __forceinline__ float fpair(const SlimArgs& A, float r2, const float* wp,
                                       const float* sp) {
  const bool live = V::TRIM ? r2 < A.cutoff2 : (r2 < A.cutoff2 && r2 > A.r2min);
  if (!live) return 0.f;
  const float r2c = fmaxf(r2, A.r2min);
  const float a = *wp;
  if constexpr (V::FORM == SIG) {
    const float inv = 1.f / r2c;
    const float s2 = (V::UNISIG ? A.sig2u : *sp) * inv;
    const float s6 = s2 * s2 * s2;
    const float f = a * (2.f * s6 * s6 - s6) * inv;
    return V::TRIM ? f : 6.f * f;
  } else {
    float inv;
    if constexpr (V::FORM == RSQRT) {
      const float ir = rsqrtf(r2c);
      inv = ir * ir;
    } else {
      inv = 1.f / r2c;
    }
    const float u2 = inv * inv, u3 = u2 * inv;
    return (a * u3 - *sp) * u2 * u2;
  }
}

// full rows: atom i's force from partner j
template <class V>
__device__ __forceinline__ void pair_full(const SlimArgs& A, const Box& h, float ilx, float ily,
                                          float ilz, float4 pj, float4 pi, const float* wp,
                                          const float* sp, const char4* ip, float& fx,
                                          float& fy, float& fz) {
  float dx = pj.x - pi.x, dy = pj.y - pi.y, dz = pj.z - pi.z;
  float r2;
  if constexpr (V::CACHE)
    r2 = disp_cached(h, *ip, dx, dy, dz);
  else
    r2 = min_image(h, ilx, ily, ilz, dx, dy, dz);
  const float fp = fpair<V>(A, r2, wp, sp);
  if constexpr (V::TRIM) {  // one accumulator, negated once (forces_cached)
    fx += fp * dx;
    fy += fp * dy;
    fz += fp * dz;
  } else {
    fx -= fp * dx;
    fy -= fp * dy;
    fz -= fp * dz;
  }
}

// the half shell: atom i and its partner i + d mod N, the reaction to the
// partner through a shared atomicAdd (ATOMIC) or the warp's partials
template <class V>
__device__ __forceinline__ void pair_half(const SlimArgs& A, const St& S, float* R, const Box& h,
                                          int M, int i, int base, int d, float4 pi,
                                          const float* wp, const float* sp, const char4* ip,
                                          float& ax, float& ay, float& az) {
  const int N = A.N;
  int jl = i + d;
  if (jl >= N) jl -= N;
  const int b = base + jl;
  float dx = 0.f, dy = 0.f, dz = 0.f, fp = 0.f;
  if (2 * d != N || 2 * i < N) {  // the pair at d = N/2 once
    const float4 pj = S.p4[b];
    dx = pj.x - pi.x;
    dy = pj.y - pi.y;
    dz = pj.z - pi.z;
    const float r2 = disp_cached(h, *ip, dx, dy, dz);
    fp = fpair<V>(A, r2, wp, sp);
  }
  if (fp != 0.f) {
    const float wx = fp * dx, wy = fp * dy, wz = fp * dz;
    ax += wx;
    ay += wy;
    az += wz;
    if constexpr (V::NEWTON == PARTIALS) {
      R[b] += wx;
      R[M + b] += wy;
      R[2 * M + b] += wz;
    } else {
      atomicAdd(S.fx + b, wx);
      atomicAdd(S.fy + b, wy);
      atomicAdd(S.fz + b, wz);
    }
  }
  if constexpr (V::NEWTON == PARTIALS) __syncwarp();
}

// v8: one shuffle step of the warp's tile pair
template <class V>
__device__ __forceinline__ void pair_shuffle(const SlimArgs& A, const Box& h, float4 pi,
                                             const float* wp, const float* sp, const char4* ip,
                                             int src, float& xj, float& yj, float& zj,
                                             float& ax, float& ay, float& az, float& rx,
                                             float& ry, float& rz) {
  float dx = xj - pi.x, dy = yj - pi.y, dz = zj - pi.z;
  const float r2 = disp_cached(h, *ip, dx, dy, dz);
  const float fp = fpair<V>(A, r2, wp, sp);
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

// ---- the block ring (full rows and the half shell)

// A stage holds the planes read (w4e, then sig2 but for UNISIG), then the
// images of the group's jobs, each RR layout rows of N slots: a thread's
// slot of row r of array a is at float (a RR + r) N + i of the stage.
// One thread: fill stage st with chunk k of this force call (group k /
// chunks, layout rows from (k % chunks) rows); every warp has released the
// stage's previous chunk.
template <class V>
__device__ void issue_block(const RingArgs& RA, const St& S, const Layout& L, const char4* img,
                            int st, int k) {
  const SlimArgs& A = RA.a;
  uint64_t* full = S.bar + st;
  const int g = k / L.chunks, c = k - g * L.chunks;
  const size_t off = (size_t)c * L.rows * A.N;
  const uint32_t bytes = (uint32_t)L.rows * A.N * 4;
  unsigned char* dst = S.ring + (size_t)st * L.stage;
  bar_expect(full, bytes * L.arrays);
  bulk_load(dst, A.w4e + off, bytes, full);
  dst += bytes;
  if constexpr (!V::UNISIG) {
    bulk_load(dst, A.sig2 + off, bytes, full);
    dst += bytes;
  }
  if constexpr (V::CACHE) {
    const size_t slots = slots_per_job<V::NEWTON>(A.N);
    for (int j = 0; j < L.jg; ++j, dst += bytes)
      bulk_load(dst, img + (size_t)(g * L.jg + j) * slots + off, bytes, full);
  }
}

// every warp, after its last read of the stage at cursor c (chunk k): the
// warp whose release completes the stage's count for this use refills it
// with chunk k + depth when this force call has one
template <class V>
__device__ __forceinline__ void release_block(const RingArgs& RA, const St& S, const Layout& L,
                                              const char4* img, Cursor c, int k) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();  // the warp's reads of the stage before its release
    const int done = atomicAdd(S.cnt + c.st, 1) + 1;
    if (done == (int)(c.wrap + 1) * L.warps && k + RA.depth < L.groups * L.chunks)
      issue_block<V>(RA, S, L, img, c.st, k + RA.depth);
  }
}

// thread 0, at a force call's start (the ring is idle): its first chunks
template <class V>
__device__ __forceinline__ void prime_block(const RingArgs& RA, const St& S, const Layout& L,
                                            const char4* img, Cursor c) {
  if (threadIdx.x == 0)
    for (int k = 0; k < RA.depth && k < L.groups * L.chunks; ++k)
      issue_block<V>(RA, S, L, img, c.ahead(k, RA.depth), k);
}

// v1-v4: each thread sums its atom's full row into f (one atom per
// thread: J = 1, N <= 512).  Exit is block-synced.
template <class V>
__device__ void forces_full(const RingArgs& RA, const St& S, const Layout& L, const char4* img,
                            const Box& h, Cursor& cur, float (&f)[3]) {
  const SlimArgs& A = RA.a;
  constexpr int RR = ring_rows<V>(), PL = V::UNISIG ? 1 : 2;
  const int N = A.N, tid = threadIdx.x;
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  prime_block<V>(RA, S, L, img, cur);
  for (int g = 0; g < L.groups; ++g) {
    const bool act = tid < L.jg * N;
    const int a = g * L.jg * N + tid, job = a / N, i = a - job * N, base = job * N;
    const float4 pi = act ? S.p4[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    float fx = 0.f, fy = 0.f, fz = 0.f;
    // this thread's slot in stage 0: planes, then its job's images
    const float* w0 = reinterpret_cast<const float*>(S.ring) + i;
    const int im0 = (PL + job - g * L.jg) * RR * N;
    for (int c = 0; c < L.chunks; ++c, cur.next(RA.depth)) {
      bar_wait(S.bar + cur.st, cur.wrap & 1);
      if (act) {
        const float* w = w0 + cur.st * (int)(L.stage / 4);
        const char4* im = reinterpret_cast<const char4*>(w + im0);
        const float4* pj = S.p4 + base + c * RR;
#pragma unroll
        for (int r = 0; r < RR; ++r)
          pair_full<V>(A, h, ilx, ily, ilz, pj[r], pi, w + r * N, w + (RR + r) * N, im + r * N,
                       fx, fy, fz);
      }
      release_block<V>(RA, S, L, img, cur, g * L.chunks + c);
    }
    if (act) {
      f[0] = V::TRIM ? -fx : fx;
      f[1] = V::TRIM ? -fy : fy;
      f[2] = V::TRIM ? -fz : fz;
    }
  }
  __syncthreads();
}

// v5, v5p, v5r, v7, v7d4, v7p (ATOMIC) and v5m (PARTIALS): the half shell
// j = i + d mod N, d = 1 .. N/2, each unordered pair once.  Exit is
// block-synced.
template <class V>
__device__ void forces_half(const RingArgs& RA, const St& S, const Layout& L, const char4* img,
                            const Box& h, Cursor& cur) {
  const SlimArgs& A = RA.a;
  constexpr int RR = ring_rows<V>(), PL = V::UNISIG ? 1 : 2;
  const int N = A.N, tid = threadIdx.x, nt = blockDim.x;
  const int M = V::J * N, nw = nt >> 5;
  float* R = S.R + (size_t)(tid >> 5) * 3 * M;  // PARTIALS: this warp's rows
  if constexpr (V::NEWTON == PARTIALS) {
    for (int k = tid; k < nw * 3 * M; k += nt) S.R[k] = 0.f;
  } else {
    for (int a = tid; a < M; a += nt) S.fx[a] = S.fy[a] = S.fz[a] = 0.f;
  }
  __syncthreads();
  prime_block<V>(RA, S, L, img, cur);
  // whole warps are active or idle: N and the block width are multiples of 32
  for (int g = 0; g < L.groups; ++g) {
    const bool act = tid < L.jg * N;
    const int a = g * L.jg * N + tid, job = a / N, i = a - job * N, base = job * N;
    const float4 pi = act ? S.p4[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    float ax = 0.f, ay = 0.f, az = 0.f;
    const float* w0 = reinterpret_cast<const float*>(S.ring) + i;
    const int im0 = (PL + job - g * L.jg) * RR * N;
    for (int c = 0; c < L.chunks; ++c, cur.next(RA.depth)) {
      bar_wait(S.bar + cur.st, cur.wrap & 1);
      if (act) {
        const float* w = w0 + cur.st * (int)(L.stage / 4);
        const char4* im = reinterpret_cast<const char4*>(w + im0);
#pragma unroll
        for (int r = 0; r < RR; ++r)
          pair_half<V>(A, S, R, h, M, i, base, c * RR + r + 1, pi, w + r * N, w + (RR + r) * N,
                       im + r * N, ax, ay, az);
      }
      release_block<V>(RA, S, L, img, cur, g * L.chunks + c);
    }
    if (act) {
      if constexpr (V::NEWTON == PARTIALS) {
        S.fx[a] = -ax;
        S.fy[a] = -ay;
        S.fz[a] = -az;
      } else {
        atomicAdd(S.fx + a, -ax);
        atomicAdd(S.fy + a, -ay);
        atomicAdd(S.fz + a, -az);
      }
    }
  }
  __syncthreads();
  if constexpr (V::NEWTON == PARTIALS) {  // one reduction of the partials, warp order
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

// ---- v8's per-warp ring

// Lane 0: fill stage st of the warp's ring with chunk k of this force call
// (its tile pair k / chunks, shuffle steps from (k % chunks) rows).  The
// warp released that stage (__syncwarp) before.
template <class V>
__device__ void issue_warp(const RingArgs& RA, const Layout& L, const char4* img, uint64_t* full,
                           unsigned char* ring, int st, int k, int warp, int nw, int TP) {
  const SlimArgs& A = RA.a;
  const int t = k / L.chunks, kc = k - t * L.chunks;
  const int qg = warp + t * nw, job = qg / TP, q = qg - job * TP;
  const size_t off = (size_t)q * TILE * TILE + (size_t)kc * L.rows * TILE;
  const uint32_t bytes = (uint32_t)L.rows * TILE * 4;
  unsigned char* dst = ring + (size_t)st * L.stage;
  bar_expect(full + st, bytes * L.arrays);
  bulk_load(dst, A.w4e + off, bytes, full + st);
  dst += bytes;
  if constexpr (!V::UNISIG) {
    bulk_load(dst, A.sig2 + off, bytes, full + st);
    dst += bytes;
  }
  if constexpr (V::CACHE)
    bulk_load(dst, img + (size_t)job * TP * TILE * TILE + off, bytes, full + st);
}

// v8: 32 x 32 tile pairs dealt to warps, j and its reaction rotating by
// shuffles.  Exit is block-synced.
template <class V>
__device__ void forces_shuffle(const RingArgs& RA, const St& S, const Layout& L,
                               const char4* img, const Box& h, Cursor& cur) {
  const SlimArgs& A = RA.a;
  const int N = A.N, T = N / TILE, TP = T * (T + 1) / 2, M = V::J * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  for (int a = tid; a < M; a += blockDim.x) S.fx[a] = S.fy[a] = S.fz[a] = 0.f;
  __syncthreads();
  const int nq = V::J * TP;
  const int mine = warp < nq ? (nq - warp + nw - 1) / nw : 0;  // this warp's tile pairs
  constexpr int RR = ring_rows<V>(), PL = V::UNISIG ? 1 : 2;
  const int D = RA.depth, total = mine * L.chunks;
  uint64_t* full = S.bar + warp * D;
  unsigned char* ring = S.ring + (size_t)warp * D * L.stage;
  if (lane == 0)
    for (int k = 0; k < D && k < total; ++k)
      issue_warp<V>(RA, L, img, full, ring, cur.ahead(k, D), k, warp, nw, TP);
  const int src = (lane + 1) & 31;
  for (int t = 0; t < mine; ++t) {
    const int qg = warp + t * nw, job = qg / TP, q = qg - job * TP;
    int ta, tb;
    tile_pair(q, T, ta, tb);
    const int a = job * N + ta * TILE + lane, b = job * N + tb * TILE + lane;
    const float4 pi = S.p4[a];
    const float4 pb = S.p4[b];
    float xj = pb.x, yj = pb.y, zj = pb.z;
    float ax = 0.f, ay = 0.f, az = 0.f, rx = 0.f, ry = 0.f, rz = 0.f;
    for (int kc = 0; kc < L.chunks; ++kc, cur.next(D)) {
      bar_wait(full + cur.st, cur.wrap & 1);
      const float* w = reinterpret_cast<const float*>(ring + (size_t)cur.st * L.stage) + lane;
      const char4* im = reinterpret_cast<const char4*>(w + PL * RR * TILE);
#pragma unroll
      for (int kk = 0; kk < RR; ++kk)
        pair_shuffle<V>(A, h, pi, w + kk * TILE, w + (RR + kk) * TILE, im + kk * TILE, src, xj,
                        yj, zj, ax, ay, az, rx, ry, rz);
      __syncwarp();
      const int k = t * L.chunks + kc;
      if (lane == 0 && k + D < total)
        issue_warp<V>(RA, L, img, full, ring, cur.st, k + D, warp, nw, TP);
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

template <class V>
__device__ __forceinline__ void forces(const RingArgs& RA, const St& S, const Layout& L,
                                       const char4* img, const Box& h, Cursor& cur,
                                       float (&f)[3]) {
  if constexpr (V::NEWTON == FULL)
    forces_full<V>(RA, S, L, img, h, cur, f);
  else if constexpr (V::NEWTON == SHUFFLE)
    forces_shuffle<V>(RA, S, L, img, h, cur);
  else
    forces_half<V>(RA, S, L, img, h, cur);
}

__device__ __forceinline__ int word(char4 c) {
  return (int)((unsigned)(unsigned char)c.x | ((unsigned)(unsigned char)c.y << 8) |
               ((unsigned)(unsigned char)c.z << 16) | ((unsigned)(unsigned char)c.w << 24));
}

// Store every pair's images for box h at the current positions, the slots
// of all J jobs dealt over the block: four per thread and one 16-byte store
// (slots is a multiple of 4).  Exit is block-synced.
template <class V>
__device__ void refresh(const SlimArgs& A, const St& S, char4* img, const Box& h) {
  const int N = A.N, slots = slots_per_job<V::NEWTON>(N), n = V::J * slots;
  const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
  bool over = false;
  auto one = [&](int s) {
    const int job = s / slots, o = s - job * slots;
    int i, j;
    char4 c = make_char4(0, 0, 0, 0);
    if (slot_pair<V::NEWTON>(o, N, i, j)) {
      const float4 pa = S.p4[job * N + i], pb = S.p4[job * N + j];
      c = images(h, ilx, ily, ilz, pb.x - pa.x, pb.y - pa.y, pb.z - pa.z, over);
    }
    return c;
  };
  int4* dst = reinterpret_cast<int4*>(img);
  for (int s = 4 * threadIdx.x; s < n; s += 4 * blockDim.x)
    dst[s >> 2] = make_int4(word(one(s)), word(one(s + 1)), word(one(s + 2)), word(one(s + 3)));
  // the ring's bulk copies (the async proxy) read what these stores wrote
  asm volatile("fence.proxy.async.global;" ::: "memory");
  if (over) S.misc[NHC + 1] = 1.f;
  __syncthreads();
}

// __launch_bounds__ as the first design's: one box per block runs 512
// threads and asks for two blocks per SM, J boxes 1024 threads and one block
template <bool CACHE, bool TRIM, bool UNISIG, int FORM, int NEWTON, int J>
__global__ void __launch_bounds__(J == 1 ? 512 : 1024, J == 1 ? 2 : 1)
    md_slim_ring_kernel(RingArgs RA) {
  using V = Flags<CACHE, TRIM, UNISIG, FORM, NEWTON, J>;
  constexpr int AT = atoms_per_thread<V>();
  extern __shared__ __align__(128) unsigned char smem[];
  const SlimArgs& A = RA.a;
  const int prog = blockIdx.x, N = A.N, M = J * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = ring_layout<V>(N, RA.depth);
  const St S = carve<V>(smem, L, M);
  // this thread's atoms tid + k nt: velocities, masses and (full rows)
  // forces in registers
  float vx[AT], vy[AT], vz[AT], mf[AT];
  float fr[3] = {0.f, 0.f, 0.f};
  const float* st = A.state + (size_t)prog * 8 * M;
#pragma unroll
  for (int k = 0; k < AT; ++k) {
    const int a = tid + k * nt;
    vx[k] = vy[k] = vz[k] = mf[k] = 0.f;
    if (a < M) {
      S.p4[a] = make_float4(st[a], st[M + a], st[2 * M + a], st[6 * M + a]);
      vx[k] = st[3 * M + a];
      vy[k] = st[4 * M + a];
      vz[k] = st[5 * M + a];
      mf[k] = st[7 * M + a];
    }
  }
  const float* fs = A.fscal + (size_t)prog * FS;
  const int n_run = A.iscal[prog * IS], n_tot = A.iscal[prog * IS + 1];
  if (tid < NHC) S.misc[tid] = fs[14 + tid];
  if (tid == 0) S.misc[NHC + 1] = 0.f;
  if (tid == 0) {  // one arrival each (the filling thread's, with the bytes)
    for (int k = 0; k < L.bars; ++k) bar_init(S.bar + k, 1u);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (NEWTON != SHUFFLE && tid < RA.depth) S.cnt[tid] = 0;
  const float dt = fs[0], kt = A.boltz * fs[1];
  float h0[6], eps[6];
  for (int k = 0; k < 6; ++k) {
    h0[k] = fs[2 + k];
    eps[k] = fs[8 + k];
  }
  char4* img = CACHE ? A.img + (size_t)prog * J * slots_per_job<NEWTON>(N) : nullptr;
  const float ntot = (float)n_tot;
  Cursor cur{0, 0u};  // the ring's next stage (v8: this warp's ring's)
  // the lab's nhc_half over the registers' velocities
  auto nhc = [&]() {
    float ke = 0.f;
#pragma unroll
    for (int k = 0; k < AT; ++k)
      if (tid + k * nt < M) ke += mf[k] * (vx[k] * vx[k] + vy[k] * vy[k] + vz[k] * vz[k]);
    nhc_chain(block_sum(ke, S.red), S.misc, dt, kt, A.ndof, A.tdamp);
    const float scale = S.misc[NHC];
#pragma unroll
    for (int k = 0; k < AT; ++k) {
      vx[k] *= scale;
      vy[k] *= scale;
      vz[k] *= scale;
    }
  };
  // half a kick from this step's forces, then (drift) the positions
  auto kick = [&](bool drift) {
    const float half = 0.5f * dt;
#pragma unroll
    for (int k = 0; k < AT; ++k) {
      const int a = tid + k * nt;
      if (a >= M) continue;
      float4 p = S.p4[a];
      const float im = p.w;
      const float gx = NEWTON == FULL ? fr[0] : S.fx[a];
      const float gy = NEWTON == FULL ? fr[1] : S.fy[a];
      const float gz = NEWTON == FULL ? fr[2] : S.fz[a];
      vx[k] = vx[k] + half * gx * im;
      vy[k] = vy[k] + half * gy * im;
      vz[k] = vz[k] + half * gz * im;
      if (drift) {
        p.x += dt * vx[k];
        p.y += dt * vy[k];
        p.z += dt * vz[k];
        S.p4[a] = p;
      }
    }
  };
  __syncthreads();
  if (n_run > 0) {
    Box h = h_at(h0, eps, 0.f / ntot);
    if constexpr (CACHE) refresh<V>(A, S, img, h);
    forces<V>(RA, S, L, img, h, cur, fr);
    for (int s = 0; s < n_run; ++s) {
      h = h_at(h0, eps, (float)s / ntot);
      if constexpr (CACHE) {
        if (s > 0 && s % R_REFRESH == 0) refresh<V>(A, S, img, h);
      }
      nhc();
      kick(true);
      __syncthreads();
      forces<V>(RA, S, L, img, h, cur, fr);
      kick(false);
      nhc();
      const Remap r = remap(h, h_at(h0, eps, (float)(s + 1) / ntot));
      for (int a = tid; a < M; a += nt) {
        float4 p = S.p4[a];
        const float x = p.x, y = p.y, z = p.z;
        p.x = r.a00 * x + r.a01 * y + r.a02 * z;
        p.y = r.a11 * y + r.a12 * z;
        p.z = r.a22 * z;
        S.p4[a] = p;
      }
      __syncthreads();
    }
  }
  const bool bad = S.misc[NHC + 1] != 0.f;  // an image beyond int8
  float* o = A.out + (size_t)prog * 8 * M;
  float ke = 0.f;
#pragma unroll
  for (int k = 0; k < AT; ++k) {
    const int a = tid + k * nt;
    if (a >= M) continue;
    const float4 p = S.p4[a];
    o[a] = bad ? nanf("") : p.x;
    o[M + a] = bad ? nanf("") : p.y;
    o[2 * M + a] = bad ? nanf("") : p.z;
    o[3 * M + a] = vx[k];
    o[4 * M + a] = vy[k];
    o[5 * M + a] = vz[k];
    o[6 * M + a] = p.w;
    o[7 * M + a] = mf[k];
    ke += mf[k] * (vx[k] * vx[k] + vy[k] * vy[k] + vz[k] * vz[k]);
  }
  ke = block_sum(ke, S.red);
  float* sacc = A.sacc + (size_t)prog * SACC;
  if (tid < NHC) sacc[tid] = S.misc[tid];
  if (tid == NHC) sacc[NHC] = ke;
  if (tid > NHC && tid < SACC) sacc[tid] = 0.f;
}

// ---- the big-box instance (SMALL_N < N <= n_max atoms per box)
//
// A box wider than the block.  Positions (float4) and the forces of every
// schedule stay in shared memory; velocities and m/FTM2V live in the
// program's output rows in device memory, which the integration passes
// (O(N) per step, against the pair loop's O(N^2)) read and write, each
// thread its atoms a = tid + k nt as in the first design, so J = 1 keeps the
// first design's 512 threads and its order of the 2 KE sums.  A stage holds
// BIG_ROWS layout rows of one column tile of BIG_COLS slots of each array:
// one bulk copy per (array, row) segment of the tile's columns.  Each job
// lane of BIG_COLS threads walks its job's column tiles outer and the rows
// inner, so a full-row atom sums over j in ascending order (the first
// design's bits).  J > 1 runs 1024 threads: two job lanes, which share the
// stage's planes and read their own job's images.  v5m's reactions go to a
// per-warp window of the partners one stage reaches (TILE + BIG_ROWS - 1
// of them), added to the shared forces by atomics when the stage is done.
// v8's per-warp ring of tile pairs is the first instance's, with more tile
// pairs per warp.

constexpr int SMALL_N = 512;             // the largest box of the first instance
// layout rows per stage, big-box instance: not the first instance's 8, as two
// 8-row stages of three arrays (96 KB) do not fit beside 5248 atoms'
// positions and forces (147 KB)
constexpr int BIG_ROWS = 4;
constexpr int BIG_COLS = 512;            // columns per stage: one per thread of a job lane
constexpr int WIN = TILE + BIG_ROWS;     // v5m: a warp's window, TILE + BIG_ROWS - 1 used

// The largest box of each variant: what the first design (11 J N floats of
// shared memory) or the lab's 100 MiB VMEM budget runs (ops/md_slim.n_max)
template <class V>
__host__ __device__ constexpr int n_max() {
  return V::J == 4 ? 1280 : V::J == 2 ? 2560 : V::NEWTON == PARTIALS ? 2176 : 5248;
}

template <class V>
__host__ __device__ Layout big_layout(int N, int depth) {
  Layout L{};
  const int M = V::J * N;
  L.threads = V::J == 1 ? 512 : 1024;
  L.warps = L.threads / 32;
  L.rows = V::NEWTON == SHUFFLE ? ring_rows<V>() : BIG_ROWS;
  L.ok = N > SMALL_N && N % 128 == 0 && N <= n_max<V>() && depth > 0;
  if (!L.ok) return L;
  const int planes = V::UNISIG ? 1 : 2;
  if (V::NEWTON == SHUFFLE) {  // the first instance's per-warp ring
    L.jg = V::J;
    L.groups = 1;
    L.cols = TILE;
    L.tiles = 1;
    L.arrays = planes + (V::CACHE ? 1 : 0);
    L.chunks = TILE / L.rows;
    L.stage = (size_t)L.arrays * L.rows * TILE * 4;
    L.ring = (size_t)L.warps * depth * L.stage;
    L.bars = L.warps * depth;
  } else {
    const int R = V::NEWTON == FULL ? N : N / 2;
    L.cols = BIG_COLS;
    L.jg = L.threads / L.cols;
    L.groups = V::J / L.jg;
    L.tiles = (N + L.cols - 1) / L.cols;
    L.ok = V::J % L.jg == 0 && R % L.rows == 0;
    L.arrays = planes + (V::CACHE ? L.jg : 0);
    L.chunks = L.tiles * (R / L.rows);
    L.stage = (size_t)L.arrays * L.rows * L.cols * 4;
    L.ring = (size_t)depth * L.stage;
    L.bars = depth;
  }
  L.flt = (size_t)16 * M + L.ring;
  L.part = L.flt + 4 * ((size_t)3 * M + MAXW + MISC);
  L.bar = L.part + (V::NEWTON == PARTIALS ? (size_t)4 * L.warps * 3 * WIN : 0);
  L.bar = (L.bar + 7) / 8 * 8;
  L.bytes = L.bar + (size_t)8 * L.bars;
  if (V::NEWTON != SHUFFLE) L.bytes += (size_t)4 * depth;  // release counts
  L.ok = L.ok && L.bytes <= (size_t)SMEM_MAX;
  return L;
}

template <class V>
__device__ __forceinline__ St carve_big(unsigned char* sm, const Layout& L, int M) {
  St s;
  s.p4 = reinterpret_cast<float4*>(sm);
  s.ring = sm + (size_t)16 * M;
  float* f = reinterpret_cast<float*>(sm + L.flt);
  s.fx = f;
  s.fy = f + M;
  s.fz = f + 2 * M;
  s.red = f + 3 * M;
  s.misc = s.red + MAXW;
  s.R = reinterpret_cast<float*>(sm + L.part);  // v5m: the warps' windows, 3 WIN each
  s.bar = reinterpret_cast<uint64_t*>(sm + L.bar);
  s.cnt = reinterpret_cast<int*>(s.bar + L.bars);
  return s;
}

// A stage holds the planes read (w4e, then sig2 but for UNISIG), then the
// images of the group's jobs, each BIG_ROWS rows of L.cols slots: a thread's
// slot of row r of array a is at float (a BIG_ROWS + r) L.cols + column of
// the stage.  One thread: fill stage st with chunk k of this force call
// (group, column tile, then BIG_ROWS layout rows), one bulk copy per array
// and row of the tile's columns (the last tile may be narrower).
template <class V>
__device__ void issue_big(const RingArgs& RA, const St& S, const Layout& L, const char4* img,
                          int st, int k) {
  const SlimArgs& A = RA.a;
  constexpr int PL = V::UNISIG ? 1 : 2;
  const int per = L.chunks / L.tiles;  // row chunks per column tile
  const int gt = k / per, c = k - gt * per, g = gt / L.tiles, t = gt - g * L.tiles;
  const int c0 = t * L.cols, ct = A.N - c0 < L.cols ? A.N - c0 : L.cols;
  const uint32_t bytes = (uint32_t)ct * 4;
  uint64_t* full = S.bar + st;
  float* dst = reinterpret_cast<float*>(S.ring + (size_t)st * L.stage);
  bar_expect(full, bytes * L.arrays * BIG_ROWS);
  for (int r = 0; r < BIG_ROWS; ++r) {
    const size_t off = (size_t)(c * BIG_ROWS + r) * A.N + c0;
    bulk_load(dst + r * L.cols, A.w4e + off, bytes, full);
    if constexpr (!V::UNISIG) bulk_load(dst + (BIG_ROWS + r) * L.cols, A.sig2 + off, bytes, full);
    if constexpr (V::CACHE) {
      const size_t slots = slots_per_job<V::NEWTON>(A.N);
      for (int j = 0; j < L.jg; ++j)
        bulk_load(dst + ((PL + j) * BIG_ROWS + r) * L.cols,
                  img + (size_t)(g * L.jg + j) * slots + off, bytes, full);
    }
  }
}

// release_block and prime_block over issue_big
template <class V>
__device__ __forceinline__ void release_big(const RingArgs& RA, const St& S, const Layout& L,
                                            const char4* img, Cursor c, int k) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();  // the warp's reads of the stage before its release
    const int done = atomicAdd(S.cnt + c.st, 1) + 1;
    if (done == (int)(c.wrap + 1) * L.warps && k + RA.depth < L.groups * L.chunks)
      issue_big<V>(RA, S, L, img, c.st, k + RA.depth);
  }
}

template <class V>
__device__ __forceinline__ void prime_big(const RingArgs& RA, const St& S, const Layout& L,
                                          const char4* img, Cursor c) {
  if (threadIdx.x == 0)
    for (int k = 0; k < RA.depth && k < L.groups * L.chunks; ++k)
      issue_big<V>(RA, S, L, img, c.ahead(k, RA.depth), k);
}

// the half shell as pair_half, v5m's reaction into the warp's window at
// entry e = lane + row of the stage (distinct across the warp at each row)
template <class V>
__device__ __forceinline__ void pair_half_big(const SlimArgs& A, const St& S, float* W,
                                              const Box& h, int i, int base, int d, int e,
                                              float4 pi, const float* wp, const float* sp,
                                              const char4* ip, float& ax, float& ay, float& az) {
  const int N = A.N;
  int jl = i + d;
  if (jl >= N) jl -= N;
  const int b = base + jl;
  float dx = 0.f, dy = 0.f, dz = 0.f, fp = 0.f;
  if (2 * d != N || 2 * i < N) {  // the pair at d = N/2 once
    const float4 pj = S.p4[b];
    dx = pj.x - pi.x;
    dy = pj.y - pi.y;
    dz = pj.z - pi.z;
    const float r2 = disp_cached(h, *ip, dx, dy, dz);
    fp = fpair<V>(A, r2, wp, sp);
  }
  if (fp != 0.f) {
    const float wx = fp * dx, wy = fp * dy, wz = fp * dz;
    ax += wx;
    ay += wy;
    az += wz;
    if constexpr (V::NEWTON == PARTIALS) {
      W[e] += wx;
      W[WIN + e] += wy;
      W[2 * WIN + e] += wz;
    } else {
      atomicAdd(S.fx + b, wx);
      atomicAdd(S.fy + b, wy);
      atomicAdd(S.fz + b, wz);
    }
  }
  if constexpr (V::NEWTON == PARTIALS) __syncwarp();
}

// v5m: add the warp's window (partners j0 + e mod N of its job) to the
// shared forces and clear it
__device__ __forceinline__ void flush_window(const St& S, float* W, int base, int N, int j0) {
  for (int e = threadIdx.x & 31; e < TILE + BIG_ROWS - 1; e += 32) {
    int j = j0 + e;
    if (j >= N) j -= N;
    atomicAdd(S.fx + base + j, W[e]);
    atomicAdd(S.fy + base + j, W[WIN + e]);
    atomicAdd(S.fz + base + j, W[2 * WIN + e]);
    W[e] = W[WIN + e] = W[2 * WIN + e] = 0.f;
  }
  __syncwarp();
}

// The big-box force call: full rows (v1-v4) and the half shell (v5, v5p,
// v5r, v5m, v7, v7d4, v7p) over column-tiled stages, v8 as the first
// instance.  Forces into S.f*.  Exit is block-synced.
template <class V>
__device__ void forces_big(const RingArgs& RA, const St& S, const Layout& L, const char4* img,
                           const Box& h, Cursor& cur) {
  if constexpr (V::NEWTON == SHUFFLE) {
    forces_shuffle<V>(RA, S, L, img, h, cur);
  } else {
    const SlimArgs& A = RA.a;
    constexpr int RR = BIG_ROWS, PL = V::UNISIG ? 1 : 2;
    const int N = A.N, tid = threadIdx.x, nt = blockDim.x, M = V::J * N;
    const int lj = tid / L.cols, col = tid - lj * L.cols;  // job lane, column in a tile
    const int lane = tid & 31, per = L.chunks / L.tiles, C = L.cols;
    const float ilx = 1.f / h.lx, ily = 1.f / h.ly, ilz = 1.f / h.lz;
    float* W = S.R + (size_t)(tid >> 5) * 3 * WIN;  // v5m: this warp's window
    if constexpr (V::NEWTON != FULL) {
      for (int a = tid; a < M; a += nt) S.fx[a] = S.fy[a] = S.fz[a] = 0.f;
      __syncthreads();
    }
    prime_big<V>(RA, S, L, img, cur);
    const float* w0 = reinterpret_cast<const float*>(S.ring) + col;
    const int im0 = (PL + lj) * RR * C;  // this lane's job's images in a stage
    for (int g = 0; g < L.groups; ++g) {
      const int base = (g * L.jg + lj) * N;
      for (int t = 0; t < L.tiles; ++t) {
        const int i = t * C + col, a = base + i;
        const bool act = i < N;  // whole warps: N and C are multiples of 128
        const float4 pi = act ? S.p4[a] : make_float4(0.f, 0.f, 0.f, 0.f);
        float fx = 0.f, fy = 0.f, fz = 0.f;
        for (int c = 0; c < per; ++c, cur.next(RA.depth)) {
          bar_wait(S.bar + cur.st, cur.wrap & 1);
          if (act) {
            const float* w = w0 + cur.st * (int)(L.stage / 4);
            const char4* im = reinterpret_cast<const char4*>(w + im0);
            if constexpr (V::NEWTON == FULL) {
              const float4* pj = S.p4 + base + c * RR;
#pragma unroll
              for (int r = 0; r < RR; ++r)
                pair_full<V>(A, h, ilx, ily, ilz, pj[r], pi, w + r * C, w + (RR + r) * C,
                             im + r * C, fx, fy, fz);
            } else {
#pragma unroll
              for (int r = 0; r < RR; ++r)
                pair_half_big<V>(A, S, W, h, i, base, c * RR + r + 1, lane + r, pi, w + r * C,
                                 w + (RR + r) * C, im + r * C, fx, fy, fz);
              if constexpr (V::NEWTON == PARTIALS) flush_window(S, W, base, N, i - lane + c * RR + 1);
            }
          }
          release_big<V>(RA, S, L, img, cur, (g * L.tiles + t) * per + c);
        }
        if (act) {
          if constexpr (V::NEWTON == FULL) {
            S.fx[a] = V::TRIM ? -fx : fx;
            S.fy[a] = V::TRIM ? -fy : fy;
            S.fz[a] = V::TRIM ? -fz : fz;
          } else {  // other warps' reactions land here too
            atomicAdd(S.fx + a, -fx);
            atomicAdd(S.fy + a, -fy);
            atomicAdd(S.fz + a, -fz);
          }
        }
      }
    }
    __syncthreads();
  }
}

// The big-box instance: the first design's integration order over device
// memory velocities, the forces of forces_big
template <bool CACHE, bool TRIM, bool UNISIG, int FORM, int NEWTON, int J>
__global__ void __launch_bounds__(J == 1 ? 512 : 1024, J == 1 ? 2 : 1)
    md_slim_big_kernel(RingArgs RA) {
  using V = Flags<CACHE, TRIM, UNISIG, FORM, NEWTON, J>;
  extern __shared__ __align__(128) unsigned char smem[];
  const SlimArgs& A = RA.a;
  const int prog = blockIdx.x, N = A.N, M = J * N;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = big_layout<V>(N, RA.depth);
  const St S = carve_big<V>(smem, L, M);
  const float* st = A.state + (size_t)prog * 8 * M;
  float* o = A.out + (size_t)prog * 8 * M;
  // the run's velocities and m/FTM2V: the output's own rows
  float *vx = o + 3 * M, *vy = o + 4 * M, *vz = o + 5 * M, *mf = o + 7 * M;
  for (int a = tid; a < M; a += nt) {
    S.p4[a] = make_float4(st[a], st[M + a], st[2 * M + a], st[6 * M + a]);
    vx[a] = st[3 * M + a];
    vy[a] = st[4 * M + a];
    vz[a] = st[5 * M + a];
    mf[a] = st[7 * M + a];
  }
  if constexpr (NEWTON == PARTIALS)
    for (int k = tid; k < L.warps * 3 * WIN; k += nt) S.R[k] = 0.f;
  const float* fs = A.fscal + (size_t)prog * FS;
  const int n_run = A.iscal[prog * IS], n_tot = A.iscal[prog * IS + 1];
  if (tid < NHC) S.misc[tid] = fs[14 + tid];
  if (tid == 0) S.misc[NHC + 1] = 0.f;
  if (tid == 0) {  // one arrival each (the filling thread's, with the bytes)
    for (int k = 0; k < L.bars; ++k) bar_init(S.bar + k, 1u);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (NEWTON != SHUFFLE && tid < RA.depth) S.cnt[tid] = 0;
  const float dt = fs[0], kt = A.boltz * fs[1], half = 0.5f * dt;
  float h0[6], eps[6];
  for (int k = 0; k < 6; ++k) {
    h0[k] = fs[2 + k];
    eps[k] = fs[8 + k];
  }
  char4* img = CACHE ? A.img + (size_t)prog * J * slots_per_job<NEWTON>(N) : nullptr;
  const float ntot = (float)n_tot;
  Cursor cur{0, 0u};
  __syncthreads();
  if (n_run > 0) {
    Box h = h_at(h0, eps, 0.f / ntot);
    if constexpr (CACHE) refresh<V>(A, S, img, h);
    forces_big<V>(RA, S, L, img, h, cur);
    for (int s = 0; s < n_run; ++s) {
      h = h_at(h0, eps, (float)s / ntot);
      if constexpr (CACHE) {
        if (s > 0 && s % R_REFRESH == 0) refresh<V>(A, S, img, h);
      }
      nhc_half(vx, vy, vz, mf, S.red, S.misc, M, dt, kt, A.ndof, A.tdamp);
      for (int a = tid; a < M; a += nt) {
        float4 p = S.p4[a];
        const float im = p.w;
        vx[a] = vx[a] + half * S.fx[a] * im;
        vy[a] = vy[a] + half * S.fy[a] * im;
        vz[a] = vz[a] + half * S.fz[a] * im;
        p.x += dt * vx[a];
        p.y += dt * vy[a];
        p.z += dt * vz[a];
        S.p4[a] = p;
      }
      __syncthreads();
      forces_big<V>(RA, S, L, img, h, cur);
      for (int a = tid; a < M; a += nt) {
        const float im = S.p4[a].w;
        vx[a] = vx[a] + half * S.fx[a] * im;
        vy[a] = vy[a] + half * S.fy[a] * im;
        vz[a] = vz[a] + half * S.fz[a] * im;
      }
      nhc_half(vx, vy, vz, mf, S.red, S.misc, M, dt, kt, A.ndof, A.tdamp);
      const Remap r = remap(h, h_at(h0, eps, (float)(s + 1) / ntot));
      for (int a = tid; a < M; a += nt) {
        float4 p = S.p4[a];
        const float x = p.x, y = p.y, z = p.z;
        p.x = r.a00 * x + r.a01 * y + r.a02 * z;
        p.y = r.a11 * y + r.a12 * z;
        p.z = r.a22 * z;
        S.p4[a] = p;
      }
      __syncthreads();
    }
  }
  const bool bad = S.misc[NHC + 1] != 0.f;  // an image beyond int8
  float ke = 0.f;
  for (int a = tid; a < M; a += nt) {
    const float4 p = S.p4[a];
    o[a] = bad ? nanf("") : p.x;
    o[M + a] = bad ? nanf("") : p.y;
    o[2 * M + a] = bad ? nanf("") : p.z;
    o[6 * M + a] = p.w;
    ke += mf[a] * (vx[a] * vx[a] + vy[a] * vy[a] + vz[a] * vz[a]);
  }
  ke = block_sum(ke, S.red);
  float* sacc = A.sacc + (size_t)prog * SACC;
  if (tid < NHC) sacc[tid] = S.misc[tid];
  if (tid == NHC) sacc[NHC] = ke;
  if (tid > NHC && tid < SACC) sacc[tid] = 0.f;
}

#define RING_KERNEL(V) md_slim_ring_kernel<V::CACHE, V::TRIM, V::UNISIG, V::FORM, V::NEWTON, V::J>
#define BIG_KERNEL(V) md_slim_big_kernel<V::CACHE, V::TRIM, V::UNISIG, V::FORM, V::NEWTON, V::J>

// The variant's layout at N atoms per box, from the instance for N <=
// SMALL_N or the big-box one; opts that kernel into more than 48 KB of
// shared memory where it needs it.
template <class V>
cudaError_t prepare(int N, int depth, Layout& L) {
  const bool big = N > SMALL_N;
  if (big) {
    L = big_layout<V>(N, depth);
  } else {
    L = ring_layout<V>(N, depth);
    L.cols = V::NEWTON == SHUFFLE ? TILE : N;
    L.tiles = 1;
  }
  if (!L.ok) return cudaErrorInvalidValue;
  const void* kernel = big ? (const void*)BIG_KERNEL(V) : (const void*)RING_KERNEL(V);
  if (L.bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)L.bytes);
  return cudaSuccess;
}

template <class V>
cudaError_t launch(const RingArgs& RA, cudaStream_t stream) {
  const SlimArgs& A = RA.a;
  if (A.J != V::J || (V::CACHE && A.img == nullptr)) return cudaErrorInvalidValue;
  Layout L;
  cudaError_t err = prepare<V>(A.N, RA.depth, L);
  if (err != cudaSuccess) return err;
  if (A.N > SMALL_N)
    BIG_KERNEL(V)<<<A.P, L.threads, L.bytes, stream>>>(RA);
  else
    RING_KERNEL(V)<<<A.P, L.threads, L.bytes, stream>>>(RA);
  return cudaGetLastError();
}

// registers, local bytes, resident blocks per SM, then the layout: threads,
// jobs per group, groups, chunks, arrays, rows, stage, ring and shared
// bytes, columns per stage and column tiles
template <class V>
cudaError_t info(int N, int depth, int* out) {
  Layout L;
  cudaError_t err = prepare<V>(N, depth, L);
  if (err != cudaSuccess) return err;
  const void* kernel = N > SMALL_N ? (const void*)BIG_KERNEL(V) : (const void*)RING_KERNEL(V);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, L.threads, L.bytes);
  const int v[] = {fa.numRegs, (int)fa.localSizeBytes, blocks, L.threads, L.jg,
                   L.groups, L.chunks, L.arrays, L.rows, (int)L.stage, (int)L.ring,
                   (int)L.bytes, L.cols, L.tiles};
  for (int k = 0; k < INFO; ++k) out[k] = v[k];
  return err;
}

}  // namespace

// One slim run of P programs on the variant's instance for its N (N <=
// SMALL_N, or the big-box instance up to n_max); args points to a RingArgs.
extern "C" int md_slim_ring_run_f32(const void* args, int variant, void* stream) {
  const RingArgs* r = static_cast<const RingArgs*>(args);
  if (r == nullptr) return (int)cudaErrorInvalidValue;
  const SlimArgs& a = r->a;
  if (a.P <= 0 || a.N <= 0 || a.N % 128 != 0 || !a.state || !a.out || !a.sacc || !a.w4e ||
      !a.sig2 || !a.iscal || !a.fscal)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_variant(variant, [&](auto v) { return launch<decltype(v)>(*r, s); });
}

// The instance's registers, local (spill) bytes and resident blocks per SM,
// then its block at N atoms per box and a ring of `depth` stages (threads,
// jobs per group, groups, chunks, arrays, rows, stage, ring and shared
// bytes, columns per stage, column tiles), into out[INFO].
extern "C" int md_slim_ring_info(int variant, int N, int depth, int* out) {
  if (out == nullptr || N <= 0 || N % 128 != 0) return (int)cudaErrorInvalidValue;
  return (int)by_variant(variant, [&](auto v) { return info<decltype(v)>(N, depth, out); });
}
