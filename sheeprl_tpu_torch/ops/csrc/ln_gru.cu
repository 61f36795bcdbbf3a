// Fused LayerNorm-GRU cell, forward, for Hopper (sm_90a): one cooperative
// launch per row chunk.
//
// Counterpart of the TPU kernel sheeprl_tpu/ops/pallas_gru.py::_gru_kernel
// (launched by _gru_pallas through pl.pallas_call).  For joint [B, K],
// w [3H, K] (nn.Linear layout), optional b [3H], g/beta [3H], h [B, H]:
//
//   a  = joint @ w^T + b                  (fp32 accumulation)
//   n  = LayerNorm(a) over the 3H row     (centered variance, eps)
//   r  = sigmoid(n[:H]);  c = tanh(r * n[H:2H]);  u = sigmoid(n[2H:] - 1)
//   h' = u * c + (1 - u) * h              (cast to h's dtype)
//
// What bounds it on an H100.  The work must read w once (3H*K elements)
// and does 2*B*K*3H operations: at DV3-S (K=1024, H=512) the serving widths
// are bound by the bytes of w up to B ~ 37 in fp32 and by fp32 operations
// near B=128; bf16 stays bound by bytes at every serving width.  This
// kernel, measured (PERF.md): at S it is latency-bound, about 10 us at any
// B <= 8, of which the cross-CTA LayerNorm exchange (grid sync and merge)
// and the launch take about half; at XL fp32 B=128 the fp32 product is
// bound by shared-memory wavefronts (each 16-byte load costs four).
//
// Design.  Each CTA owns whole hidden units: CTA c owns units [c*U, c*U+U)
// and the three rows of w that feed each (reset u, candidate H+u, update
// 2H+u), so it finishes the gates of its units from its own projection
// values.  U is the smallest power of two that keeps the grid within one CTA
// per SM (DV3 presets: U = 4..32 on 128 CTAs), so the grid fills the card at
// every B and each byte of w is read from device memory once per launch.
//   - One thread of a producer warp streams the CTA's w rows and the joint
//     rows into a ring of shared-memory stages with TMA bulk tensor copies
//     (cp.async.bulk.tensor, completion counted in bytes on an mbarrier):
//     four copies per stage, one box per gate of w ([UB rows, CK*128 bytes
//     of K]) and one of joint ([BT rows, CK*128 bytes]).  Each row of K is
//     viewed as 128-byte segments (a 3-D tensor map), so a box spans many
//     segments and the copies stay few and large (with one 1-D copy of 128
//     bytes per row, the number of copies, not their bytes, set the time of
//     the first version of this design).  The 128-byte
//     swizzle and an odd CK put one segment of eight consecutive rows in
//     eight different bank groups.  Eight consumer warps wait on the stage's
//     "full" barrier, multiply, and release it on its "empty" barrier.
//   - fp32 runs on the CUDA cores (FFMA).  A thread holds a register tile of
//     TR=2 units (6 gate rows) by TC <= 8 batch columns; KL lanes of a warp
//     and KG warp groups split K, so a warp's loads are distinct 16-byte
//     chunks; the k-lanes reduce by recursive-halving shuffles, the k-groups
//     through the stage just consumed.  TF32 on the tensor cores keeps about
//     three decimal digits, which would break the fp32 tolerance (1e-4) the
//     serving path is held to, and wgmma takes no fp32 input.
//   - bf16 runs on the tensor cores: mma.sync.m16n8k16 with w rows on the M
//     side and the batch on the N side (8 columns per MMA, so B=8 wastes
//     nothing), fragments by ldmatrix, fp32 accumulate.
//   - The projection never leaves the chip: each CTA keeps its fp32
//     [rows, 3U] slice in shared memory.  It writes per row its local mean
//     and centered sum of squares (mean_c, M2_c over its n_c = 3U columns)
//     to a small partials buffer [rows, CTAs], syncs the grid once
//     (cooperative launch, cooperative_groups grid sync: all CTAs are
//     co-resident, and the launch can be captured in a CUDA graph), and
//     merges all partials of each row with Chan's formula:
//       mean = sum n_c mean_c / N,  M2 = sum M2_c + sum n_c (mean_c - mean)^2,
//       rstd = rsqrt(M2 / N + eps)
//     so it never forms E[x^2] - E[x]^2.  Then it applies g, beta and the
//     gates to its own units and writes h'.
//   - Rows: the batch is walked in tiles of at most 128 rows inside the
//     kernel; the wrapper splits B into chunks whose projection slice fits
//     in shared memory, one launch per chunk (above 2,000 rows at S, about
//     250 at XL), each re-reading w.
// The launch plan (units, tiles, stages, shared memory) is computed by
// ops/ln_gru.py::_launch_plan and checked here; a plan this file cannot run
// returns cudaErrorInvalidValue.  The C entry point returns the first
// cudaGetLastError() that is not cudaSuccess, so a refused launch reaches
// the caller.  Built with -DLN_GRU_PHASES, thread 0 of each CTA records
// clock64() at seven points for ops/ln_gru_phases.py; otherwise the stamps
// compile to nothing.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kSegBytes = 128;  // K is moved in 128-byte segments (the swizzle span)
constexpr int kBoxAlign = 1024;  // a 128-byte swizzle repeats every 1024 bytes
constexpr int kMaxStages = 32;
constexpr int kMaxSegs = 255;  // segments per stage (a box dimension is at most 256)
constexpr int kBarrierBytes = 2 * kMaxStages * 8;
constexpr int kMaxBatchTile = 128;
constexpr int kMaxUnitBlock = 32;
constexpr int kMaxPartialsPerLane = 5;  // CTAs <= 160
constexpr int kRowsInFlight = 4;        // rows a warp merges at once

#ifdef LN_GRU_PHASES
// entry, first stage landed, products done, local statistics written, grid
// synced, rows merged, end
constexpr int kPhases = 7;
constexpr int kMaxPhaseCtas = 256;
__device__ unsigned long long g_phase[kMaxPhaseCtas * kPhases];
#define PHASE(i)                                                                                      \
  do {                                                                                                \
    if (threadIdx.x == 0 && blockIdx.x < kMaxPhaseCtas) g_phase[blockIdx.x * kPhases + (i)] = clock64(); \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align1024(size_t n) { return (n + kBoxAlign - 1) / kBoxAlign * kBoxAlign; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 3-D TMA load of one box into shared memory; completion counted in bytes
// on `bar`.  Coordinates are (element in segment, segment, row).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int seg, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(seg), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Shared address of segment n of a box written with the 128-byte swizzle
// (box base 1024-aligned), with the segment's swizzle phase folded in: the
// 16-byte chunk q of the segment is then at `seg_addr(box, n) ^ (q << 4)`.
__device__ __forceinline__ uint32_t seg_addr(uint32_t box, int n) {
  return box + n * kSegBytes + ((n & 7) << 4);
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// Barrier over the eight consumer warps only (the producer runs ahead).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory"); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  }
}

// Everything a launch needs; mirrors ops/ln_gru.py::_launch_plan.
struct Args {
  const void* joint;
  const void* w;
  const void* b;
  const void* g;
  const void* beta;
  const void* h;
  void* out;
  float2* partials;  // [rows, ctas] of (mean_c, M2_c)
  int rows;          // batch rows of this chunk
  int K;
  int H;
  float eps;
  int units;       // U: hidden units per CTA
  int ctas;        // ceil(H / U)
  int unit_block;  // UB = min(U, 32): units per pass
  int batch_tile;  // BT: batch rows per pass
  int groups;      // fp32: column groups CG (BT = TC * CG); bf16: 8-column tiles per pass
  int kgroups;     // consumer groups splitting each stage's K (fp32: warp groups)
  int klanes;      // fp32: lanes splitting K within a warp (KL)
  int unit_tile;   // fp32: units per thread (TR)
  int segs;        // CK: 128-byte segments of K per stage (odd)
  int stages;
  int smem_bytes;
};

// Floats per projection row in shared memory: 3U, padded to an odd count so
// that a thread per row reads distinct banks.
__host__ __device__ constexpr int proj_stride(int units) { return 3 * units + 1; }

// Shared memory: barriers | row (mean, rstd) | projection slice | ring.  A
// stage is three w boxes (one per gate) and one joint box, each starting on
// a 1024-byte boundary; the ring's start is aligned at run time, within the
// 1024 bytes of slack counted here.
struct Layout {
  size_t stats, proj, ring, gate_bytes, x_bytes, stage_bytes, total;
  uint32_t tx_bytes;  // bytes the four boxes of one stage deliver
};

__host__ __device__ inline Layout layout_of(const Args& a) {
  Layout l;
  const size_t seg_row = static_cast<size_t>(a.segs) * kSegBytes;
  l.stats = kBarrierBytes;
  l.proj = l.stats + align16(static_cast<size_t>(a.rows) * 8);
  l.ring = l.proj + align16(static_cast<size_t>(a.rows) * proj_stride(a.units) * 4);
  l.gate_bytes = align1024(a.unit_block * seg_row);
  l.x_bytes = align1024(a.batch_tile * seg_row);
  l.stage_bytes = 3 * l.gate_bytes + l.x_bytes;
  l.total = l.ring + kBoxAlign + a.stages * l.stage_bytes;
  l.tx_bytes = static_cast<uint32_t>((3 * a.unit_block + a.batch_tile) * seg_row);
  return l;
}

// First segment of a stage that k-group kg takes: k-groups take the
// segments whose index in the whole of K is kg mod KG.
__device__ __forceinline__ int first_seg(int seg0, int kg, int KG) { return ((kg - seg0 % KG) % KG + KG) % KG; }

// fp32 thread roles.  A thread holds a register tile of TR units (3*TR gate
// rows of w) by TC batch columns; KL lanes of a warp split K between them
// (k-lane fastest), and KG groups of warps split it further.  Units are
// j = rg + RGn*i and columns c = cg + CGn*t, interleaved so that lanes of
// neighbouring output groups read neighbouring rows.
struct Fp32Role {
  int kl, kg, rg, cg;
  bool active;
};

__device__ __forceinline__ Fp32Role fp32_role(int tid, int OG, int CGn, int KL, int KG) {
  const int og = (tid / KL) % OG;
  return {tid % KL, tid / (KL * OG), og / CGn, og % CGn, tid < KL * OG * KG};
}

// fp32 product of one stage on the CUDA cores.  Each 16-byte chunk of K that
// the thread takes costs 3*TR + TC shared loads for 12*TR*TC FMAs.  With
// KL >= 8 a quarter-warp reads eight chunks of one 128-byte segment (all 32
// banks); with KL < 8 it reads one chunk of neighbouring rows, which CK odd
// puts in different swizzle phases.
template <int TR, int TC>
__device__ __forceinline__ void fp32_stage(float (&v)[3 * TR * TC], uint32_t stage, const Layout& l, int seg0, int CK,
                                           const Fp32Role& role, int RGn, int CGn, int KL, int KG) {
  if (!role.active) return;
  const uint32_t xbox = stage + 3 * l.gate_bytes;
  int wrow[TR], xrow[TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) wrow[i] = (role.rg + RGn * i) * CK;
#pragma unroll
  for (int t = 0; t < TC; ++t) xrow[t] = (role.cg + CGn * t) * CK;
  // this thread's chunks of K are f = f0, f0 + M, ...: with M >= 8 one per
  // segment visited (same chunk q in each), with M < 8 several per segment
  const int M = KL * KG;
  const int f0 = ((role.kg * KL + role.kl - (8 * seg0) % M) % M + M) % M;
  const int seg_step = M >= 8 ? M / 8 : 1;
  const int q_count = M >= 8 ? 1 : 8 / M;
  for (int seg = f0 >> 3; seg < CK; seg += seg_step) {
    uint32_t wa[3 * TR], xa[TC];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
#pragma unroll
      for (int i = 0; i < TR; ++i) wa[gate * TR + i] = seg_addr(stage + gate * l.gate_bytes, wrow[i] + seg);
    }
#pragma unroll
    for (int t = 0; t < TC; ++t) xa[t] = seg_addr(xbox, xrow[t] + seg);
    for (int k = 0; k < q_count; ++k) {
      const uint32_t q = ((f0 & 7) + M * k) << 4;
      float4 wv[3 * TR];
#pragma unroll
      for (int r = 0; r < 3 * TR; ++r) wv[r] = lds128(wa[r] ^ q);
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        const float4 xv = lds128(xa[t] ^ q);
#pragma unroll
        for (int r = 0; r < 3 * TR; ++r) {
          float acc = v[r * TC + t];
          acc = fmaf(wv[r].x, xv.x, acc);
          acc = fmaf(wv[r].y, xv.y, acc);
          acc = fmaf(wv[r].z, xv.z, acc);
          acc = fmaf(wv[r].w, xv.w, acc);
          v[r * TC + t] = acc;
        }
      }
    }
  }
}

// Sum N values over the KL k-lanes of each output group by recursive
// halving: each round a lane keeps half of its values (the upper half if
// its bit `off` is set) plus its partner's copy of that half, so 32 lanes
// reduce 48 values in 24 + 12 + 6 + 3 + 3 shuffles.  When N turns odd the
// remaining rounds add all values (every lane keeps them).  Returns the
// rounds that halved: lane kl then holds values [base, base + N >> h) with
// base = sum over r < h of bit r of kl times (N >> (r + 1)).
template <int N, int NV>
__device__ __forceinline__ int halve_lanes(float (&v)[NV], int kl, int KL, int off) {
  if constexpr (N % 2 == 0) {
    if (off < KL) {
      const bool upper = (kl & off) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      return 1 + halve_lanes<N / 2, NV>(v, kl, KL, off << 1);
    }
    return 0;
  } else {
    for (; off < KL; off <<= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
    return 0;
  }
}

// bf16 product of one stage on the tensor cores: warp task (mt, ng) covers
// w rows [16 mt, 16 mt + 16) of the stage (row gate*UB + j) against NW
// 8-column tiles starting at tile ng*NW.  Fragments come from ldmatrix: for
// A the lane gives row lane%16 at k-half lane/16; for B (x4: two 8-column
// tiles) row lane%8 of tile 2p + lane/16 at k-half (lane/8)%2.  A 128-byte
// segment holds four k16 blocks (16-byte chunks 2kk and 2kk+1).
template <int NW>
__device__ __forceinline__ void bf16_stage(float (&acc)[NW][4], uint32_t stage, const Layout& l, int seg0, int CK,
                                           int UB, int BT, int mt, int ng, int n_tiles, int KG, int kg, int lane) {
  constexpr int kPairs = (NW + 1) / 2;
  const uint32_t xbox = stage + 3 * l.gate_bytes;
  // rows past 3*UB pad the last 16-row tile: read a real row, drop the result
  const int ra = min(mt * 16 + (lane & 15), 3 * UB - 1);
  const uint32_t abox = stage + (ra / UB) * l.gate_bytes;
  const int ja = ra % UB;
  const uint32_t a_half = (lane >> 4) << 4;
  const uint32_t b_half = ((lane >> 3) & 1) << 4;
  for (int seg = first_seg(seg0, kg, KG); seg < CK; seg += KG) {
    const uint32_t a_base = seg_addr(abox, ja * CK + seg) ^ a_half;
    uint32_t b_base[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int row = min((ng * NW + 2 * p + (lane >> 4)) * 8 + (lane & 7), BT - 1);
      b_base[p] = seg_addr(xbox, row * CK + seg) ^ b_half;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_base ^ ((2 * kk) << 4));
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        uint32_t b[4];
        if constexpr (NW == 1) {
          ldsm_x2(b, b_base[p] ^ ((2 * kk) << 4));
        } else {
          ldsm_x4(b, b_base[p] ^ ((2 * kk) << 4));
        }
        if (ng * NW + 2 * p < n_tiles) mma_bf16(acc[2 * p], a, b[0], b[1]);
        if constexpr (NW > 1) {
          if (ng * NW + 2 * p + 1 < n_tiles) mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

template <typename T, int V, int TR>
__global__ void __launch_bounds__(kThreads, 1)
    ln_gru_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map, const Args a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout_of(a);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float2* row_stats = reinterpret_cast<float2*>(smem + l.stats);
  float* proj = reinterpret_cast<float*>(smem + l.proj);
  const uint32_t ring = static_cast<uint32_t>(align1024(smem_u32(smem) + l.ring));

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int B = a.rows, H = a.H, U = a.units, UB = a.unit_block, BT = a.batch_tile, CK = a.segs;
  const int PS = proj_stride(U);
  const int u0 = blockIdx.x * U;
  const int Uv = min(U, H - u0);  // ragged last CTA
  const int n_bt = cdiv(B, BT);
  const int n_slab = cdiv(static_cast<int>(a.K * sizeof(T) / kSegBytes), CK);
  const int jobs = cdiv(Uv, UB) * n_bt * n_slab;
  const int NS = a.stages;
  PHASE(0);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: stage job = (unit block, batch tile, K slab); boxes past the
    // last row or segment of a tensor are filled with zeros by the TMA unit
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&x_map)) : "memory");
      for (int job = 0; job < jobs; ++job) {
        const int s = job % NS;
        const int round = job / NS;
        const int pass = job / n_slab;
        const int seg = (job % n_slab) * CK;
        const int ub = pass / n_bt;
        const int bt = pass % n_bt;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_expect_tx(&full[s], l.tx_bytes);
        const uint32_t dst = ring + s * l.stage_bytes;
        for (int gate = 0; gate < 3; ++gate)
          tma_load(dst + gate * l.gate_bytes, &w_map, seg, gate * H + u0 + ub * UB, &full[s]);
        tma_load(dst + 3 * l.gate_bytes, &x_map, seg, bt * BT, &full[s]);
      }
    }
  } else {
    // consumers: products into registers, each pass reduced into `proj`
    const int KG = a.kgroups;
    // bf16: V MMA tiles of 4 per lane; fp32: 3*TR gate rows x TC columns
    std::conditional_t<kBf16, float[V][4], float[3 * TR * V]> acc;
    const int RGn = UB / TR, CGn = a.groups, KL = a.klanes;
    const Fp32Role role = fp32_role(tid, RGn * CGn, CGn, KL, KG);
    int mt = 0, ng = 0, kg = 0, n_tiles = 0;
    bool active = true;
    if (kBf16) {
      const int wpk = kConsumerWarps / KG;  // warps per k-group
      const int task = warp % wpk;
      kg = warp / wpk;
      n_tiles = cdiv(BT, 8);
      const int groups = cdiv(n_tiles, V);
      mt = task / groups;
      ng = task % groups;
      active = mt < cdiv(3 * UB, 16);
    }
    for (int job = 0; job < jobs; ++job) {
      const int s = job % NS;
      const int round = job / NS;
      const int slab = job % n_slab;
      const int pass = job / n_slab;
      const int ub = pass / n_bt;
      const int bt = pass % n_bt;
      if (slab == 0) zero(acc);
      mbar_wait(&full[s], round & 1);
      if (job == 0) PHASE(1);
      const uint32_t stage = ring + s * l.stage_bytes;
      if constexpr (kBf16) {
        if (active) bf16_stage<V>(acc, stage, l, slab * CK, CK, UB, BT, mt, ng, n_tiles, KG, kg, lane);
      } else {
        fp32_stage<TR, V>(acc, stage, l, slab * CK, CK, role, RGn, CGn, KL, KG);
      }

      if (slab == n_slab - 1) {
        // the pass is complete: sum over k-groups into proj
        const int units_here = min(UB, Uv - ub * UB);
        if constexpr (kBf16) {
          // k-groups are warps: they add in order, one barrier each
          for (int q = 0; q < KG; ++q) {
            if (active && kg == q) {
#pragma unroll
              for (int n = 0; n < V; ++n) {
                const int nt = ng * V + n;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int rr = mt * 16 + lane / 4 + (e >= 2 ? 8 : 0);  // row of the stage's w rows
                  const int col = nt * 8 + 2 * (lane % 4) + (e & 1);
                  const int gate = rr / UB;
                  const int j = rr % UB;
                  const int brow = bt * BT + col;
                  if (nt < n_tiles && gate < 3 && j < units_here && col < BT && brow < B) {
                    float* p = proj + static_cast<size_t>(brow) * PS + gate * U + ub * UB + j;
                    *p = (q == 0 ? 0.f : *p) + acc[n][e];
                  }
                }
              }
            }
            consumer_sync();
          }
        } else {
          // sum the k-lanes of each output group by shuffles
          constexpr int NV = 3 * TR * V;
          const int h = halve_lanes<NV, NV>(acc, role.kl, KL, 1);
          const int nh = NV >> h;
          int base = 0;
          for (int r = 0; r < h; ++r) base += ((role.kl >> r) & 1) * (NV >> (r + 1));
          const bool holder = role.active && (role.kl >> h) == 0;  // distinct value sets
          const int OG = RGn * CGn;
          const int og = role.rg * CGn + role.cg;
          // output (og, idx), idx = (gate * TR + unit) * TC + column, into proj
          auto put = [&](int o_g, int idx, float value) {
            const int rg = o_g / CGn, cg = o_g % CGn;
            const int gr = idx / V;
            const int j = rg + RGn * (gr % TR);
            const int brow = bt * BT + cg + CGn * (idx % V);
            if (j < units_here && brow < B) proj[static_cast<size_t>(brow) * PS + (gr / TR) * U + ub * UB + j] = value;
          };
          if (KG == 1) {
            if (holder) {
#pragma unroll
              for (int i = 0; i < NV; ++i) {
                if (i >= nh) break;
                put(og, base + i, acc[i]);
              }
            }
          } else {
            // k-groups meet in the stage just consumed (released to the
            // producer only afterwards); all consumers then add them in order
            float* scratch = reinterpret_cast<float*>(smem + (stage - smem_u32(smem)));
            consumer_sync();  // every k-group is done reading the stage
            if (holder) {
#pragma unroll
              for (int i = 0; i < NV; ++i) {
                if (i >= nh) break;
                scratch[(role.kg * OG + og) * NV + base + i] = acc[i];
              }
            }
            consumer_sync();
            for (int o = tid; o < OG * NV; o += kConsumers) {
              float sum = 0.f;
              for (int q = 0; q < KG; ++q) sum += scratch[q * OG * NV + o];
              put(o / NV, o % NV, sum);
            }
            consumer_sync();
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    consumer_sync();
    PHASE(2);

    // bias, then each row's local statistics over this CTA's 3*Uv columns:
    // a group of lpr lanes per row (as many rows at once as threads allow)
    const T* bias = static_cast<const T*>(a.b);
    const float inv_n_c = 1.f / (3.f * Uv);
    int lpr = 32;
    while (lpr > 1 && lpr * B > kConsumers) lpr >>= 1;
    const int row_groups = kConsumers / lpr;
    for (int r0 = 0; r0 < B; r0 += row_groups) {
      const int r = r0 + tid / lpr;
      const int sub = tid % lpr;
      float* pr = proj + static_cast<size_t>(r) * PS;
      float sum = 0.f;
      if (r < B) {
        for (int gate = 0; gate < 3; ++gate) {
          for (int j = sub; j < Uv; j += lpr) {
            float v = pr[gate * U + j];
            if (bias != nullptr) {
              v += to_float(bias[gate * H + u0 + j]);
              pr[gate * U + j] = v;
            }
            sum += v;
          }
        }
      }
      for (int off = 1; off < lpr; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float mean_c = sum * inv_n_c;
      float m2 = 0.f;
      if (r < B) {
        for (int gate = 0; gate < 3; ++gate) {
          for (int j = sub; j < Uv; j += lpr) {
            const float d = pr[gate * U + j] - mean_c;
            m2 = fmaf(d, d, m2);
          }
        }
      }
      for (int off = 1; off < lpr; off <<= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, off);
      if (r < B && sub == 0) a.partials[static_cast<size_t>(r) * a.ctas + blockIdx.x] = make_float2(mean_c, m2);
    }
  }

  PHASE(3);
  // gate inputs of this thread's first element, loaded before the exchange
  const T* g = static_cast<const T*>(a.g);
  const T* beta = static_cast<const T*>(a.beta);
  const T* h = static_cast<const T*>(a.h);
  float first[7] = {};  // g x3, beta x3, h
  if (tid < B * Uv) {
    const int u = u0 + tid % Uv;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      first[gate] = to_float(g[gate * H + u]);
      first[3 + gate] = to_float(beta[gate * H + u]);
    }
    first[6] = to_float(h[static_cast<size_t>(tid / Uv) * H + u]);
  }

  // the one exchange: every CTA's partials are written before any is merged
  cg::this_grid().sync();
  PHASE(4);

  // Chan's merge of each row's partials: mean = sum n_c mean_c / N, then
  // M2 = sum M2_c + sum n_c (mean_c - mean)^2.  A warp per row, lanes over
  // CTAs (coalesced), kRowsInFlight rows' partials read in one round trip.
  const float n_total = 3.f * H;
  // rows spread over the warps first: warp w takes rows w, w + 9, w + 18, ...
  for (int r0 = warp; r0 < B; r0 += kWarps * kRowsInFlight) {
    float2 part[kRowsInFlight][kMaxPartialsPerLane];
#pragma unroll
    for (int rr = 0; rr < kRowsInFlight; ++rr) {
      const int r = r0 + rr * kWarps;
#pragma unroll
      for (int k = 0; k < kMaxPartialsPerLane; ++k) {
        const int c = lane + 32 * k;
        part[rr][k] = (r < B && c < a.ctas) ? __ldcg(a.partials + static_cast<size_t>(r) * a.ctas + c)
                                            : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsInFlight; ++rr) {
      const int r = r0 + rr * kWarps;
      if (r >= B) break;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxPartialsPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < a.ctas) sum += 3.f * min(U, H - c * U) * part[rr][k].x;
      }
      const float mean = warp_sum(sum) / n_total;
      float m2 = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxPartialsPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < a.ctas) {
          const float d = part[rr][k].x - mean;
          m2 += part[rr][k].y + 3.f * min(U, H - c * U) * d * d;
        }
      }
      m2 = warp_sum(m2);
      if (lane == 0) row_stats[r] = make_float2(mean, rsqrtf(m2 / n_total + a.eps));
    }
  }
  __syncthreads();
  PHASE(5);

  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < B * Uv; i += kThreads) {
    const int r = i / Uv;
    const int j = i % Uv;
    const int u = u0 + j;
    const size_t o = static_cast<size_t>(r) * H + u;
    float in[7];
    if (i == tid) {
#pragma unroll
      for (int e = 0; e < 7; ++e) in[e] = first[e];
    } else {
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        in[gate] = to_float(g[gate * H + u]);
        in[3 + gate] = to_float(beta[gate * H + u]);
      }
      in[6] = to_float(h[o]);
    }
    const float2 st = row_stats[r];
    const float* pr = proj + static_cast<size_t>(r) * PS;
    const float nr = (pr[j] - st.x) * st.y * in[0] + in[3];
    const float nc = (pr[U + j] - st.x) * st.y * in[1] + in[4];
    const float nu = (pr[2 * U + j] - st.x) * st.y * in[2] + in[5];
    const float reset = sigmoid(nr);
    const float cand = tanhf(reset * nc);
    const float update = sigmoid(nu - 1.f);
    store(out + o, update * cand + (1.f - update) * in[6]);
  }
  PHASE(6);
}

bool plan_ok(const Args& a, bool bf16, int V, size_t elem) {
  if (a.rows <= 0 || a.K <= 0 || a.H <= 0 || a.units <= 0) return false;
  if (a.ctas > 32 * kMaxPartialsPerLane) return false;
  if ((a.units & (a.units - 1)) != 0 || a.ctas != cdiv(a.H, a.units)) return false;
  if (a.unit_block != (a.units < kMaxUnitBlock ? a.units : kMaxUnitBlock)) return false;
  if (a.batch_tile <= 0 || a.batch_tile > kMaxBatchTile) return false;
  if (a.stages <= 0 || a.stages > kMaxStages) return false;
  if (a.kgroups <= 0 || (a.kgroups & (a.kgroups - 1)) != 0) return false;
  if ((static_cast<size_t>(a.K) * elem) % kSegBytes != 0 || a.segs <= 0 || a.segs > kMaxSegs) return false;
  if (reinterpret_cast<uintptr_t>(a.joint) % 16 != 0 || reinterpret_cast<uintptr_t>(a.w) % 16 != 0) return false;
  if (bf16) {
    // one warp task per (16-row tile, group of V 8-column tiles), per k-group
    if (a.batch_tile % 8 != 0 || a.kgroups > 4 || a.groups != V) return false;
    const int tasks = cdiv(3 * a.unit_block, 16) * cdiv(a.batch_tile / 8, V);
    if (tasks * a.kgroups > kConsumerWarps) return false;
  } else {
    // register tiles TR x TC cover the pass; KL * KG threads per tile
    const int TR = a.unit_tile;
    if (a.groups <= 0 || a.groups * V != a.batch_tile || TR <= 0 || a.unit_block % TR != 0) return false;
    const int OG = a.unit_block / TR * a.groups;
    if (a.klanes <= 0 || a.klanes > 32 || (a.klanes & (a.klanes - 1)) != 0) return false;
    if (OG * a.klanes * a.kgroups != kConsumers) return false;  // every partial sum has its thread
    // k-groups reduce through one stage's shared memory
    if (a.kgroups > 1 && static_cast<size_t>(a.kgroups) * OG * 3 * TR * V * 4 > layout_of(a).stage_bytes) return false;
  }
  return layout_of(a).total <= static_cast<size_t>(a.smem_bytes);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no link against libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, K] tensor seen as [rows][K / seg][seg] (seg = one
// 128-byte segment), read in boxes of [box_rows][CK][seg] with the 128-byte
// swizzle.  Coordinates past an edge read zeros.
cudaError_t make_map(CUtensorMap* map, bool bf16, const void* ptr, int rows, int K, int box_rows, int CK) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t seg = kSegBytes / elem;
  const cuuint64_t dims[3] = {seg, static_cast<cuuint64_t>(K) / seg, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {kSegBytes, static_cast<cuuint64_t>(K) * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(seg), static_cast<cuuint32_t>(CK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                            const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int V, int TR>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (!plan_ok(a, kBf16, V, sizeof(T)) || a.unit_tile != TR) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ln_gru_kernel<T, V, TR>;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // raise the dynamic shared-memory ceiling once per instantiation, before
  // any launch above 48 KB (and before any stream capture)
  static int configured_for = -1;
  if (configured_for != device) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_for = device;
  }
  int per_sm = 0;
  int sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, a.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.ctas > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  CUtensorMap w_map, x_map;
  err = make_map(&w_map, kBf16, a.w, 3 * a.H, a.K, a.unit_block, a.segs);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_map(&x_map, kBf16, a.joint, a.rows, a.K, a.batch_tile, a.segs);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args args = a;
  void* params[] = {&w_map, &x_map, &args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(a.ctas), dim3(kThreads), params,
                                    static_cast<size_t>(a.smem_bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// fp32: TR units x TC columns per thread; bf16: NW 8-column tiles per warp
int dispatch_fp32(int tc, const Args& a, cudaStream_t stream) {
  const bool pair = a.unit_tile == 2;
  switch (tc) {
    case 1: return pair ? launch<float, 1, 2>(a, stream) : launch<float, 1, 1>(a, stream);
    case 2: return pair ? launch<float, 2, 2>(a, stream) : launch<float, 2, 1>(a, stream);
    case 4: return pair ? launch<float, 4, 2>(a, stream) : launch<float, 4, 1>(a, stream);
    case 8: return pair ? launch<float, 8, 2>(a, stream) : launch<float, 8, 1>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(int nw, const Args& a, cudaStream_t stream) {
  switch (nw) {
    case 1: return launch<__nv_bfloat16, 1, 1>(a, stream);
    case 2: return launch<__nv_bfloat16, 2, 1>(a, stream);
    case 4: return launch<__nv_bfloat16, 4, 1>(a, stream);
    case 8: return launch<__nv_bfloat16, 8, 1>(a, stream);
    case 16: return launch<__nv_bfloat16, 16, 1>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `b` may be null (no bias).  `partials`
// is an fp32 [rows, ctas, 2] buffer.  The plan (units ... smem_bytes) comes
// from ops/ln_gru.py::_launch_plan; `vec` is TC (fp32: batch columns per
// thread) or NW (bf16: 8-column MMA tiles per warp); `klanes` and
// `unit_tile` (fp32) the lanes splitting K and the units per thread; `segs`
// the 128-byte segments of K per stage.  Returns 0 or a
// cudaError_t code.
extern "C" int ln_gru_forward(int dtype, const void* joint, const void* w, const void* b, const void* g,
                              const void* beta, const void* h, void* out, float* partials, int rows, int K, int H,
                              float eps, int units, int ctas, int unit_block, int batch_tile, int vec, int groups,
                              int kgroups, int klanes, int unit_tile, int segs, int stages, int smem_bytes,
                              void* stream) {
  Args a{joint, w, b, g, beta, h, out, reinterpret_cast<float2*>(partials), rows, K, H, eps, units, ctas,
         unit_block, batch_tile, groups, kgroups, klanes, unit_tile, segs, stages, smem_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fp32(vec, a, s);
  if (dtype == 1) return dispatch_bf16(vec, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The card's SM count and the shared memory one block may opt in to.
extern "C" int ln_gru_device_limits(int device, int* sm_count, int* smem_per_block) {
  cudaError_t err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

extern "C" const char* ln_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef LN_GRU_PHASES
// The stamps of the last launch: [ctas][7] clock64() values of thread 0.
extern "C" int ln_gru_phases(unsigned long long* out, int ctas) {
  if (ctas <= 0 || ctas > kMaxPhaseCtas) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * kPhases * static_cast<size_t>(ctas)));
}
#endif
