// Fused fusion-classifier head for Hopper (sm_90a):
// logits = dropout(relu(x @ W1^T + b1)) @ W2^T + b2, with the hidden
// activation kept on chip unless the caller asks for it.
//
// Replaces surya_tpu/ops/pallas/fusion_head.py::_fusion_head_kernel, both
// forms: the inference form (rate 0, no h output; the TRAIN = false
// instantiations) and the training form with in-kernel dropout and the
// post-dropout h written out as the backward's residual. Numerics follow
// the Pallas kernel: f32 accumulation, b1 added in f32, a unit kept iff its
// 32 random bits >= threshold = min(round(rate * 2^32), 2^32 - 1), kept
// units scaled by 1/(1 - rate) in f32, then h rounded to the compute dtype
// before the second product, f32 logits.
//
// Random bits: Philox4x32-10 keyed by the 64-bit seed (read from device
// memory, so the host never waits for it), counter (row, hidden unit, 0, 0),
// first output word; the row is the global batch's (a data-parallel rank
// passes its first row as row_offset). The mask is a pure function of
// (seed, row, unit): it does not depend on the tiling or on the ranks. The TPU kernel seeds its hardware generator
// per batch block; those bits cannot be reproduced here, only their law.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): the head reads W1
// (2688 x 5376, 28.9 MB in bf16) once and does 1.9 GFLOP at B=64, 7.4 at
// B=256, so it is bound by W1's bytes: 0.0088 ms at B=64, 0.0099 ms at
// B=256 with the h output. The TPU kernel holds all of W1 in VMEM per batch
// block; 227 KB of shared memory cannot.
//
// bf16 body (Hopper): x (B, D) is wgmma's A operand and W1 (H, D) its B
// operand, both K-major, both brought in by TMA with a 128-byte swizzle
// into an mbarrier ring; one producer thread issues the loads (the rest
// of its warp fetches the block's slice of W2 meanwhile), one to four
// consumer warpgroups (one m64 slice each) run wgmma m64n128k16 with f32
// accumulators in registers, one group of products in flight while the
// next stage lands. A tile is 64 (B <= 64), 128 or 256 rows x 128 hidden
// units, so x is read H / 128 = 21 times, not once per 16 units. 21 or 42
// tiles cannot fill 132 SMs, so the K loop is split over a thread-block
// cluster of up to 8 blocks (168 blocks at B=64, 84 at B=256): each rank
// multiplies its share of K, the f32 partial tiles meet in distributed
// shared memory and rank r sums its 128/split columns in rank order
// (fixed order, no atomics). Its epilogue adds b1, applies ReLU and
// dropout, rounds h once (written with 16-byte stores in the training
// form) and multiplies it by its slice of W2 into f32 partial logits, a
// thread per row; a second small launch sums the partials in a fixed
// order (one warp per logit) and adds b2. The dropout bits of each
// thread's epilogue elements are drawn before its K loop, while the
// first loads are in flight. TMA's zero fill covers ragged
// B, H and D. h never reaches device memory in the inference form.
// f32 body: CUDA-core FMA over 16-unit tiles, for exact f32 parity checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int HT = 16;  // hidden units per block of the f32 body

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3"): counter (row, unit, 0, 0), key (seed low, seed high); returns
// the first of the four output words.
__device__ __forceinline__ unsigned philox_bits(unsigned long long seed,
                                                unsigned row, unsigned unit) {
  unsigned c0 = row, c1 = unit, c2 = 0u, c3 = 0u;
  unsigned k0 = static_cast<unsigned>(seed);
  unsigned k1 = static_cast<unsigned>(seed >> 32);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// What the training form adds to a launch; all unused when TRAIN is false.
struct TrainArgs {
  void* h_out;                  // (B, H) in the compute dtype, or null
  const long long* seed;        // device scalar; read only if threshold > 0
  unsigned threshold;           // keep iff bits >= threshold; 0 = no dropout
  float scale;                  // 1 / (1 - rate)
  int row_offset;               // global row of x's first row (Philox)
};

// ---- f32: CUDA-core FMA (exact f32 products, for parity checks) ---------
// Epilogue of one 16-unit tile. hs: (rows, HT) f32 pre-activations in
// shared memory. Writes partial[(tile*B + row)*C + c] = sum_j h[row][j] *
// w2[c][h0+j].
template <bool TRAIN>
__device__ void head_epilogue(float* hs, int rows,
                              const float* __restrict__ b1,
                              const float* __restrict__ w2,
                              float* __restrict__ partial, int row0, int B,
                              int H, int C, TrainArgs ta) {
  const int h0 = blockIdx.x * HT;
  for (int idx = threadIdx.x; idx < rows * HT; idx += blockDim.x) {
    const int r = idx / HT, j = idx % HT;
    float h = 0.f;
    if (h0 + j < H) {
      h = fmaxf(hs[idx] + b1[h0 + j], 0.f);
      if constexpr (TRAIN) {
        if (ta.threshold != 0u && h > 0.f) {
          const unsigned bits =
              philox_bits(static_cast<unsigned long long>(*ta.seed),
                          static_cast<unsigned>(ta.row_offset + row0 + r),
                          static_cast<unsigned>(h0 + j));
          h = bits >= ta.threshold ? h * ta.scale : 0.f;
        }
        if (ta.h_out != nullptr && row0 + r < B)
          static_cast<float*>(ta.h_out)[static_cast<size_t>(row0 + r) * H +
                                        h0 + j] = h;
      }
    }
    hs[idx] = h;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    if (row0 + r >= B) continue;
    float s = 0.f;
    for (int j = 0; j < HT && h0 + j < H; ++j)
      s = fmaf(hs[r * HT + j], w2[static_cast<size_t>(c) * H + h0 + j], s);
    partial[(static_cast<size_t>(blockIdx.x) * B + row0 + r) * C + c] = s;
  }
}

constexpr int RB32 = 32;  // rows per block
constexpr int KC32 = 64;

template <bool TRAIN>
__global__ void __launch_bounds__(128)
head_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                float* __restrict__ partial, int B, int D, int H, int C,
                TrainArgs ta) {
  __shared__ float xs[RB32][KC32 + 1];
  __shared__ float ws[HT][KC32 + 1];
  __shared__ float hs[RB32 * HT];
  const int h0 = blockIdx.x * HT, row0 = blockIdx.y * RB32;
  const int j = threadIdx.x % HT, r0 = threadIdx.x / HT;  // r0 in 0..7
  float acc[RB32 / 8] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < D; k0 += KC32) {
    for (int idx = threadIdx.x; idx < RB32 * KC32; idx += blockDim.x) {
      const int r = idx / KC32, k = idx % KC32;
      xs[r][k] = (row0 + r < B && k0 + k < D)
                     ? x[static_cast<size_t>(row0 + r) * D + k0 + k]
                     : 0.f;
    }
    for (int idx = threadIdx.x; idx < HT * KC32; idx += blockDim.x) {
      const int r = idx / KC32, k = idx % KC32;
      ws[r][k] = (h0 + r < H && k0 + k < D)
                     ? w1[static_cast<size_t>(h0 + r) * D + k0 + k]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC32; ++k) {
      const float wv = ws[j][k];
#pragma unroll
      for (int i = 0; i < RB32 / 8; ++i)
        acc[i] = fmaf(xs[r0 + 8 * i][k], wv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RB32 / 8; ++i) hs[(r0 + 8 * i) * HT + j] = acc[i];
  __syncthreads();
  head_epilogue<TRAIN>(hs, RB32, b1, w2, partial, row0, B, H, C, ta);
}

// ---- bf16: wgmma tensor cores fed by TMA, split-K over a cluster ----------
using namespace hopper;
constexpr int WG_BN = 128;            // hidden units per tile: wgmma N
constexpr int WG_BK = 64;             // K per stage: one 128-byte row
constexpr int WG_BUDGET = 96 * 1024;  // ring bytes: two blocks fit an SM
constexpr int WG_MAX_THREADS = 4 * 128 + 32;
constexpr int WG_W2C = 8;             // classes of W2 staged at once

struct HeadPlan {
  int bm, wgs, threads, row_tiles, n_tiles, split, k_steps, stages;
  int stage_bytes, w2_off, bar_off, smem;
};

// grid (n_tiles * split, row_tiles), cluster (split, 1, 1). Block rank r
// of a cluster multiplies K steps [r*k/split, (r+1)*k/split) of its tile.
// The f32 sums meet in shared memory: after a cluster barrier, rank r adds
// the split partial tiles of its 128/split columns in rank order (fixed,
// no atomics), then runs the epilogue on them: b1, ReLU, dropout, h
// rounded (and written with 16-byte stores), h times its slice of W2 into
// the partial logits of slot ntile * split + r.
template <bool TRAIN>
__global__ void __launch_bounds__(WG_MAX_THREADS)
head_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  float* __restrict__ partial, int B, int H, int C,
                  HeadPlan p, TrainArgs ta) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  float* w2s = reinterpret_cast<float*>(smem + p.w2_off);  // (8, 128)
  uint64_t* empty = full + p.stages;
  const int rank = p.split > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int ntile = blockIdx.x / p.split;
  const int row0 = blockIdx.y * p.bm, n0 = ntile * WG_BN;
  const int k_begin = rank * p.k_steps / p.split;
  const int k_end = (rank + 1) * p.k_steps / p.split;
  const int tid = threadIdx.x, nthr = p.wgs * 128;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], p.wgs);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int cols = WG_BN / p.split, c0 = rank * cols;
  const int ncols = min(cols, H - n0 - c0);  // may be <= 0 past H
  // accumulator element i of consumer thread tid: row wg*64 + warp*16 +
  // lane/4 (+8 for odd i/2), column (i/4)*8 + (lane%4)*2 + i%2; after the
  // reduction this thread owns elements i in [rank, rank + 1) * 64/split
  const int lane = tid % 32;
  const int rbase = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int per = 16 / p.split;  // float4 groups of elements it owns
  // dropout: the keep bits of those elements, drawn while the first loads
  // are in flight, so that Philox stays off the epilogue's path
  unsigned long long keep = 0ull;
  if constexpr (TRAIN) {
    if (ta.threshold != 0u && tid < nthr) {
      const unsigned long long seed = static_cast<unsigned long long>(*ta.seed);
      for (int e = 0; e < 4 * per; ++e) {
        const int i = 4 * rank * per + e;
        const unsigned bits = philox_bits(
            seed,
            static_cast<unsigned>(ta.row_offset + row0 + rbase +
                                  8 * ((i >> 1) & 1)),
            static_cast<unsigned>(n0 + (i >> 2) * 8 + (lane & 3) * 2 +
                                  (i & 1)));
        keep |= static_cast<unsigned long long>(bits >= ta.threshold) << e;
      }
    }
  }
  if (tid >= nthr) {  // producer warp: one thread keeps the ring full
    if (tid > nthr) {
      // the others fetch this rank's slice of W2 (first 8 classes) now,
      // so the epilogue finds it on chip
      for (int idx = tid - nthr - 1; idx < WG_W2C * cols; idx += 31) {
        const int c = idx / cols, j = idx % cols;
        w2s[c * WG_BN + j] =
            c < C && j < ncols
                ? __bfloat162float(w2[static_cast<size_t>(c) * H + n0 + c0 + j])
                : 0.f;
      }
    } else {
      for (int k = k_begin, i = 0; k < k_end; ++k, ++i) {
        const int s = i % p.stages;
        mbar_wait(&empty[s], ((i / p.stages) & 1) ^ 1);
        unsigned char* st = smem + s * p.stage_bytes;
        mbar_expect_tx(&full[s], p.stage_bytes);
        tma_load_2d(st, &xmap, &full[s], k * WG_BK, row0);
        tma_load_2d(st + p.bm * 128, &wmap, &full[s], k * WG_BK, n0);
      }
    }
  } else {  // consumer warpgroup wg: rows wg*64 .. +63 of the tile
    const int wg = tid / 128;
    for (int k = k_begin, i = 0; k < k_end; ++k, ++i) {
      const int s = i % p.stages;
      mbar_wait(&full[s], (i / p.stages) & 1);
      const unsigned char* st = smem + s * p.stage_bytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart; a k16
        // step moves 32 bytes along the swizzled row
        const uint64_t da =
            wgmma_desc(st + wg * 64 * 128 + kk * 32, 16, 1024, 1);
        const uint64_t db = wgmma_desc(st + p.bm * 128 + kk * 32, 16, 1024, 1);
        wgmma_ss_n128(acc, da, db);
      }
      wgmma_commit();
      // keep this stage's products in flight; the previous stage's are
      // done, so its slot goes back to the producer
      wgmma_wait<1>();
      fence_regs(acc);
      if (i > 0 && tid % 128 == 0) mbar_arrive(&empty[(i - 1) % p.stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  __syncthreads();  // the ring is read out: reuse it

  // red: the block's f32 tile as float4 groups of accumulator registers,
  // [16][nthr]; hs: the rounded h of this rank's columns, (bm, cols) bf16
  // at a pitch of cols + 8
  float4* red = reinterpret_cast<float4*>(smem);
  const int hp = cols + 8;
  bf16* hs = reinterpret_cast<bf16*>(smem + 64 * nthr * 4);
  if (tid < nthr) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      red[j * nthr + tid] = make_float4(acc[4 * j], acc[4 * j + 1],
                                        acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (p.split > 1) cluster_sync(); else __syncthreads();
  if (tid < nthr) {
    const float4* part[8];  // the red tile of each K rank of this tile
#pragma unroll
    for (int r = 0; r < 8; ++r)
      part[r] = r < p.split ? static_cast<const float4*>(
                                  __cluster_map_shared_rank(red, r))
                            : red;
    for (int j = rank * per; j < (rank + 1) * per; ++j) {
      float4 got[8];  // all loads first, then the sum in rank order
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < p.split) got[r] = part[r][j * nthr + tid];
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < p.split) {
          v[0] += got[r].x;
          v[1] += got[r].y;
          v[2] += got[r].z;
          v[3] += got[r].w;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int row = rbase + 8 * ((i >> 1) & 1);
        const int col = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        float h = 0.f;
        if (n0 + col < H) {
          h = fmaxf(v[e] + b1[n0 + col], 0.f);
          if constexpr (TRAIN) {
            if (ta.threshold != 0u && h > 0.f)
              h = (keep >> (4 * (j - rank * per) + e)) & 1ull ? h * ta.scale
                                                              : 0.f;
          }
        }
        hs[row * hp + col - c0] = __float2bfloat16(h);
      }
    }
  }
  // remote reads of red are done, hs is complete
  if (p.split > 1) cluster_sync(); else __syncthreads();

  if constexpr (TRAIN) {
    if (ta.h_out != nullptr) {
      bf16* hout = static_cast<bf16*>(ta.h_out);
      const int segs = cols / 8;
      for (int idx = tid; idx < p.bm * segs; idx += blockDim.x) {
        const int r = idx / segs, g = n0 + c0 + (idx % segs) * 8;
        if (row0 + r >= B || g >= H) continue;
        const bf16* src = hs + r * hp + (idx % segs) * 8;
        bf16* dst = hout + static_cast<size_t>(row0 + r) * H + g;
        if (H % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < 8 && g + j < H; ++j) dst[j] = src[j];
        }
      }
    }
  }
  // partial logits: a thread per row, WG_W2C classes at a time, summed
  // over this rank's columns in order
  const int slot = ntile * p.split + rank;
  for (int cb = 0; cb < C; cb += WG_W2C) {
    if (cb > 0) {  // more than WG_W2C classes: stage the next ones here
      __syncthreads();
      for (int idx = tid; idx < WG_W2C * cols; idx += blockDim.x) {
        const int c = idx / cols, j = idx % cols;
        w2s[c * WG_BN + j] =
            cb + c < C && j < ncols
                ? __bfloat162float(
                      w2[static_cast<size_t>(cb + c) * H + n0 + c0 + j])
                : 0.f;
      }
      __syncthreads();
    }
    for (int r = tid; r < p.bm; r += blockDim.x) {
      if (row0 + r >= B) continue;
      float a[WG_W2C];
#pragma unroll
      for (int c = 0; c < WG_W2C; ++c) a[c] = 0.f;
      for (int j = 0; j < ncols; ++j) {
        const float h = __bfloat162float(hs[r * hp + j]);
#pragma unroll
        for (int c = 0; c < WG_W2C; ++c)
          a[c] = fmaf(h, w2s[c * WG_BN + j], a[c]);
      }
      float* dst = partial + (static_cast<size_t>(slot) * B + row0 + r) * C;
#pragma unroll
      for (int c = 0; c < WG_W2C; ++c)
        if (cb + c < C) dst[cb + c] = a[c];
    }
  }
}

// How many clusters of `split` blocks of this plan can be resident at once
// (clusters must fit inside one GPC), asked of the runtime once per shape
// class and remembered.
int max_clusters(const HeadPlan& p, int split) {
  static int cache[3][4] = {
      {-1, -1, -1, -1}, {-1, -1, -1, -1}, {-1, -1, -1, -1}};
  int& n = cache[p.bm / 128][split == 8 ? 3 : split / 2];
  if (n >= 0) return n;
  const void* kernels[2] = {
      reinterpret_cast<const void*>(head_wgmma_kernel<false>),
      reinterpret_cast<const void*>(head_wgmma_kernel<true>)};
  n = 0;
  for (const void* k : kernels) {
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem) != cudaSuccess) {
      cudaGetLastError();
      return n = 0;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_tiles * split, p.row_tiles);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int got = 0;
  if (cudaOccupancyMaxActiveClusters(&got, kernels[1], &cfg) != cudaSuccess) {
    cudaGetLastError();
    got = 0;
  }
  return n = got;
}

// bm rows (64 up to B=64, 128 up to 128, else 256: one m64 slice per
// consumer warpgroup) x 128 hidden units per tile; the K loop is split
// over `split` blocks of one cluster: the largest of 8, 4, 2 whose
// clusters for every tile can be resident at once (one wave), else 1.
// Up to 128 rows the ring is cut so that two blocks share an SM; 256 rows
// take the SM's shared memory.
HeadPlan head_plan(int B, int D, int H) {
  HeadPlan p;
  p.bm = B <= 64 ? 64 : (B <= 128 ? 128 : 256);
  p.wgs = p.bm / 64;
  p.threads = p.wgs * 128 + 32;  // consumer warpgroups, then the producer
  p.row_tiles = (B + p.bm - 1) / p.bm;
  p.n_tiles = (H + WG_BN - 1) / WG_BN;
  p.k_steps = (D + WG_BK - 1) / WG_BK;
  p.stage_bytes = (p.bm + WG_BN) * WG_BK * 2;
  // two blocks an SM up to 128 rows; 256 rows take the SM's shared memory
  p.stages = (p.bm == 256 ? 2 : 1) * WG_BUDGET / p.stage_bytes;
  // the epilogue reuses the ring: the f32 tile, then h at any split
  const int ring = p.stages * p.stage_bytes;
  const int epi = 64 * (p.wgs * 128) * 4 + p.bm * (WG_BN + 8) * 2;
  p.w2_off = ring > epi ? ring : epi;
  p.bar_off = p.w2_off + WG_W2C * WG_BN * 4;
  p.smem = 1024 + p.bar_off + 2 * p.stages * 8;
  p.split = 1;
  for (int split = 8; split >= 2; split /= 2) {
    if (p.row_tiles * p.n_tiles <= max_clusters(p, split)) {
      p.split = split;
      break;
    }
  }
  return p;
}

template <bool TRAIN>
int launch_wgmma(const void* x, const void* w1, const void* b1,
                 const void* w2, void* partial, int B, int D, int H, int C,
                 TrainArgs ta, cudaStream_t s) {
  const HeadPlan p = head_plan(B, D, H);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(H)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t xbox[2] = {WG_BK, static_cast<cuuint32_t>(p.bm)};
  const cuuint32_t wbox[2] = {WG_BK, WG_BN};
  int err = encode_bf16(&xmap, x, 2, xdims, stride, xbox,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_bf16(&wmap, w1, 2, wdims, stride, wbox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      head_wgmma_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_tiles * p.split, p.row_tiles);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, head_wgmma_kernel<TRAIN>, xmap, wmap,
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<float*>(partial), B, H, C, p, ta));
}

// out[row][c] = b2[c] + the partials of (row, c), one warp each: lane l
// sums slots l, l+32, ... in order, then a fixed butterfly across the
// lanes. Deterministic, and the slots' loads are in flight together.
__global__ void head_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ b2,
                                   float* __restrict__ out, int n_tiles,
                                   int B, int C) {
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= B * C) return;  // whole warps
  float s = 0.f;
  for (int t = lane; t < n_tiles; t += 32)
    s += partial[static_cast<size_t>(t) * B * C + idx];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[idx] = s + b2[idx % C];
}

template <bool TRAIN>
int launch_head(const void* x, const void* w1, const void* b1,
                const void* w2, void* partial, int B, int D, int H, int C,
                int is_bf16, TrainArgs ta, cudaStream_t s) {
  if (is_bf16)
    return launch_wgmma<TRAIN>(x, w1, b1, w2, partial, B, D, H, C, ta, s);
  dim3 grid((H + HT - 1) / HT, (B + RB32 - 1) / RB32);
  head_f32_kernel<TRAIN><<<grid, 128, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<float*>(partial), B, D, H, C, ta);
  return static_cast<int>(cudaGetLastError());
}

int n_partials(int B, int D, int H, int is_bf16) {
  if (!is_bf16) return (H + HT - 1) / HT;
  const HeadPlan p = head_plan(B, D, H);
  return p.n_tiles * p.split;
}

}  // namespace

// The number of (B, C) f32 partial-logit slices the caller allocates.
extern "C" int fusion_head_n_tiles(int B, int D, int H, int is_bf16) {
  return n_partials(B, D, H, is_bf16);
}

// The launch plan of the bf16 body: grid x, grid y, threads, cluster
// size, dynamic shared-memory bytes, ring stages (all 0 for f32, whose
// body is the CUDA-core one).
extern "C" int fusion_head_plan(int B, int D, int H, int is_bf16,
                                int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (!is_bf16) return 0;
  const HeadPlan p = head_plan(B, D, H);
  out[0] = p.n_tiles * p.split;
  out[1] = p.row_tiles;
  out[2] = p.threads;
  out[3] = p.split;
  out[4] = p.smem;
  out[5] = p.stages;
  return 0;
}

// x (B,D), w1 (H,D), w2 (C,H) in one dtype (bf16 needs D % 8 == 0 and
// 16-byte aligned rows; the wrapper checks); b1 (H,), b2 (C,) f32;
// partial (fusion_head_n_tiles(...), B, C) f32 scratch; out (B,C) f32.
// Training form: h_out (B,H) in the compute dtype or null; threshold > 0
// turns dropout on with the int64 seed at device address seed and
// scale = 1/(1-rate); the dropout bits of row r are those of global row
// row_offset + r. With h_out null and threshold 0 this is the inference
// launch. Returns the first CUDA error of the two launches.
extern "C" int fusion_head_forward(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* partial, void* out,
                                   void* h_out, const void* seed, int B,
                                   int D, int H, int C, int is_bf16,
                                   unsigned threshold, float scale,
                                   int row_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TrainArgs ta{h_out, static_cast<const long long*>(seed), threshold,
                     scale, row_offset};
  int err = h_out != nullptr || threshold != 0u
                ? launch_head<true>(x, w1, b1, w2, partial, B, D, H, C,
                                    is_bf16, ta, s)
                : launch_head<false>(x, w1, b1, w2, partial, B, D, H, C,
                                     is_bf16, ta, s);
  if (!err) err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  head_reduce_kernel<<<(B * C + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(b2),
      static_cast<float*>(out), n_partials(B, D, H, is_bf16), B, C);
  return static_cast<int>(cudaGetLastError());
}
