// Fused quadrant block for Hopper (sm_90a): per-quadrant zero padding,
// shared 3x3 conv, bias, ReLU, VALID 2x2/2 max pool and the (q, ph, pw, c)
// flatten, in one launch.
//
// Replaces surya_tpu/ops/pallas/quadrant.py::_quadrant_kernel, both forms:
// the inference form (act == nullptr) and the training form, which also
// writes the post-ReLU, pre-pool map act (B, H, H, Cout) in full-map layout
// as the backward's residual (the Pallas kernel's a_ref). Outputs are
// rounded once, as there: the pool of the rounded values is the rounded
// pool of the f32 values, since rounding is monotone.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the conv work the pool
// reads is 5.4 GFLOP at B=64 (14x14x256 -> 128) against 7.6 MB, so it is
// bound by operations (0.0055 ms); the training form at B=256 computes
// all 49 conv outputs of a quadrant and writes act: 29.6 GFLOP, 41.5 MB,
// 0.030 ms. Every input byte is needed once; the weights (590 KB) are
// re-read by every block, from L2.
//
// Two bodies, chosen by shape alone:
// - bf16 with Cin % 16 == 0, Cout % 16 == 0 and quadrants of at most
//   15x15 (every trunk the models use): an implicit GEMM on wgmma. Its
//   rows are output positions at the PADDED width (row p = y*side + x),
//   so each tap's A tile is the staged padded quadrant shifted by
//   dh*side + dw rows: no im2col copy. That shift breaks the 8-row core-
//   matrix alignment a shared-memory A descriptor needs, so A comes from
//   registers (wgmma's register form, fragments loaded with ldmatrix from
//   the swizzled tile, the swizzle undone in the address). B, the weights,
//   is wgmma's shared-memory operand: an HWIO slab (Cin rows, Cout
//   contiguous) is MN-major, which wgmma reads through its transpose-B
//   flag. TMA brings both in: the padded quadrants per Cin chunk of 64
//   (double-buffered; the zero border is TMA's out-of-bounds fill over a
//   5-D view of x in which each quadrant's own rows and columns are
//   dimensions), the weight slabs through an mbarrier ring of up to 8
//   stages; one thread of a producer warpgroup, which hands its registers
//   to the consumers, issues every load. Two consumer warpgroups own 1 or 2
//   m64 row blocks each: at the flagship a block holds all four quadrants
//   of a sample (256 GEMM rows per weight slab, half the L2 weight traffic
//   of 128), and where that leaves fewer than 120 blocks (B=64) the plan
//   halves the Cout tile instead. Rows at x >= 2hp (or hq) are computed
//   and dropped. The epilogue adds the bias, applies ReLU, rounds once to
//   a bf16 tile in shared memory, and writes act and the VALID 2x2 pool
//   (rows p, p+1, p+side, p+side+1) with 16-byte stores.
// - otherwise (f32, or odd channel counts): CUDA-core FMA, one thread per
//   pooled anchor x 4 output channels, its 2x2 conv outputs in registers.
//   With act the anchors cover ceil(hq/2)^2 windows, so an odd quadrant's
//   last row and column are computed too (and the tile grows by the zero
//   row and column those windows run into).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int CO_PER = 4;            // output channels per thread
constexpr int SMEM_BYTES = 48 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid.x = B*4 (sample, quadrant); grid.y = Cout tiles of ncg*CO_PER.
// thread t < hpa*hpa*ncg owns the 2x2 window at anchor t / ncg and channels
// co0 = tile*ncg*CO_PER + (t % ncg)*CO_PER .. +CO_PER. hpa windows a side:
// hq/2 without act (the pooled ones), ceil(hq/2) with act; side = the
// tile's side, at least 2*hpa + 2.
template <typename T>
__global__ void quadrant_kernel(const T* __restrict__ x,
                                const T* __restrict__ w,
                                const float* __restrict__ bias,
                                T* __restrict__ out, T* __restrict__ act,
                                int H, int Cin, int Cout, int ncg,
                                int ci_chunk, int hpa, int side) {
  extern __shared__ float tile[];  // [side^2][ci_chunk], zero border
  const int hq = H / 2, hp = hq / 2;
  const int n = blockIdx.x / 4, q = blockIdx.x % 4;
  const int h0 = (q / 2) * hq, w0 = (q % 2) * hq;
  const int t = threadIdx.x;
  const int anchor = t / ncg;
  const int ph = anchor / hpa, pw = anchor % hpa;
  const int co0 = (blockIdx.y * ncg + t % ncg) * CO_PER;
  const bool active = anchor < hpa * hpa && co0 < Cout;
  const bool vec = (Cout % CO_PER == 0);

  float acc[2][2][CO_PER];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < CO_PER; ++c) acc[a][b][c] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += ci_chunk) {
    const int cc = min(ci_chunk, Cin - ci0);
    __syncthreads();  // previous chunk fully consumed
    for (int idx = t; idx < side * side * cc; idx += blockDim.x) {
      const int pix = idx / cc, ci = idx - pix * cc;
      const int gy = pix / side - 1, gx = pix % side - 1;
      float v = 0.f;
      if (gy >= 0 && gy < hq && gx >= 0 && gx < hq)
        v = to_f(x[((static_cast<size_t>(n) * H + h0 + gy) * H + w0 + gx) *
                       Cin + ci0 + ci]);
      tile[idx] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int ci = 0; ci < cc; ++ci) {
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[i][j] = tile[((2 * ph + i) * side + 2 * pw + j) * cc + ci];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const T* wp =
              w + (static_cast<size_t>(dh * 3 + dw) * Cin + ci0 + ci) * Cout +
              co0;
          float wv[CO_PER];
          if (vec) {
#pragma unroll
            for (int c = 0; c < CO_PER; ++c) wv[c] = to_f(__ldg(wp + c));
          } else {
#pragma unroll
            for (int c = 0; c < CO_PER; ++c)
              wv[c] = (co0 + c < Cout) ? to_f(__ldg(wp + c)) : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const float xv = v[a + dh][b + dw];
#pragma unroll
              for (int c = 0; c < CO_PER; ++c)
                acc[a][b][c] = fmaf(xv, wv[c], acc[a][b][c]);
            }
        }
    }
  }
  if (!active) return;

  const bool pooled = ph < hp && pw < hp;  // a window the VALID pool keeps
  const size_t out_dim = static_cast<size_t>(4) * hp * hp * Cout;
  T* op = out + n * out_dim + (static_cast<size_t>(q) * hp * hp +
                               ph * hp + pw) * Cout + co0;
#pragma unroll
  for (int c = 0; c < CO_PER; ++c) {
    if (co0 + c >= Cout) break;
    const float bv = bias[co0 + c];
    float m = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float v = fmaxf(acc[a][b][c] + bv, 0.f);
        m = fmaxf(m, v);
        const int y = 2 * ph + a, xx = 2 * pw + b;
        if (act != nullptr && y < hq && xx < hq)
          act[((static_cast<size_t>(n) * H + h0 + y) * H + w0 + xx) * Cout +
              co0 + c] = from_f<T>(v);
      }
    if (pooled) op[c] = from_f<T>(m);
  }
}

// ---- bf16 body: wgmma with A from registers, weights by TMA ---------------
using bf16 = __nv_bfloat16;
using namespace hopper;
constexpr int QW_MAX_STAGES = 8;     // weight-slab ring
constexpr int QW_THREADS = 384;      // two consumer warpgroups + producer
constexpr int QW_MIN_BLOCKS = 120;   // of the card's 132 SMs
constexpr int QW_BUDGET = 220 * 1024;

struct WgPlan {
  int mq;           // m64 row blocks per quadrant (1, 2 or 4)
  int mb;           // m64 row blocks per consumer warpgroup (1 or 2)
  int qpc;          // whole quadrants per block: 2 * mb / mq
  int nt;           // Cout tile, wgmma N (16, 32, 64 or 128)
  int cc;           // Cin chunk (64, 32 or 16): one swizzled tile row
  int in_bytes;     // one quadrant's staged chunk, 1024-aligned
  int slab_bytes;   // one weight slab (cc x nt), and its ring stride
  int slab_stride;
  int ldc;          // bf16 row pitch of the epilogue tile
  int stages;       // weight-ring depth: what the shared memory allows
  int bar_off;      // mbarriers, after the larger of ring and epilogue
  int grid_x, grid_y, smem;
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// GEMM rows of one quadrant at the padded width: conv rows 0 .. 2*hp-1
// for the pool alone, all hq rows when the act output is asked for.
int quad_rows(int H, bool with_act) {
  const int hq = H / 2;
  return (with_act ? hq : 2 * (hq / 2)) * (hq + 2);
}

bool wg_fits(int H, int Cin, int Cout, bool with_act) {
  return Cin % 16 == 0 && Cout % 16 == 0 && quad_rows(H, with_act) <= 256;
}

// Whole quadrants per block, two consumer warpgroups of mb m64 blocks
// each: 256 GEMM rows (four quadrants at the flagship) where that still
// gives 120 blocks, else a Cout tile of half the width, else 128 rows.
WgPlan wg_plan(int B, int H, int Cin, int Cout, bool with_act) {
  const int hq = H / 2, side = hq + 2;
  WgPlan p;
  p.mq = (quad_rows(H, with_act) + 63) / 64;
  if (p.mq == 3) p.mq = 4;
  p.cc = Cin % 64 == 0 ? 64 : (Cin % 32 == 0 ? 32 : 16);
  const int nt0 = Cout % 128 == 0 ? 128
                  : Cout % 64 == 0 ? 64
                  : Cout % 32 == 0 ? 32 : 16;
  const int cand[4][2] = {{2, nt0}, {2, nt0 / 2}, {1, nt0}, {1, nt0 / 2}};
  long best = -1;
  for (const auto& c : cand) {
    if (c[1] < 16 || 2 * c[0] < p.mq) continue;
    const long blocks =
        static_cast<long>((B * 4 * p.mq + 2 * c[0] - 1) / (2 * c[0])) *
        (Cout / c[1]);
    if (blocks > best) {
      best = blocks;
      p.mb = c[0];
      p.nt = c[1];
    }
    if (blocks >= QW_MIN_BLOCKS) {
      p.mb = c[0];
      p.nt = c[1];
      break;
    }
  }
  p.qpc = 2 * p.mb / p.mq;
  // the padded quadrant, then the rows the shifted A tiles run into
  int rows = side * side;
  if (p.mq * 64 + 2 * side + 2 > rows) rows = p.mq * 64 + 2 * side + 2;
  p.in_bytes = round_up(rows * p.cc * 2, 1024);
  p.slab_bytes = p.cc * p.nt * 2;
  p.slab_stride = round_up(p.slab_bytes, 1024);
  p.ldc = p.nt + 8;
  p.stages = (QW_BUDGET - 2 * p.qpc * p.in_bytes) / p.slab_stride;
  if (p.stages > QW_MAX_STAGES) p.stages = QW_MAX_STAGES;
  const int ring = 2 * p.qpc * p.in_bytes + p.stages * p.slab_stride;
  const int epi = p.qpc * p.mq * 64 * p.ldc * 2;
  p.bar_off = round_up(ring > epi ? ring : epi, 8);
  p.smem = 1024 + p.bar_off + (2 * p.stages + 4) * 8;
  p.grid_x = (B * 4 + p.qpc - 1) / p.qpc;
  p.grid_y = Cout / p.nt;
  return p;
}

// byte offset within a tile written by TMA with a (row pitch)-byte swizzle
// from a 1024-aligned base: 16-byte unit bits [4, 4+b) ^= bits [7, 7+b)
__device__ __forceinline__ uint32_t swz(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

template <int NT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NT == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (NT == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (NT == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n16(d, a, db);
}

// grid (ceil(4B / qpc), Cout / NT), 384 threads. Warpgroups 0-1 consume;
// warpgroup 2 produces: it gives its registers to the consumers and one of
// its threads issues every TMA load. Per Cin chunk (double-buffered) the
// block stages its qpc padded quadrants, then walks the 9 taps: slab
// (tap, chunk) of the weights arrives through the ring; each consumer
// warpgroup multiplies A fragments (ldmatrix at the tap's row shift) into
// MB register accumulators of m64 x NT, and loads the next slab's
// fragments while this slab's wgmma run. ACT: also write act (B,H,H,Cout).
template <int NT, int MB, bool ACT>
__global__ void __launch_bounds__(QW_THREADS, 1)
quadrant_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      bf16* __restrict__ act, int B, int H, int Cin, int Cout,
                      WgPlan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* in_buf = smem;  // [2][qpc][in_bytes]
  unsigned char* ring = smem + 2 * p.qpc * p.in_bytes;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* w_empty = w_full + p.stages;
  uint64_t* in_full = w_empty + p.stages;
  uint64_t* in_empty = in_full + 2;
  const int hq = H / 2, hp = hq / 2, side = hq + 2;
  const int quad0 = blockIdx.x * p.qpc;  // first (sample * 4 + quadrant)
  const int n0 = blockIdx.y * NT;
  const int nch = Cin / p.cc, nk = p.cc / 16, steps = 9 * nch;
  const int tid = threadIdx.x;
  constexpr int WCOLS = NT < 64 ? NT : 64;  // N columns per TMA box
  const int valid = min(p.qpc, 4 * B - quad0);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 2);   // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&in_full[b], 1);
      mbar_init(&in_empty[b], 8);  // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warpgroup
    regs_dealloc<40>();
    if (tid == 256) {
      auto load_in = [&](int c) {
        const int b = c & 1;
        mbar_expect_tx(&in_full[b], valid * side * side * p.cc * 2);
        for (int qi = 0; qi < valid; ++qi) {
          const int g = quad0 + qi, n = g / 4, q = g % 4;
          // box (cc, side, 1, side, 1) from (c*cc, -1, qx, -1, 2n + qy):
          // the one-pixel border lies outside the quadrant's own x and y
          // ranges, so TMA fills it with zeros: the per-quadrant padding
          tma_load_5d(in_buf + (b * p.qpc + qi) * p.in_bytes, &xmap,
                      &in_full[b], c * p.cc, -1, q % 2, -1, 2 * n + q / 2);
        }
      };
      load_in(0);
      for (int it = 0; it < steps; ++it) {
        const int c = it / 9, tap = it % 9, s = it % p.stages;
        mbar_wait(&w_empty[s], ((it / p.stages) & 1) ^ 1);
        unsigned char* dst = ring + s * p.slab_stride;
        mbar_expect_tx(&w_full[s], p.slab_bytes);
#pragma unroll
        for (int h = 0; h < NT; h += WCOLS)
          tma_load_2d(dst + (h / WCOLS) * p.cc * WCOLS * 2, &wmap,
                      &w_full[s], n0 + h, tap * Cin + c * p.cc);
        if (tap == 3 && c + 1 < nch) {  // the next chunk's input, in time
          mbar_wait(&in_empty[(c + 1) & 1], (((c + 1) >> 1) & 1) ^ 1);
          load_in(c + 1);
        }
      }
    }
    return;
  }

  regs_alloc<232>();
  // consumer warpgroup wg: the block's row blocks wg*MB .. wg*MB+MB-1
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const uint32_t in_mask = p.cc == 64 ? 7 : (p.cc == 32 ? 3 : 1);
  const uint32_t pitch = p.cc * 2;
  int lrow[MB];       // the tile row this lane addresses, before the shift
  uint32_t qoff[MB];  // its quadrant's offset in a staged chunk
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const int j = wg * MB + m;
    qoff[m] = (j / p.mq) * p.in_bytes;
    lrow[m] = (j % p.mq) * 64 + warp * 16 + lane % 16;
  }
  // weights: MN-major slab, rows of WCOLS*2 bytes, 8-row groups (SBO),
  // 64-column blocks cc rows apart (LBO)
  constexpr uint32_t wpitch = WCOLS * 2;
  constexpr uint32_t wlayout = wpitch == 128 ? 1 : (wpitch == 64 ? 2 : 3);
  const uint32_t lbo = p.cc * wpitch, sbo = 8 * wpitch;

  // A fragments of slab `it` (chunk it/9, tap it%9); the first tap of a
  // chunk waits for its tile, the last one hands the tile back
  auto load_a = [&](uint32_t (&a)[MB][4][4], int it) {
    const int c = it / 9, tap = it % 9, b = c & 1;
    if (tap == 0) mbar_wait(&in_full[b], (c >> 1) & 1);
    const uint32_t base = smem_u32(in_buf + b * p.qpc * p.in_bytes);
    const int shift = (tap / 3) * side + tap % 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nk) {
#pragma unroll
        for (int m = 0; m < MB; ++m)
          ldsm_x4(a[m][kk],
                  base + qoff[m] +
                      swz((lrow[m] + shift) * pitch + (kk * 2 + lane / 16) * 16,
                          in_mask));
      }
    }
    if (tap == 8) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&in_empty[b]);
    }
  };
  float acc[MB][NT / 2];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[m][i] = 0.f;
  // slab `it` runs on fragments x while the previous slab's wgmma (on y)
  // may still be in flight; once they are done, y takes slab it + 1
  auto step = [&](uint32_t (&x)[MB][4][4], uint32_t (&y)[MB][4][4], int it) {
    const int s = it % p.stages;
    mbar_wait(&w_full[s], (it / p.stages) & 1);
    const unsigned char* slab = ring + s * p.slab_stride;
#pragma unroll
    for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < nk) {
        const uint64_t db =
            wgmma_desc(slab + kk * 16 * wpitch, lbo, sbo, wlayout);
#pragma unroll
        for (int m = 0; m < MB; ++m) wgmma_rs<NT>(acc[m], x[m][kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // slab it - 1 is done: its stage and y are free
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      fence_regs(acc[m]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(y[m][kk]);
    }
    if (it > 0 && tid % 128 == 0)
      mbar_arrive(&w_empty[(it - 1) % p.stages]);
    if (it + 1 < steps) load_a(y, it + 1);
  };
  uint32_t a0[MB][4][4], a1[MB][4][4];
  load_a(a0, 0);
  for (int it = 0; it < steps; it += 2) {
    step(a0, a1, it);
    if (it + 1 < steps) step(a1, a0, it + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    fence_regs(acc[m]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(a0[m][kk]);
      fence_regs(a1[m][kk]);
    }
  }
  // every tile and slab of this block is read (the producer issued no
  // more than was consumed): reuse the space
  named_sync(1, 256);

  // bias + ReLU of every GEMM row, rounded once, into a bf16 tile whose
  // rows are the block's quadrants at the padded width. The pool of the
  // rounded values equals the rounded pool of the f32 values (rounding is
  // monotone), so both outputs come from this tile.
  bf16* ct = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const int r0 = (wg * MB + m) * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < NT / 2; i += 2) {
      // accumulator element i: row +8 for odd i/2, column (i/4)*8 +
      // (lane%4)*2 + i%2
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = (i >> 2) * 8 + (lane & 3) * 2;
      const float v0 = fmaxf(acc[m][i] + bias[n0 + col], 0.f);
      const float v1 = fmaxf(acc[m][i + 1] + bias[n0 + col + 1], 0.f);
      *reinterpret_cast<__nv_bfloat162*>(ct + row * p.ldc + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  named_sync(1, 256);

  constexpr int SEGS = NT / 8;  // 16-byte groups of a tile row
  const int qrows = p.mq * 64;
  if constexpr (ACT) {
    const int per_q = hq * hq * SEGS;
    for (int idx = tid; idx < valid * per_q; idx += 256) {
      const int qi = idx / per_q, rem = idx - qi * per_q;
      const int pos = rem / SEGS, sg = rem - pos * SEGS;
      const int y = pos / hq, xx = pos - y * hq;
      const int g = quad0 + qi, n = g / 4, q = g % 4;
      const uint4 v = *reinterpret_cast<const uint4*>(
          ct + (qi * qrows + y * side + xx) * p.ldc + sg * 8);
      *reinterpret_cast<uint4*>(
          act + ((static_cast<size_t>(n) * H + (q / 2) * hq + y) * H +
                 (q % 2) * hq + xx) * Cout + n0 + sg * 8) = v;
    }
  }
  // VALID 2x2 max over rows r, r+1, r+side, r+side+1
  const int per_q = hp * hp * SEGS;
  const size_t out_dim = static_cast<size_t>(4) * hp * hp * Cout;
  for (int idx = tid; idx < valid * per_q; idx += 256) {
    const int qi = idx / per_q, rem = idx - qi * per_q;
    const int a = rem / SEGS, sg = rem - a * SEGS;
    const int r = qi * qrows + 2 * (a / hp) * side + 2 * (a % hp);
    const bf16* src = ct + r * p.ldc + sg * 8;
    uint4 v[4] = {*reinterpret_cast<const uint4*>(src),
                  *reinterpret_cast<const uint4*>(src + p.ldc),
                  *reinterpret_cast<const uint4*>(src + side * p.ldc),
                  *reinterpret_cast<const uint4*>(src + (side + 1) * p.ldc)};
    __nv_bfloat162* m0 = reinterpret_cast<__nv_bfloat162*>(&v[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const __nv_bfloat162* mk = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
#pragma unroll
      for (int e = 0; e < 4; ++e) m0[e] = __hmax2(m0[e], mk[e]);
    }
    const int g = quad0 + qi, n = g / 4, q = g % 4;
    *reinterpret_cast<uint4*>(out + n * out_dim +
                              (static_cast<size_t>(q) * hp * hp + a) * Cout +
                              n0 + sg * 8) = v[0];
  }
}

template <int NT, int MB, bool ACT>
int launch_wg_t(const WgPlan& p, const CUtensorMap& xmap,
                const CUtensorMap& wmap, const void* bias, void* out,
                void* act, int B, int H, int Cin, int Cout,
                cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      quadrant_wgmma_kernel<NT, MB, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  quadrant_wgmma_kernel<NT, MB, ACT>
      <<<dim3(p.grid_x, p.grid_y), QW_THREADS, p.smem, stream>>>(
          xmap, wmap, static_cast<const float*>(bias),
          static_cast<bf16*>(out), static_cast<bf16*>(act), B, H, Cin, Cout,
          p);
  return static_cast<int>(cudaGetLastError());
}

template <bool ACT>
int launch_wg_nt(const WgPlan& p, const CUtensorMap& xmap,
                 const CUtensorMap& wmap, const void* bias, void* out,
                 void* act, int B, int H, int Cin, int Cout,
                 cudaStream_t s) {
#define QW_CASE(N_, M_)                                                    \
  if (p.nt == N_ && p.mb == M_)                                            \
    return launch_wg_t<N_, M_, ACT>(p, xmap, wmap, bias, out, act, B, H,  \
                                    Cin, Cout, s);
  QW_CASE(128, 2) QW_CASE(128, 1) QW_CASE(64, 2) QW_CASE(64, 1)
  QW_CASE(32, 2) QW_CASE(32, 1) QW_CASE(16, 2) QW_CASE(16, 1)
#undef QW_CASE
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

int launch_wgmma(const void* x, const void* w, const void* bias, void* out,
                 void* act, int B, int H, int Cin, int Cout,
                 cudaStream_t s) {
  const bool with_act = act != nullptr;
  const WgPlan p = wg_plan(B, H, Cin, Cout, with_act);
  const int hq = H / 2, side = hq + 2;
  // x as (2B, hq, 2, hq, Cin): (sample, quadrant row), row in quadrant,
  // quadrant column, column in quadrant, channel; innermost first
  const cuuint64_t cin2 = static_cast<cuuint64_t>(Cin) * 2;
  const cuuint64_t xdims[5] = {static_cast<cuuint64_t>(Cin),
                               static_cast<cuuint64_t>(hq), 2,
                               static_cast<cuuint64_t>(hq),
                               static_cast<cuuint64_t>(2 * B)};
  const cuuint64_t xstrides[4] = {cin2, hq * cin2, H * cin2, hq * H * cin2};
  const cuuint32_t xbox[5] = {static_cast<cuuint32_t>(p.cc),
                              static_cast<cuuint32_t>(side), 1,
                              static_cast<cuuint32_t>(side), 1};
  // weights as (9*Cin, Cout): a slab is cc rows of one tap
  const int wcols = p.nt < 64 ? p.nt : 64;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(Cout),
                               static_cast<cuuint64_t>(9) * Cin};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(Cout) * 2};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(wcols),
                              static_cast<cuuint32_t>(p.cc)};
  CUtensorMap xmap, wmap;
  int err = encode_bf16(&xmap, x, 5, xdims, xstrides, xbox,
                        swizzle_for(p.cc * 2));
  if (!err)
    err = encode_bf16(&wmap, w, 2, wdims, wstrides, wbox,
                      swizzle_for(wcols * 2));
  if (err) return err;
  return with_act ? launch_wg_nt<true>(p, xmap, wmap, bias, out, act, B, H,
                                       Cin, Cout, s)
                  : launch_wg_nt<false>(p, xmap, wmap, bias, out, act, B, H,
                                        Cin, Cout, s);
}

// ---- CUDA-core body ---------------------------------------------------------
template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out,
           void* act, int B, int H, int Cin, int Cout, cudaStream_t stream) {
  const int hq = H / 2;
  const int hpa = act != nullptr ? (hq + 1) / 2 : hq / 2;
  const int side = act != nullptr ? 2 * hpa + 2 : hq + 2;
  const int groups = (Cout + CO_PER - 1) / CO_PER;
  // The act form holds more live values a thread: its blocks stay at 256
  // threads (the wrapper keeps hpa * hpa <= 256 there). Neither form goes
  // beyond what the kernel's register count allows.
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, quadrant_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  int max_threads = act != nullptr ? 256 : 1024;
  if (fa.maxThreadsPerBlock < max_threads)
    max_threads = fa.maxThreadsPerBlock / 32 * 32;
  if (hpa * hpa > max_threads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int ncg = groups < 32 ? groups : 32;
  if (ncg > max_threads / (hpa * hpa)) ncg = max_threads / (hpa * hpa);
  const int threads = ((hpa * hpa * ncg + 31) / 32) * 32;
  int ci_chunk = SMEM_BYTES / (side * side * static_cast<int>(sizeof(float)));
  if (ci_chunk > Cin) ci_chunk = Cin;
  const size_t smem = static_cast<size_t>(side) * side * ci_chunk *
                      sizeof(float);
  dim3 grid(B * 4, (groups + ncg - 1) / ncg);
  quadrant_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out),
      static_cast<T*>(act), H, Cin, Cout, ncg, ci_chunk, hpa, side);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,H,H,Cin) NHWC, w (3,3,Cin,Cout) HWIO in x's dtype, bias (Cout,) f32,
// out (B, 4*(H/4)^2*Cout) in x's dtype; act (B,H,H,Cout) in x's dtype, or
// null for the inference form. Requires even H in [4, 128] (at most 64
// with act) and 16-byte aligned x and w (the wrapper checks). Returns
// cudaGetLastError().
extern "C" int quadrant_forward(const void* x, const void* w,
                                const void* bias, void* out, void* act,
                                int B, int H, int Cin, int Cout, int is_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && wg_fits(H, Cin, Cout, act != nullptr))
    return launch_wgmma(x, w, bias, out, act, B, H, Cin, Cout, s);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, bias, out, act, B, H, Cin, Cout, s);
  return launch<float>(x, w, bias, out, act, B, H, Cin, Cout, s);
}

// The launch plan of the wgmma body at these shapes: grid x, grid y,
// threads, cluster size, dynamic shared-memory bytes, ring stages; all 0
// where the CUDA-core body runs instead.
extern "C" int quadrant_plan(int B, int H, int Cin, int Cout, int is_bf16,
                             int with_act, int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (!is_bf16 || !wg_fits(H, Cin, Cout, with_act != 0)) return 0;
  const WgPlan p = wg_plan(B, H, Cin, Cout, with_act != 0);
  out[0] = p.grid_x;
  out[1] = p.grid_y;
  out[2] = QW_THREADS;
  out[3] = 1;
  out[4] = p.smem;
  out[5] = p.stages;
  return 0;
}
