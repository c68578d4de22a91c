// Fused quadrant block for Hopper (sm_90a): per-quadrant zero padding,
// shared 3x3 conv, bias, ReLU, VALID 2x2/2 max pool and the (q, ph, pw, c)
// flatten, in one launch.
//
// Replaces surya_tpu/ops/pallas/quadrant.py::_quadrant_kernel (forward,
// without the pre-pool activation output).
//
// Bound: at the flagship shape (B=64, 14x14x256 -> 128) the conv work the
// pool reads is ~5.4 GFLOP against ~7.6 MB of traffic, so it is bound by
// arithmetic. The design keeps every input byte on chip once: one block
// per (sample, quadrant, Cout tile) stages its quadrant with a one-pixel
// zero border in shared memory (the border IS the per-quadrant padding,
// so no masks). Only the 2hp x 2hp conv outputs the VALID pool reads
// (36 of 49 at the flagship) count toward the bound. Accumulation is f32.
//
// Two bodies, chosen by what the shapes allow:
// - bf16 with Cin % 16 == 0, Cout % 16 == 0 and quadrants of at most
//   15x15 (every trunk the models use): tensor cores through mma.sync
//   m16n8k16 (f32 accumulate), fragments loaded with ldmatrix (.trans for
//   the weights, which sit in shared memory as HWIO rows with Cout
//   contiguous: WMMA's row-major B loads of that layout measured 3x slower
//   than cuDNN). The conv is an implicit GEMM whose rows
//   are output positions at the PADDED width (row p = y*side + x), so each
//   tap's A tile is the staged input shifted by dh*side + dw rows with one
//   uniform stride: no im2col copy. Rows at x >= 2hp are computed and
//   dropped (64 rows for 36 outputs at the flagship); the tensor cores have
//   the rate to spare. A block takes two quadrants at the flagship (128
//   rows, 8 warps, 128 blocks at B=64), so each weight slab it streams
//   through its 3-stage cp.async ring feeds twice the rows; accumulators
//   stay in registers, and the epilogue pools from an f32 tile in shared
//   memory.
// - otherwise (f32, or odd channel counts): CUDA-core FMA, one thread per
//   pooled anchor x 4 output channels, its 2x2 conv outputs in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// thread t < hp*hp*ncg owns anchor t / ncg and channels
// co0 = tile*ncg*CO_PER + (t % ncg)*CO_PER .. +CO_PER.
template <typename T>
__global__ void quadrant_kernel(const T* __restrict__ x,
                                const T* __restrict__ w,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int H, int Cin, int Cout,
                                int ncg, int ci_chunk) {
  extern __shared__ float tile[];  // [(hq+2)^2][ci_chunk], zero border
  const int hq = H / 2, hp = hq / 2, side = hq + 2;
  const int n = blockIdx.x / 4, q = blockIdx.x % 4;
  const int h0 = (q / 2) * hq, w0 = (q % 2) * hq;
  const int t = threadIdx.x;
  const int anchor = t / ncg;
  const int ph = anchor / hp, pw = anchor % hp;
  const int co0 = (blockIdx.y * ncg + t % ncg) * CO_PER;
  const bool active = anchor < hp * hp && co0 < Cout;
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

  const size_t out_dim = static_cast<size_t>(4) * hp * hp * Cout;
  T* op = out + n * out_dim + (static_cast<size_t>(q) * hp * hp +
                               ph * hp + pw) * Cout + co0;
#pragma unroll
  for (int c = 0; c < CO_PER; ++c) {
    if (co0 + c >= Cout) break;
    const float bv = bias[co0 + c];
    float m = fmaxf(acc[0][0][c] + bv, 0.f);
    m = fmaxf(m, fmaxf(acc[0][1][c] + bv, 0.f));
    m = fmaxf(m, fmaxf(acc[1][0][c] + bv, 0.f));
    m = fmaxf(m, fmaxf(acc[1][1][c] + bv, 0.f));
    op[c] = from_f<T>(m);
  }
}

// ---- bf16 tensor-core body ----------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int WM_NF = 8;               // 16-wide column groups per warp
constexpr int WM_STAGES = 3;           // cp.async ring of weight slabs
constexpr int WM_BUDGET = 200 * 1024;  // dynamic shared memory per block

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));  // 0 bytes read → zeros
}

// Four 8x8 b16 tiles; lane t gives the address of row t % 16 at column
// offset (t / 16) * 8 of a 16x16 block. Plain: the mma A fragment of a
// row-major (m, k) block. Transposed: the B fragments of two n8 tiles of a
// row-major (k, n) block ({r0, r1} for columns 0-7, {r2, r3} for 8-15).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shapes of one launch. A block owns qb quadrants of one sample (qb = 4,
// 2 or 1, so its A rows come to at most 128 where the map allows), one
// warp per (quadrant, 16-row fragment), each warp all nt columns.
struct MmaPlan {
  int qb, m_pad, rows, nt, ks, cc, warps;
  size_t tile_bytes, smem;
};

bool mma_fits(int H, int Cin, int Cout) {
  const int m_pad = (2 * (H / 4) * (H / 2 + 2) + 15) / 16 * 16;
  return Cin % 16 == 0 && Cout % 16 == 0 && m_pad <= 256;
}

MmaPlan mma_plan(int H, int Cin, int Cout) {
  const int side = H / 2 + 2, hp = H / 4;
  MmaPlan p;
  p.m_pad = (2 * hp * side + 15) / 16 * 16;
  p.qb = p.m_pad <= 32 ? 4 : (p.m_pad <= 64 ? 2 : 1);
  p.warps = p.qb * p.m_pad / 16;
  p.rows = side * side;  // the padded quadrant, then zero rows the
  if (p.m_pad + 2 * side + 2 > p.rows)  // shifted A tiles run into
    p.rows = p.m_pad + 2 * side + 2;
  p.nt = Cout < 16 * WM_NF ? Cout : 16 * WM_NF;
  p.ks = Cin % 64 == 0 ? 64 : (Cin % 32 == 0 ? 32 : 16);
  const size_t bbytes = static_cast<size_t>(WM_STAGES) * p.ks * (p.nt + 8) * 2;
  const size_t per_ch = static_cast<size_t>(p.qb) * p.rows * 2;
  int cc = static_cast<int>((WM_BUDGET - bbytes) / per_ch) - 8;
  cc = cc / p.ks * p.ks;
  p.cc = cc > Cin ? Cin : (cc < p.ks ? p.ks : cc);
  size_t tile = per_ch * (p.cc + 8);
  const size_t cbytes = static_cast<size_t>(p.qb) * p.m_pad * (p.nt + 4) * 4;
  if (cbytes > tile) tile = cbytes;  // C reuses the input tiles' space
  p.tile_bytes = (tile + 127) / 128 * 128;
  p.smem = p.tile_bytes + bbytes;
  return p;
}

// grid.x = B*4/qb (sample, quadrant group); grid.y = Cout tiles of nt.
__global__ void __launch_bounds__(512)
quadrant_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int H, int Cin, int Cout, MmaPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hq = H / 2, hp = hq / 2, side = hq + 2;
  // row pitches of an odd number of 16-byte units: the 8 rows of an
  // ldmatrix tile fall in distinct banks
  const int lda = p.cc + 8, ldb = p.nt + 8, ldc = p.nt + 4;
  bf16* tile = reinterpret_cast<bf16*>(smem);   // (qb, rows, lda)
  float* C = reinterpret_cast<float*>(smem);    // after the K loop
  bf16* Bs = reinterpret_cast<bf16*>(smem + p.tile_bytes);  // ring
  const int groups = 4 / p.qb;
  const int n = blockIdx.x / groups, q0 = (blockIdx.x % groups) * p.qb;
  const int n0 = blockIdx.y * p.nt;
  const int nf = min(p.nt, Cout - n0) / 16;
  const int warp = threadIdx.x / 32;
  const int wq = warp / (p.m_pad / 16), mf = warp % (p.m_pad / 16);
  const int lane = threadIdx.x % 32;
  const int lrow = lane % 16, lcol = (lane / 16) * 8;  // ldmatrix address

  float acc[2 * WM_NF][4];  // n8 tiles x the m16n8 accumulator fragment
#pragma unroll
  for (int j = 0; j < 2 * WM_NF; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += p.cc) {
    const int cc = min(p.cc, Cin - ci0), segs = cc / 8;
    const int ns = cc / p.ks, steps = 9 * ns;
    // weight slab of step s: rows W[tap][ci0 + (s % ns)*ks + r][n0 ..]
    auto load_b = [&](int s) {
      if (s < steps) {
        const int tap = s / ns, k0 = ci0 + (s % ns) * p.ks;
        bf16* dst = Bs + static_cast<size_t>(s % WM_STAGES) * p.ks * ldb;
        const int cs = p.nt / 8;
        for (int idx = threadIdx.x; idx < p.ks * cs; idx += blockDim.x) {
          const int r = idx / cs, c = idx - r * cs;
          const bool ok = n0 + c * 8 < Cout;
          cp_async16(dst + r * ldb + c * 8,
                     ok ? w + (static_cast<size_t>(tap) * Cin + k0 + r) * Cout +
                              n0 + c * 8
                        : w,
                     ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };

    __syncthreads();  // previous chunk's tiles and slabs fully consumed
    for (int s = 0; s < WM_STAGES - 1; ++s) load_b(s);
    for (int idx = threadIdx.x; idx < p.qb * p.rows * segs;
         idx += blockDim.x) {
      const int r = idx / segs, s = idx - r * segs;
      const int qq = r / p.rows, rr = r - qq * p.rows;
      const int q = q0 + qq, gy = rr / side - 1, gx = rr % side - 1;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (rr < side * side && gy >= 0 && gy < hq && gx >= 0 && gx < hq)
        v = *reinterpret_cast<const uint4*>(
            x +
            ((static_cast<size_t>(n) * H + (q / 2) * hq + gy) * H +
             (q % 2) * hq + gx) * Cin +
            ci0 + s * 8);
      *reinterpret_cast<uint4*>(tile + static_cast<size_t>(r) * lda + s * 8) =
          v;
    }
    for (int s = 0; s < steps; ++s) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(WM_STAGES - 2));
      __syncthreads();           // slab s (and the input tiles) visible
      load_b(s + WM_STAGES - 1);  // refills the slot consumed at s - 1
      const int tap = s / ns, kb = (s % ns) * p.ks;
      const bf16* arow =
          tile + (static_cast<size_t>(wq) * p.rows + mf * 16 +
                  (tap / 3) * side + tap % 3) * lda + kb;
      const bf16* brow = Bs + static_cast<size_t>(s % WM_STAGES) * p.ks * ldb;
      for (int kk = 0; kk < p.ks; kk += 16) {
        unsigned a[4];
        ldsm_x4(a, arow + lrow * lda + kk + lcol);
#pragma unroll
        for (int f = 0; f < WM_NF; ++f) {
          if (f >= nf) break;
          unsigned b[4];
          ldsm_x4_t(b, brow + (kk + lrow) * ldb + f * 16 + lcol);
          mma_16816(acc[2 * f], a, b[0], b[1]);
          mma_16816(acc[2 * f + 1], a, b[2], b[3]);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();  // all warps done reading the tiles: reuse as C
  {  // fragment element (r, c): r = lane/4 (+8), c = 2*(lane%4) (+1)
    float* c0 = C + (wq * p.m_pad + mf * 16 + lane / 4) * ldc + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 2 * WM_NF; ++j) {
      if (j >= 2 * nf) break;
      c0[j * 8] = acc[j][0];
      c0[j * 8 + 1] = acc[j][1];
      c0[8 * ldc + j * 8] = acc[j][2];
      c0[8 * ldc + j * 8 + 1] = acc[j][3];
    }
  }
  __syncthreads();

  // bias + ReLU + VALID 2x2 max over rows p, p+1, p+side, p+side+1
  const int ncols = nf * 16, per_q = hp * hp * ncols;
  const size_t out_dim = static_cast<size_t>(4) * hp * hp * Cout;
  for (int idx = threadIdx.x; idx < p.qb * per_q; idx += blockDim.x) {
    const int qq = idx / per_q, rem = idx - qq * per_q;
    const int a = rem / ncols, j = rem - a * ncols;
    const int r = qq * p.m_pad + 2 * (a / hp) * side + 2 * (a % hp);
    const float bv = bias[n0 + j];
    float m = fmaxf(C[r * ldc + j] + bv, 0.f);
    m = fmaxf(m, fmaxf(C[(r + 1) * ldc + j] + bv, 0.f));
    m = fmaxf(m, fmaxf(C[(r + side) * ldc + j] + bv, 0.f));
    m = fmaxf(m, fmaxf(C[(r + side + 1) * ldc + j] + bv, 0.f));
    out[n * out_dim + (static_cast<size_t>(q0 + qq) * hp * hp + a) * Cout +
        n0 + j] = __float2bfloat16(m);
  }
}

int launch_mma(const void* x, const void* w, const void* bias, void* out,
                int B, int H, int Cin, int Cout, cudaStream_t stream) {
  const MmaPlan p = mma_plan(H, Cin, Cout);
  const cudaError_t e = cudaFuncSetAttribute(
      quadrant_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B * 4 / p.qb, (Cout + p.nt - 1) / p.nt);
  quadrant_mma_kernel<<<grid, p.warps * 32, p.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, Cin, Cout,
      p);
  return static_cast<int>(cudaGetLastError());
}

// ---- CUDA-core body ---------------------------------------------------------
template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int Cin, int Cout, cudaStream_t stream) {
  const int hq = H / 2, hp = hq / 2, side = hq + 2;
  const int groups = (Cout + CO_PER - 1) / CO_PER;
  int ncg = groups < 32 ? groups : 32;
  if (ncg > 1024 / (hp * hp)) ncg = 1024 / (hp * hp);
  const int threads = ((hp * hp * ncg + 31) / 32) * 32;
  int ci_chunk = SMEM_BYTES / (side * side * static_cast<int>(sizeof(float)));
  if (ci_chunk > Cin) ci_chunk = Cin;
  const size_t smem = static_cast<size_t>(side) * side * ci_chunk *
                      sizeof(float);
  dim3 grid(B * 4, (groups + ncg - 1) / ncg);
  quadrant_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), H, Cin, Cout,
      ncg, ci_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,H,H,Cin) NHWC, w (3,3,Cin,Cout) HWIO in x's dtype, bias (Cout,) f32,
// out (B, 4*(H/4)^2*Cout) in x's dtype. Requires even H >= 4,
// (H/4)^2 <= 1024 and 16-byte aligned x and w (the wrapper checks).
// Returns cudaGetLastError().
extern "C" int quadrant_forward(const void* x, const void* w,
                                const void* bias, void* out, int B, int H,
                                int Cin, int Cout, int is_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && mma_fits(H, Cin, Cout))
    return launch_mma(x, w, bias, out, B, H, Cin, Cout, s);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, bias, out, B, H, Cin, Cout, s);
  return launch<float>(x, w, bias, out, B, H, Cin, Cout, s);
}
