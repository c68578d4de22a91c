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
// first output word. The mask is a pure function of (seed, row, unit): it
// does not depend on the tiling. The TPU kernel seeds its hardware generator
// per batch block; those bits cannot be reproduced here, only their law.
//
// Bound: at B=64 the head reads W1 (2688 x 5376, 28.9 MB in bf16) once and
// does ~1.9 GFLOP, so it is bound by memory. The TPU kernel holds all of
// W1 in VMEM per batch block; 227 KB of shared memory cannot, so here the
// grid runs over (hidden tiles of 16) x (row blocks of 64): 168 blocks at
// B=64, every W1 byte read by exactly one block. Each block streams its
// W1 rows and the x rows through a two-stage cp.async ring, multiplies
// them on the tensor cores (WMMA, bf16 in, f32 out; the f32 variant uses
// CUDA-core FMA), applies b1 + ReLU, rounds h, and multiplies by its slice
// of W2 into f32 partial logits (n_tiles, B, C). A second small launch
// sums the partials in a fixed order and adds b2: deterministic, no
// atomics, and h never reaches device memory in the inference form.
// Dropout is per hidden unit, so it lives inside a tile's epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int HT = 16;  // hidden units per block

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
};

// ---- epilogue shared by both variants --------------------------------
// hs: (rows, HT) f32 pre-activations in shared memory, leading dim ldh.
// Writes partial[(tile*B + row)*C + c] = sum_j h[row][j] * w2[c][h0+j].
template <typename T, bool TRAIN>
__device__ void head_epilogue(float* hs, int ldh, int rows,
                              const float* __restrict__ b1,
                              const T* __restrict__ w2,
                              float* __restrict__ partial, int row0, int B,
                              int H, int C, TrainArgs ta) {
  const int h0 = blockIdx.x * HT;
  for (int idx = threadIdx.x; idx < rows * HT; idx += blockDim.x) {
    const int r = idx / HT, j = idx % HT;
    float h = 0.f;
    if (h0 + j < H) {
      h = fmaxf(hs[r * ldh + j] + b1[h0 + j], 0.f);
      if constexpr (TRAIN) {
        if (ta.threshold != 0u && h > 0.f) {
          const unsigned bits =
              philox_bits(static_cast<unsigned long long>(*ta.seed),
                          static_cast<unsigned>(row0 + r),
                          static_cast<unsigned>(h0 + j));
          h = bits >= ta.threshold ? h * ta.scale : 0.f;
        }
      }
      if constexpr (sizeof(T) == 2) h = __bfloat162float(__float2bfloat16(h));
      if constexpr (TRAIN) {
        if (ta.h_out != nullptr && row0 + r < B) {
          T* hp = static_cast<T*>(ta.h_out) +
                  static_cast<size_t>(row0 + r) * H + h0 + j;
          if constexpr (sizeof(T) == 2)
            *hp = __float2bfloat16(h);
          else
            *hp = h;
        }
      }
    }
    hs[r * ldh + j] = h;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    if (row0 + r >= B) continue;
    float s = 0.f;
    for (int j = 0; j < HT && h0 + j < H; ++j) {
      float wv;
      if constexpr (sizeof(T) == 2)
        wv = __bfloat162float(w2[static_cast<size_t>(c) * H + h0 + j]);
      else
        wv = w2[static_cast<size_t>(c) * H + h0 + j];
      s = fmaf(hs[r * ldh + j], wv, s);
    }
    partial[(static_cast<size_t>(blockIdx.x) * B + row0 + r) * C + c] = s;
  }
}

// ---- bf16: WMMA tensor cores, cp.async double buffer --------------------
constexpr int RB16 = 64;        // rows per block: 4 warps x 16
constexpr int KC16 = 128;       // K chunk
constexpr int LDS16 = KC16 + 8; // padded smem row (bf16), multiple of 8
constexpr int LDH16 = HT + 4;   // f32 epilogue row

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 → zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

template <bool TRAIN>
__global__ void __launch_bounds__(128)
head_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 float* __restrict__ partial, int B, int D, int H, int C,
                 TrainArgs ta) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 xs[2][RB16][LDS16];
  __shared__ __align__(128) bf16 ws[2][HT][LDS16];
  const int h0 = blockIdx.x * HT, row0 = blockIdx.y * RB16;
  const int warp = threadIdx.x / 32;
  constexpr int SEGS = KC16 / 8;  // 16-byte segments per chunk row

  auto load_chunk = [&](int s, int k0) {
    for (int idx = threadIdx.x; idx < (RB16 + HT) * SEGS; idx += blockDim.x) {
      const int row = idx / SEGS, k = k0 + (idx % SEGS) * 8;
      if (row < RB16) {
        const int g = row0 + row;
        const bool ok = g < B && k < D;
        cp_async16(&xs[s][row][(idx % SEGS) * 8],
                   ok ? x + static_cast<size_t>(g) * D + k : x, ok);
      } else {
        const int g = h0 + row - RB16;
        const bool ok = g < H && k < D;
        cp_async16(&ws[s][row - RB16][(idx % SEGS) * 8],
                   ok ? w1 + static_cast<size_t>(g) * D + k : w1, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  const int nk = (D + KC16 - 1) / KC16;
  load_chunk(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load_chunk((kc + 1) & 1, (kc + 1) * KC16);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int s = kc & 1;
#pragma unroll
    for (int kk = 0; kk < KC16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, &xs[s][warp * 16][kk], LDS16);
      wmma::load_matrix_sync(b, &ws[s][0][kk], LDS16);
      wmma::mma_sync(acc, a, b, acc);
    }
    __syncthreads();  // stage s is refilled next iteration
  }
  // The x ring is free now: reuse it for the (RB16, HT) f32 accumulators.
  float* hs = reinterpret_cast<float*>(&xs[0][0][0]);
  wmma::store_matrix_sync(hs + warp * 16 * LDH16, acc, LDH16,
                          wmma::mem_row_major);
  __syncthreads();
  head_epilogue<bf16, TRAIN>(hs, LDH16, RB16, b1, w2, partial, row0, B, H, C,
                             ta);
}

// ---- f32: CUDA-core FMA (exact f32 products, for parity checks) ---------
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
  head_epilogue<float, TRAIN>(hs, HT, RB32, b1, w2, partial, row0, B, H, C,
                              ta);
}

// out[row][c] = b2[c] + sum over tiles, in tile order.
__global__ void head_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ b2,
                                   float* __restrict__ out, int n_tiles,
                                   int B, int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[static_cast<size_t>(t) * B * C + idx];
  out[idx] = s + b2[idx % C];
}

template <bool TRAIN>
void launch_head(const void* x, const void* w1, const void* b1,
                 const void* w2, void* partial, int B, int D, int H, int C,
                 int is_bf16, TrainArgs ta, cudaStream_t s) {
  const int n_tiles = (H + HT - 1) / HT;
  if (is_bf16) {
    dim3 grid(n_tiles, (B + RB16 - 1) / RB16);
    head_bf16_kernel<TRAIN><<<grid, 128, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<float*>(partial), B, D, H, C, ta);
  } else {
    dim3 grid(n_tiles, (B + RB32 - 1) / RB32);
    head_f32_kernel<TRAIN><<<grid, 128, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<float*>(partial), B, D, H, C, ta);
  }
}

}  // namespace

extern "C" int fusion_head_n_tiles(int H) { return (H + HT - 1) / HT; }

// x (B,D), w1 (H,D), w2 (C,H) in one dtype (bf16 needs D % 8 == 0 and
// 16-byte aligned rows; the wrapper checks); b1 (H,), b2 (C,) f32;
// partial (n_tiles,B,C) f32 scratch; out (B,C) f32. Training form: h_out
// (B,H) in the compute dtype or null; threshold > 0 turns dropout on with
// the int64 seed at device address seed and scale = 1/(1-rate). With
// h_out null and threshold 0 this is the inference launch.
extern "C" int fusion_head_forward(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* partial, void* out,
                                   void* h_out, const void* seed, int B,
                                   int D, int H, int C, int is_bf16,
                                   unsigned threshold, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (H + HT - 1) / HT;
  const TrainArgs ta{h_out, static_cast<const long long*>(seed), threshold,
                     scale};
  if (h_out != nullptr || threshold != 0u)
    launch_head<true>(x, w1, b1, w2, partial, B, D, H, C, is_bf16, ta, s);
  else
    launch_head<false>(x, w1, b1, w2, partial, B, D, H, C, is_bf16, ta, s);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  head_reduce_kernel<<<(B * C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(b2),
      static_cast<float*>(out), n_tiles, B, C);
  return static_cast<int>(cudaGetLastError());
}
