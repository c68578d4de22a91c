// Train-mode BatchNorm forward over an NHWC map for Hopper (sm_90a), as two
// passes: per-channel statistics, then a folded affine + ReLU.
//
// Replaces surya_tpu/ops/pallas/stem_bn.py::_stats_kernel (entry
// channel_stats) and ::_affine_relu_kernel (entry affine_relu). The map is
// read as an (N, C) row matrix, N = B*H*W, in f32 or bf16.
//
// Bound: both passes are bound by memory. At the stem shape
// (256, 112, 112, 64) in bf16 the map is 411 MB: the statistics pass reads
// it once, the affine pass reads and writes it once, and each does one or
// two operations per element. The design therefore moves every byte once,
// 16 bytes a thread where the rows allow it (C * sizeof a multiple of 16 and
// a 16-byte aligned base), with neighbouring threads on neighbouring
// addresses, and keeps enough loads in flight to cover the memory latency.
//
// - Statistics: the TPU kernel carries its sums in scratch memory across a
//   sequential grid. Blocks here run in parallel, so each block sums its
//   rows into registers (a thread owns one 16-byte column group and strides
//   over rows), folds its threads in shared memory in a fixed order, and
//   writes one (2, C) f32 partial; a second small launch adds the partials
//   in block order. No atomics: the result is the same in every run. The
//   TPU kernel's (N/2, 2C) lane packing, its padding to 4096 rows and its
//   C = 64 restriction serve Mosaic's tiling and are not carried over: any C
//   and any N are taken.
// - Affine + ReLU: y = relu(x * a[c] + b[c]) with one fused multiply-add per
//   element in f32, output in x's dtype. a and b are C floats read through
//   the read-only cache. Forward only, as the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // blocks of the statistics pass

// A column group: VEC consecutive channels of one row, VEC * sizeof(T) = 16
// bytes (or one element when the rows do not allow 16-byte loads).
template <typename T, int VEC>
__device__ __forceinline__ void load_group(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 2)
      v[0] = __bfloat162float(*p);
    else
      v[0] = *p;
  } else if constexpr (sizeof(T) == 2) {  // 8 bf16
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {  // 4 f32
    const float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_group(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 2)
      *p = __float2bfloat16(v[0]);
    else
      *p = v[0];
  } else if constexpr (sizeof(T) == 2) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---- statistics ---------------------------------------------------------
// Block (bx, by): threads (tx, ty), tx < TX the column group by*TX + tx,
// ty < TY = THREADS/TX a row lane. Rows bx*TY + ty, then stride
// gridDim.x*TY. partial[(bx*2 + stat)*C + channel].
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
             long long N, int C, int TX) {
  __shared__ float red[THREADS * 2 * VEC];
  const int TY = THREADS / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int groups = C / VEC;
  const int cg = blockIdx.y * TX + tx;
  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  if (cg < groups) {
    const long long stride = static_cast<long long>(gridDim.x) * TY;
#pragma unroll 4
    for (long long r = static_cast<long long>(blockIdx.x) * TY + ty; r < N;
         r += stride) {
      float v[VEC];
      load_group<T, VEC>(x + r * C + static_cast<long long>(cg) * VEC, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        ss[i] = fmaf(v[i], v[i], ss[i]);
      }
    }
  }
  // fold the TY row lanes of each column group, in a fixed tree order
  float* mine = red + threadIdx.x * 2 * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mine[i] = s[i];
    mine[VEC + i] = ss[i];
  }
  __syncthreads();
  for (int half = TY / 2; half > 0; half /= 2) {
    if (ty < half) {
      const float* other = red + (threadIdx.x + half * TX) * 2 * VEC;
#pragma unroll
      for (int i = 0; i < 2 * VEC; ++i) mine[i] += other[i];
    }
    __syncthreads();
  }
  if (ty == 0 && cg < groups) {
    float* p = partial + static_cast<size_t>(blockIdx.x) * 2 * C + cg * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      p[i] = mine[i];
      p[C + i] = mine[VEC + i];
    }
  }
}

// out[stat*C + c] = sum over blocks, in block order.
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n_blocks,
                                    int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * C) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b)
    s += partial[static_cast<size_t>(b) * 2 * C + idx];
  out[idx] = s;
}

int stats_tx(int groups) {  // power of two, at most 32
  int tx = 1;
  while (tx < groups && tx < 32) tx *= 2;
  return tx;
}

template <typename T, int VEC>
int launch_stats(const void* x, void* partial, void* out, long long N, int C,
                 int n_blocks, cudaStream_t s) {
  const int groups = C / VEC, tx = stats_tx(groups);
  dim3 grid(n_blocks, (groups + tx - 1) / tx);
  stats_kernel<T, VEC><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), N, C, tx);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  stats_reduce_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_blocks,
      C);
  return static_cast<int>(cudaGetLastError());
}

// ---- affine + ReLU ---------------------------------------------------------
// The map as a flat stream of column groups; group g holds channels
// (g % (C/VEC)) * VEC .. + VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
affine_relu_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, T* __restrict__ y,
                   long long n_groups, int C) {
  const int groups = C / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       g < n_groups; g += stride) {
    const int c0 = static_cast<int>(g % groups) * VEC;
    float v[VEC];
    load_group<T, VEC>(x + g * VEC, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = fmaxf(fmaf(v[i], __ldg(a + c0 + i), __ldg(b + c0 + i)), 0.f);
    store_group<T, VEC>(y + g * VEC, v);
  }
}

template <typename T, int VEC>
int launch_affine(const void* x, const void* a, const void* b, void* y,
                  long long N, int C, cudaStream_t s) {
  const long long n_groups = N * (C / VEC);
  long long blocks = (n_groups + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  affine_relu_kernel<T, VEC><<<static_cast<int>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(y), n_groups, C);
  return static_cast<int>(cudaGetLastError());
}

bool vectorised(const void* p, int C, int elem) {
  return (static_cast<long long>(C) * elem) % 16 == 0 &&
         reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

// Blocks (rows of the partial buffer) the statistics pass uses for N rows
// of C channels: the wrapper allocates partial (n_blocks, 2, C) f32.
extern "C" int stem_bn_stats_blocks(long long N, int C, int is_bf16) {
  const int vec = (static_cast<long long>(C) * (is_bf16 ? 2 : 4)) % 16 == 0
                      ? (is_bf16 ? 8 : 4)
                      : 1;
  const int ty = THREADS / stats_tx(C / vec);
  long long blocks = (N + ty - 1) / ty;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// x (N, C) rows in f32 or bf16; partial (n_blocks, 2, C) f32 scratch with
// n_blocks = stem_bn_stats_blocks(N, C, is_bf16); out (2, C) f32: the
// per-channel sum and sum of squares.
extern "C" int stem_bn_channel_stats(const void* x, void* partial, void* out,
                                     long long N, int C, int is_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = stem_bn_stats_blocks(N, C, is_bf16);
  if (is_bf16) {
    if (vectorised(x, C, 2))
      return launch_stats<bf16, 8>(x, partial, out, N, C, n_blocks, s);
    // the block count was sized for 16-byte groups; it only bounds the grid
    return launch_stats<bf16, 1>(x, partial, out, N, C, n_blocks, s);
  }
  if (vectorised(x, C, 4))
    return launch_stats<float, 4>(x, partial, out, N, C, n_blocks, s);
  return launch_stats<float, 1>(x, partial, out, N, C, n_blocks, s);
}

// y = relu(x * a + b) per channel: x, y (N, C) rows in f32 or bf16 (two
// buffers), a, b (C,) f32.
extern "C" int stem_bn_affine_relu(const void* x, const void* a,
                                   const void* b, void* y, long long N, int C,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vectorised(x, C, 2) && vectorised(y, C, 2))
      return launch_affine<bf16, 8>(x, a, b, y, N, C, s);
    return launch_affine<bf16, 1>(x, a, b, y, N, C, s);
  }
  if (vectorised(x, C, 4) && vectorised(y, C, 4))
    return launch_affine<float, 4>(x, a, b, y, N, C, s);
  return launch_affine<float, 1>(x, a, b, y, N, C, s);
}
