// The core of the Video Swin Transformer's window attention, forward only,
// for Hopper (sm_90a): for every window w and head h,
//   out[w, :, h] = softmax(q·scale·kᵀ + bias + mask) · v
// with q, k, v of head dimension 32 read from the partitioned qkv
// (windows, N, 3, heads, 32) and the output written straight into the
// (windows, N, heads·32) layout that the projection reads.
//   - bias[i, j] = table[index(i, j), h], gathered from the (rows, heads)
//     relative-position table through the published relative index of the
//     configured window (8,7,7 for Swin-B), sliced to the first N tokens, as
//     the published code's index[:N, :N]; the index is computed from each
//     token's coordinates in that window, never read from a dense copy.
//   - mask[i, j] = -100 (not -inf) on a shifted block where tokens i and j lie
//     in different regions of the cyclic shift, from each token's coordinates
//     in the rolled, padded grid (the published compute_mask's three slices an
//     axis); 0 otherwise and on unshifted blocks.
//   - Padded tokens are not masked: they are keys like any other, as in the
//     published code.
//   - The softmax is exact, with the running maximum subtracted: scores, sums
//     and products in float32 (exp as 2^(x·log2 e), ex2 with its 2-ulp bound),
//     whatever the input type; float32 or bfloat16 in, the same type out.
//     Nothing runs on the tensor cores, so PyTorch's TF32 flags do not apply.
//
// Replaces no TPU kernel: the JAX package has no Swin. The plain PyTorch
// version is i2v_tpu_torch/models/swin3d.py, window_attention_plain, the
// oracle on the card; it materialises the (windows, heads, N, N) scores and
// passes them through device memory about seven times (product, bias, mask,
// softmax in and out, the read by ·v): 17 GB a clip at 32x224^2.
//
// What bounds it: float32 arithmetic. A (window, head) does 4·N²·32 FLOPs
// (q·kᵀ and p·v, 19.7 MFLOP at N = 392) over (3·N·32 + N·32) values moved, 98
// FLOPs a byte in float32 against the card's ridge of 20 (67 TFLOP/s over
// 3.35 TB/s): 78 GFLOP a Swin-B clip, 1.17 ms at the float32 peak.
//
// What the design does about it:
//   - A block takes one (window, head) and up to kQueries = 224 queries of it,
//     one a thread (two blocks for N = 392, 12.5% of the threads idle): it
//     loads the window's K and V for its head (2·392·32 floats, 100 KB), the
//     head's column of the table (2535 floats) and a code and region id for
//     each key into shared memory once, then each thread streams over every
//     key with its q (pre-scaled) and its 32 output sums in registers.
//   - Keys go kChunk = 8 at a time: eight independent dot products (ILP), one
//     maximum, one rescale of the sums and eight exponentials a chunk. K and V
//     rows are read as broadcast 16-byte shared loads (all lanes on one
//     address): 16 loads for 64 FMAs a key.
//   - The bias index is code[i] - code[j] + corner, one subtraction and one
//     shared load a score; the mask one compare of region ids.
//   - 113.6 KB of shared memory a block at N = 392, two blocks (14 warps) an SM;
//     __launch_bounds__(224, 2) caps the registers at 146 a thread.
//
// The kernel's name is window_attn_fwd_kernel: a profiler classes kernels by
// their names, and this one must read as neither a GEMM nor a convolution.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kQueries = 224;    // threads a block, one query each
constexpr int kChunk = 8;        // keys a step of the inner loop
constexpr int kMaxTokens = 392;  // 8·7·7
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -100.0f;

struct Geometry {
  int n;                          // tokens a window
  int heads;
  int windows_per_clip;
  int count_h, count_w;           // windows along H and W of a clip
  int win_d, win_h, win_w;        // the window used
  int pad_d, pad_h, pad_w;        // the padded grid
  int shift_d, shift_h, shift_w;  // the shift used
  int full_h, full_w;             // the configured window's H and W
  int corner;                     // the index of the relative offset (0, 0, 0)
  int table_rows;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  // 4 elements at p (16-byte aligned)
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store32(float* p, const float* v) {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  // 4 elements at p (8-byte aligned)
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  static __device__ __forceinline__ void store32(__nv_bfloat16* p, const float* v) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[8 * k + 2 * e], v[8 * k + 2 * e + 1]);
      q[k] = *reinterpret_cast<const uint4*>(h);
    }
  }
};

// The shift region (0, 1, 2) of coordinate c of a padded axis of size p in the
// rolled frame; an unshifted axis is one region.
__device__ __forceinline__ int axis_region(int c, int p, int win, int shift) {
  if (shift == 0) return 0;
  return (c >= p - win) + (c >= p - shift);
}

// Block (pair, tile): window pair / heads, head pair % heads, queries
// tile·kQueries + threadIdx.x.
template <typename T, bool kShifted>
__global__ void __launch_bounds__(kQueries, 2)
window_attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                       T* __restrict__ out, Geometry g, float scale) {
  extern __shared__ float4 smem4[];
  const int npad = (g.n + kChunk - 1) / kChunk * kChunk;
  float* ks = reinterpret_cast<float*>(smem4);  // npad x 32
  float* vs = ks + npad * kHeadDim;              // npad x 32
  float* tab = vs + npad * kHeadDim;             // table_rows
  int* code = reinterpret_cast<int*>(tab + g.table_rows);  // npad
  int* region = code + npad;                               // npad

  const int window = blockIdx.x / g.heads;
  const int head = blockIdx.x % g.heads;
  const int c = g.heads * kHeadDim;
  const int64_t row = 3LL * c;  // elements of one token's q, k and v
  const T* base = qkv + (int64_t)window * g.n * row + head * kHeadDim;

  // K and V of this (window, head) as float; rows past n are zero
  for (int idx = threadIdx.x; idx < npad * (kHeadDim / 4); idx += blockDim.x) {
    const int t = idx / (kHeadDim / 4), part = idx % (kHeadDim / 4);
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (t < g.n) {
      kv = Io<T>::load4(base + t * row + c + part * 4);
      vv = Io<T>::load4(base + t * row + 2 * c + part * 4);
    }
    reinterpret_cast<float4*>(ks)[idx] = kv;
    reinterpret_cast<float4*>(vs)[idx] = vv;
  }
  for (int r = threadIdx.x; r < g.table_rows; r += blockDim.x) {
    tab[r] = __ldg(table + (int64_t)r * g.heads + head);
  }
  const int in_clip = window % g.windows_per_clip;
  const int wd = in_clip / (g.count_h * g.count_w);
  const int wh = in_clip / g.count_w % g.count_h;
  const int ww = in_clip % g.count_w;
  const int span_h = 2 * g.full_h - 1, span_w = 2 * g.full_w - 1;
  for (int t = threadIdx.x; t < npad; t += blockDim.x) {
    // the index code from the token's coordinates in the configured window
    // (0 past n, which keeps the gather inside the table; those keys score -inf)
    const int fd = t / (g.full_h * g.full_w), fh = t / g.full_w % g.full_h, fw = t % g.full_w;
    code[t] = t < g.n ? (fd * span_h + fh) * span_w + fw : 0;
    if (kShifted) {
      // the region from its coordinates in the rolled, padded grid
      const int td = t / (g.win_h * g.win_w), th = t / g.win_w % g.win_h, tw = t % g.win_w;
      region[t] = axis_region(wd * g.win_d + td, g.pad_d, g.win_d, g.shift_d) * 9 +
                  axis_region(wh * g.win_h + th, g.pad_h, g.win_h, g.shift_h) * 3 +
                  axis_region(ww * g.win_w + tw, g.pad_w, g.win_w, g.shift_w);
    }
  }
  __syncthreads();

  const int i = blockIdx.y * kQueries + threadIdx.x;
  if (i >= g.n) return;

  float q[kHeadDim];
#pragma unroll
  for (int p = 0; p < kHeadDim / 4; ++p) {
    const float4 v = Io<T>::load4(base + i * row + p * 4);
    q[4 * p] = v.x * scale;
    q[4 * p + 1] = v.y * scale;
    q[4 * p + 2] = v.z * scale;
    q[4 * p + 3] = v.w * scale;
  }
  const int bias_at = code[i] + g.corner;
  const int my_region = kShifted ? region[i] : 0;

  float o[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < npad; j0 += kChunk) {
    float s[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + u) * kHeadDim);
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < kHeadDim / 4; ++p) {
        const float4 k4 = kr[p];
        acc = fmaf(q[4 * p], k4.x, acc);
        acc = fmaf(q[4 * p + 1], k4.y, acc);
        acc = fmaf(q[4 * p + 2], k4.z, acc);
        acc = fmaf(q[4 * p + 3], k4.w, acc);
      }
      acc += tab[bias_at - code[j0 + u]];
      if (kShifted && region[j0 + u] != my_region) acc += kMaskValue;
      s[u] = acc;
    }
    if (j0 + kChunk > g.n) {  // the last chunk's rows past n are no keys
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (j0 + u >= g.n) s[u] = -INFINITY;
      }
    }
    float top = s[0];
#pragma unroll
    for (int u = 1; u < kChunk; ++u) top = fmaxf(top, s[u]);
    const float m_new = fmaxf(m, top);
    const float alpha = exp2f((m - m_new) * kLog2e);  // 0 on the first chunk
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] *= alpha;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float p = exp2f((s[u] - m_new) * kLog2e);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + u) * kHeadDim);
#pragma unroll
      for (int e = 0; e < kHeadDim / 4; ++e) {
        const float4 v4 = vr[e];
        o[4 * e] = fmaf(p, v4.x, o[4 * e]);
        o[4 * e + 1] = fmaf(p, v4.y, o[4 * e + 1]);
        o[4 * e + 2] = fmaf(p, v4.z, o[4 * e + 2]);
        o[4 * e + 3] = fmaf(p, v4.w, o[4 * e + 3]);
      }
    }
    m = m_new;
  }
  const float inv = 1.0f / l;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) o[d] *= inv;
  Io<T>::store32(out + ((int64_t)window * g.n + i) * c + head * kHeadDim, o);
}

size_t smem_bytes(const Geometry& g) {
  const int npad = (g.n + kChunk - 1) / kChunk * kChunk;
  return (size_t)(2 * npad * kHeadDim + g.table_rows) * sizeof(float) + 2 * npad * sizeof(int);
}

template <typename T, bool kShifted>
int launch_as(const void* qkv, const void* table, void* out, int64_t windows, const Geometry& g,
              float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(g);
  auto kernel = window_attn_fwd_kernel<T, kShifted>;
  // raised once per instantiation, card and size, on the first (eager) launch
  // of a shape: a graph capture of the same shape makes no such call
  constexpr int kCards = 64;
  static size_t allowed[kCards] = {};
  int card = 0;
  cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return (int)got;
  if (card < 0 || card >= kCards) return (int)cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > allowed[card]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    allowed[card] = bytes;
  }
  const dim3 grid((unsigned)(windows * g.heads), (unsigned)((g.n + kQueries - 1) / kQueries));
  kernel<<<grid, kQueries, bytes, stream>>>(static_cast<const T*>(qkv),
                                            static_cast<const float*>(table),
                                            static_cast<T*>(out), g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (windows, n, 3, heads, 32) contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); table: (rows, heads) float32 with rows = (2fd-1)(2fh-1)(2fw-1);
// out: (windows, n, heads·32) of qkv's type. The windows of a clip come in
// (D, H, W) order, count_d·count_h·count_w of them; n = win_d·win_h·win_w ≤
// 392 and each used window no larger than the configured one (fd, fh, fw).
extern "C" int window_attn_fwd(const void* qkv, const void* table, void* out, int64_t windows,
                               int heads, int count_d, int count_h, int count_w, int win_d,
                               int win_h, int win_w, int shift_d, int shift_h, int shift_w,
                               int full_d, int full_h, int full_w, float scale, int dtype,
                               cudaStream_t stream) {
  Geometry g;
  g.n = win_d * win_h * win_w;
  g.heads = heads;
  g.windows_per_clip = count_d * count_h * count_w;
  g.count_h = count_h;
  g.count_w = count_w;
  g.win_d = win_d;
  g.win_h = win_h;
  g.win_w = win_w;
  g.pad_d = count_d * win_d;
  g.pad_h = count_h * win_h;
  g.pad_w = count_w * win_w;
  g.shift_d = shift_d;
  g.shift_h = shift_h;
  g.shift_w = shift_w;
  g.full_h = full_h;
  g.full_w = full_w;
  g.corner = ((full_d - 1) * (2 * full_h - 1) + (full_h - 1)) * (2 * full_w - 1) + (full_w - 1);
  g.table_rows = (2 * full_d - 1) * (2 * full_h - 1) * (2 * full_w - 1);
  if (windows <= 0) return (int)cudaSuccess;
  if (g.n <= 0 || g.n > kMaxTokens || heads <= 0 || g.windows_per_clip <= 0 ||
      windows % g.windows_per_clip != 0 || win_d > full_d || win_h > full_h || win_w > full_w ||
      windows * heads > 2147483647LL || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const bool shifted = shift_d > 0 || shift_h > 0 || shift_w > 0;
  if (dtype == 0) {
    return shifted ? launch_as<float, true>(qkv, table, out, windows, g, scale, stream)
                   : launch_as<float, false>(qkv, table, out, windows, g, scale, stream);
  }
  return shifted ? launch_as<__nv_bfloat16, true>(qkv, table, out, windows, g, scale, stream)
                 : launch_as<__nv_bfloat16, false>(qkv, table, out, windows, g, scale, stream);
}
