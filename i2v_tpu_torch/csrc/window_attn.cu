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
//   - The softmax is exact: scores, sums and products in float32, whatever
//     the input type; float32 or bfloat16 in, the same type out. Each
//     exponential is one ex2.approx.ftz of s·log2 e - m (2 ulp; a term under
//     2^-126 of the reference flushes to 0), m a row's running reference
//     maximum (times log2 e), which the online softmax moves only when a score
//     passes it by 2^8, so p <= 2^8 before the final division by the row's
//     sum. Nothing runs on the tensor cores, so PyTorch's TF32 flags do not
//     apply.
//
// Replaces no TPU kernel: the JAX package has no Swin. The plain PyTorch
// version is i2v_tpu_torch/models/swin3d.py, window_attention_plain, the
// oracle on the card; it materialises the (windows, heads, N, N) scores and
// passes them through device memory about seven times (product, bias, mask,
// softmax in and out, the read by ·v): 17 GB a clip at 32x224^2.
//
// What bounds it: float32 FFMA on the CUDA cores. A (window, head) does
// 4·N²·32 FLOPs (q·kᵀ and p·v, 19.7 MFLOP at N = 392) over (3·N·32 + N·32)
// values moved, 98 FLOPs a byte in float32 against the card's ridge of 20 (67
// TFLOP/s over 3.35 TB/s): 78 GFLOP a Swin-B clip, 1.17 ms at the float32 peak.
// So both products run as register-tiled outer products, as a SIMT SGEMM does:
// each shared-memory read feeds a tile of FFMAs.
//
// Tiles, at N = 392 (any N from 1 to 392 runs, the warps and tiles sized from
// N: 36 in swin3d_tiny, 196 or 75 on clipped grids):
//   - A block takes one (window, head) and all N of its queries: ceil(N/56)
//     warps, 7 at N = 392, no idle thread; K and V are loaded once.
//   - A warp owns 56 queries: 8 groups of 4 lanes, a group 7 query rows. Keys
//     go in tiles of 28, 7 to a lane (lane l of a group takes keys l, l+4, ...).
//   - q·kᵀ: a thread holds a 7 x 7 score tile and adds rank-4 updates over the
//     32 head dims, reading Q and K rows kept row-major in shared memory (36
//     floats a row, so that the 8 groups' q reads and the 4 lanes' k reads of a
//     step fall on distinct bank quads): 14 LDS.128 feed 196 FFMAs, 1 to 14.
//     The tile starts from its bias (one table gather a score, code[i] -
//     code[j] + corner) and mask (a compare of region ids).
//   - p·v: the tile's p goes through the warp's own buffer in shared memory
//     (28 keys x 68 floats, p transposed, each group's 7 rows at a
//     bank-swizzled place), under __syncwarp only; a thread holds o for its 7
//     rows x 8 of the 32 output dims, so a key costs 2 LDS.128 of p and 2 of v
//     for 56 FFMAs, 1 to 14. Each lane keeps its own part of the row sums,
//     added across the group's 4 lanes once at the end.
//   - Tails: a query row past N computes and stores nothing, a key past N
//     scores -inf.
//   - Loads: the table column and the q, k and v rows go straight into shared
//     memory with cp.async (bfloat16 is widened to float on the way), the keys
//     past 112 in a second group that lands while the first four tiles run.
//
// Resources a block at N = 392: shared memory Q and K 56.4 KB each, V 50.2 KB,
// the seven P buffers 53.3 KB, the head's table column (2535 floats) 10.1 KB,
// a code and region id a token 3.1 KB: 229.7 KB of the 227 KB (232,448 bytes)
// a block may have, so one block, 7 warps, an SM; 254 registers a thread
// (__launch_bounds__(224, 1) allows 255), no spills. The 7 warps sit 2, 2, 2
// and 1 on the SM's 4 schedulers, and 8 warps is the most that the registers
// and the P buffers allow: at most 2 warps a scheduler to hide latency, and
// the kernel runs near half of the FFMA peak (PERF.md §6 has its readings).
//
// The kernel's name is window_attn_fwd_kernel: a profiler classes kernels by
// their names, this one must read as neither a GEMM nor a convolution, and the
// benchmark's window-attention metrics find it by that name.
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
constexpr int kRows = 7;                  // query rows a thread (and its group)
constexpr int kLanes = 4;                 // lanes a group: 8 output dims each
constexpr int kKeys = 7;                  // keys a lane a tile
constexpr int kTile = kLanes * kKeys;     // 28 keys a tile
constexpr int kWarpRows = 8 * kRows;      // 56 query rows a warp
constexpr int kMaxTokens = 392;           // 8·7·7
constexpr int kMaxThreads = 32 * kMaxTokens / kWarpRows;  // 224
constexpr int kStride = kHeadDim + 4;     // floats a Q or K row in shared memory
constexpr int kPStride = 68;              // floats a key's row of a P buffer
constexpr int kFirstKeys = 4 * kTile;     // keys of the first copy group
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -100.0f;
constexpr float kSlack = 8.0f;            // log2 of how far p may pass 1

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  // 4 elements from p (16-byte aligned) into shared s, asynchronously
  static __device__ __forceinline__ void copy4(float* s, const float* p) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(p));
  }
  // 8 elements v to p (16-byte aligned)
  static __device__ __forceinline__ void store8(float* p, const float* v) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  // 4 elements from p (8-byte aligned) into shared s, widened to float
  static __device__ __forceinline__ void copy4(float* s, const __nv_bfloat16* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    *reinterpret_cast<float4*>(s) = make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
};

// The shift region (0, 1, 2) of coordinate c of a padded axis of size p in the
// rolled frame; an unshifted axis is one region.
__device__ __forceinline__ int axis_region(int c, int p, int win, int shift) {
  if (shift == 0) return 0;
  return (c >= p - win) + (c >= p - shift);
}

// Query rows (a multiple of 56) and keys (a multiple of 28) a block lays out.
__host__ __device__ __forceinline__ int padded_rows(int n) {
  return (n + kWarpRows - 1) / kWarpRows * kWarpRows;
}
__host__ __device__ __forceinline__ int padded_keys(int n) {
  return (n + kTile - 1) / kTile * kTile;
}

// Block b: window b / heads, head b % heads; ceil(n/56) warps.
template <typename T, bool kShifted>
__global__ void __launch_bounds__(kMaxThreads, 1)
window_attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                       T* __restrict__ out, Geometry g, float scale) {
  extern __shared__ float4 smem4[];
  const int rows = padded_rows(g.n), keys = padded_keys(g.n);  // keys <= rows
  float* qs = reinterpret_cast<float*>(smem4);  // rows x kStride, q·scale
  float* ks = qs + rows * kStride;              // keys x kStride
  float* vs = ks + keys * kStride;              // keys x 32
  float* ps = vs + keys * kHeadDim;             // a warp's kTile x kPStride each
  float* tab = ps + (rows / kWarpRows) * kTile * kPStride;  // table_rows
  int* code = reinterpret_cast<int*>(tab + g.table_rows);   // rows
  int* region = code + rows;                                // rows

  const int window = blockIdx.x / g.heads;
  const int head = blockIdx.x % g.heads;
  const int c = g.heads * kHeadDim;
  const int64_t row = 3LL * c;  // elements of one token's q, k and v
  const T* base = qkv + (int64_t)window * g.n * row + head * kHeadDim;

  // the head's column of the table, 4 bytes a copy
  for (int r = threadIdx.x; r < g.table_rows; r += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(tab + r));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(table + (int64_t)r * g.heads + head));
  }
  // q of every row, then k and v in two groups: the first 112 keys, with the
  // table, before any tile runs; the rest while the first four tiles run.
  // Rows past n are zero.
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x; idx < rows * (kHeadDim / 4); idx += blockDim.x) {
    const int t = idx / (kHeadDim / 4), part = idx % (kHeadDim / 4) * 4;
    float* qd = qs + t * kStride + part;
    if (t < g.n) {
      Io<T>::copy4(qd, base + t * row + part);
    } else {
      *reinterpret_cast<float4*>(qd) = zero;
    }
  }
  const int split = min(keys, kFirstKeys);
  for (int group = 0; group < 2; ++group) {
    const int lo = group == 0 ? 0 : split, hi = group == 0 ? split : keys;
    for (int idx = threadIdx.x; idx < (hi - lo) * (kHeadDim / 4); idx += blockDim.x) {
      const int t = lo + idx / (kHeadDim / 4), part = idx % (kHeadDim / 4) * 4;
      float* kd = ks + t * kStride + part;
      float* vd = vs + t * kHeadDim + part;
      if (t < g.n) {
        const T* src = base + t * row + part;
        Io<T>::copy4(kd, src + c);
        Io<T>::copy4(vd, src + 2 * c);
      } else {
        *reinterpret_cast<float4*>(kd) = zero;
        *reinterpret_cast<float4*>(vd) = zero;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const int in_clip = window % g.windows_per_clip;
  const int wd = in_clip / (g.count_h * g.count_w);
  const int wh = in_clip / g.count_w % g.count_h;
  const int ww = in_clip % g.count_w;
  const int span_h = 2 * g.full_h - 1, span_w = 2 * g.full_w - 1;
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    // the index code from the token's coordinates in the configured window
    // (0 past n, which keeps the gather inside the table; such a key scores
    // -inf, such a query is not stored)
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
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  // this thread's own copies of q have landed: pre-scale them
  for (int idx = threadIdx.x; idx < g.n * (kHeadDim / 4); idx += blockDim.x) {
    float4* qd = reinterpret_cast<float4*>(qs + idx / (kHeadDim / 4) * kStride) +
                 idx % (kHeadDim / 4);
    const float4 v = *qd;
    *qd = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / kLanes, sub = lane % kLanes;
  const int row0 = warp * kWarpRows + grp * kRows;  // this thread's first query
  // this group's 8 floats in each key's row of the warp's P buffer: quads
  // 2·grp + grp/4 and the next, so that the 8 groups' reads of one key fall
  // on 8 distinct bank quads
  const int slot = 4 * (2 * grp + grp / 4);
  float* pw = ps + warp * kTile * kPStride;
  const float4* q4 = reinterpret_cast<const float4*>(qs + row0 * kStride);

  int bias_at[kRows], my_region[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    bias_at[r] = code[row0 + r] + g.corner;
    my_region[r] = kShifted ? region[row0 + r] : 0;
  }
  // m: each row's reference maximum times log2 e; l: this lane's part of its sum
  float o[kRows][8], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[r][e] = 0.f;
  }

  for (int j0 = 0; j0 < keys; j0 += kTile) {
    if (j0 == kFirstKeys) {  // the second group of keys has landed
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    // the score tile starts from its bias and mask
    float s[kRows][kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int j = j0 + sub + kLanes * u;
      const int key_code = code[j];
      const int key_region = kShifted ? region[j] : 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float b = tab[bias_at[r] - key_code];
        if (kShifted && key_region != my_region[r]) b += kMaskValue;
        s[r][u] = b;
      }
    }
    // q·kᵀ by rank-4 updates: this lane's keys are rows j0 + sub + 4u of K
    const float4* k4 = reinterpret_cast<const float4*>(ks + (j0 + sub) * kStride);
#pragma unroll
    for (int d = 0; d < kHeadDim / 4; ++d) {
      float4 kv[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) kv[u] = k4[u * kLanes * (kStride / 4) + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = q4[r * (kStride / 4) + d];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          s[r][u] = fmaf(qv.x, kv[u].x, s[r][u]);
          s[r][u] = fmaf(qv.y, kv[u].y, s[r][u]);
          s[r][u] = fmaf(qv.z, kv[u].z, s[r][u]);
          s[r][u] = fmaf(qv.w, kv[u].w, s[r][u]);
        }
      }
    }
    if (j0 + kTile > g.n) {  // the last tile's keys past n are no keys
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        if (j0 + sub + kLanes * u >= g.n) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r][u] = -INFINITY;
        }
      }
    }
    // online softmax: m, a row's reference maximum, moves to the row's maximum
    // over the group's 28 keys (two shuffles), and o and l are rescaled, only
    // when some row of the warp has a score more than 2^kSlack past it; so p
    // stays at most 2^kSlack and mostly nothing crosses lanes
    float top[kRows];
    bool over = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float t = s[r][0];
#pragma unroll
      for (int u = 1; u < kKeys; ++u) t = fmaxf(t, s[r][u]);
      top[r] = t * kLog2e;
      over |= top[r] > m[r] + kSlack;
    }
    if (__any_sync(0xffffffffu, over)) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float t = top[r];
        t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
        t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
        const float m_new = fmaxf(m[r], t);
        const float alpha = m_new == m[r] ? 1.f : ex2(m[r] - m_new);  // 0 on the first tile
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[r][e] *= alpha;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        s[r][u] = ex2(fmaf(s[r][u], kLog2e, -m[r]));
        sum += s[r][u];
      }
      l[r] += sum;
    }
    // p into the warp's buffer, transposed: key row sub + 4u, this group's slot
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      float4* pr = reinterpret_cast<float4*>(pw + (sub + kLanes * u) * kPStride + slot);
      pr[0] = make_float4(s[0][u], s[1][u], s[2][u], s[3][u]);
      pr[1] = make_float4(s[4][u], s[5][u], s[6][u], 0.f);
    }
    __syncwarp();
    // p·v: every key of the tile, this lane's 8 output dims
    const float4* p4 = reinterpret_cast<const float4*>(pw + slot);
    const float4* v4 = reinterpret_cast<const float4*>(vs + j0 * kHeadDim) + 2 * sub;
#pragma unroll 7
    for (int jj = 0; jj < kTile; ++jj) {
      const float4 pa = p4[jj * (kPStride / 4)], pb = p4[jj * (kPStride / 4) + 1];
      const float4 va = v4[jj * (kHeadDim / 4)], vb = v4[jj * (kHeadDim / 4) + 1];
      const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        o[r][0] = fmaf(p[r], va.x, o[r][0]);
        o[r][1] = fmaf(p[r], va.y, o[r][1]);
        o[r][2] = fmaf(p[r], va.z, o[r][2]);
        o[r][3] = fmaf(p[r], va.w, o[r][3]);
        o[r][4] = fmaf(p[r], vb.x, o[r][4]);
        o[r][5] = fmaf(p[r], vb.y, o[r][5]);
        o[r][6] = fmaf(p[r], vb.z, o[r][6]);
        o[r][7] = fmaf(p[r], vb.w, o[r][7]);
      }
    }
    __syncwarp();  // the buffer is read before the next tile writes it
  }

  // each row's sum over the group's lanes, then normalise and store
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float total = l[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const float inv = 1.0f / total;
    const int i = row0 + r;
    if (i < g.n) {
#pragma unroll
      for (int e = 0; e < 8; ++e) o[r][e] *= inv;
      Io<T>::store8(out + ((int64_t)window * g.n + i) * c + head * kHeadDim + 8 * sub, o[r]);
    }
  }
}

size_t smem_bytes(const Geometry& g) {
  const int rows = padded_rows(g.n), keys = padded_keys(g.n);
  return (size_t)(rows * kStride + keys * (kStride + kHeadDim) +
                  rows / kWarpRows * kTile * kPStride + g.table_rows) * sizeof(float) +
         2 * (size_t)rows * sizeof(int);
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
  const int threads = padded_rows(g.n) / kWarpRows * 32;
  kernel<<<(unsigned)(windows * g.heads), threads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(table), static_cast<T*>(out), g,
      scale);
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
