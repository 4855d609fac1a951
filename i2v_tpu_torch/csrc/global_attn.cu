// UniFormer's global attention, forward only, for Hopper (sm_90a): for every
// clip b and head h of q, k and v (N tokens, head dimension 64),
//   out[b, i, h·64 + c] = sum_j softmax_j(q_i·k_j·64^-0.5) · v[j, c]
// with no bias, mask, class token or residual, written straight into the
// (clips, N, heads·64) layout that the projection reads. q, k and v are read
// where they lie, by strides: in the model they are the qkv Linear's output
// (clips, N, 3·heads·64) viewed as (clips, N, 3, heads, 64), so no permute
// or copy runs before the kernel, and no (N x N) score tensor exists anywhere.
//   - Products on the tensor cores, float32-accurate (3xTF32): every float32
//     operand x is split into two TF32 values, hi = cvt.rna.tf32(x) and lo =
//     cvt.rna.tf32(x - hi), and a product a·b is taken as lo_a·hi_b +
//     hi_a·lo_b + hi_a·hi_b, three TF32 MMAs summed in float32 (the lo·lo
//     term, 2^-22 of the product, is dropped). Both q·kᵀ and p·v run so. q is
//     scaled by 64^-0.5·log2 e and split once a block, k and v once a tile
//     as they land, p in registers after its exponential. PyTorch's TF32
//     flags do not apply.
//   - The tensor cores' float32 sums round toward zero, so a long chain of
//     MMAs into one accumulator drifts: each tile's s and each tile's p·v
//     start from zero, take their 16 small products (lo·hi, hi·lo) first,
//     while the sum is small, then the 8 large ones, and p·v is added to o
//     with IEEE float32 adds. One accumulator over all 3136 keys, the small
//     and large products of each k-step in turn, read 14x SDPA's error.
//   - bfloat16 q, k and v (the model's bfloat16 compute) run in the same
//     kernel with one TF32 MMA a product: a bfloat16 value is a TF32 value,
//     so q·kᵀ is exact before its float32 sums; the scale is applied to the
//     scores, and p is rounded to TF32 once. The output is rounded to
//     bfloat16 once.
//   - The softmax is exact in float32 and online (flash attention): each
//     row keeps its running maximum m (in log2 units) and its sum l, and o
//     and l are rescaled by 2^(m_old - m_new) when m moves. Exponentials are
//     ex2.approx.ftz (2 ulp); the final division is IEEE.
//
// Replaces no TPU kernel: the JAX package has no UniFormer. The plain PyTorch
// version is i2v_tpu_torch/models/uniformer.py, global_attention_plain (the
// scores materialised, as the published Attention computes them), the
// oracle on the card.
//
// What bounds it: the tensor cores' TF32 rate through three products, 494.7 /
// 3 = 164.9 TFLOP/s of float32-accurate products. A (clip, head) does 4·N²·64
// FLOPs (q·kᵀ and p·v) over q, k, v and o moved once, 4·N·64 values: at N =
// 3136 (UniFormer-B's stage 3) ~800 FLOPs a byte, far past the card's ridge.
// Stage 3's 20 blocks are 251.8 GFLOP a clip, 1.53 ms at that rate; stage 4's
// 7 blocks (8 heads over 784 tokens) 8.8 GFLOP, 0.05 ms. The FFMA route (67
// TFLOP/s) cannot pass 41% of that bound.
//
// Design (wgmma, Hopper's warpgroup MMA; PERF.md §6 compares it with an
// mma.sync design):
//   - A block is two warpgroups of 64 queries each, 128 queries of one
//     (clip, head); blocks run over the queries of a (clip, head) fastest,
//     so that the blocks on the card at one time read the same keys from L2.
//     Each warpgroup holds its q rows as the A operand in registers, hi and
//     lo (64 registers a thread), for the whole sweep over the keys.
//   - Keys go in tiles of 64. A tile's raw k and v land in shared memory by
//     16-byte cp.async two tiles ahead (rows past N zero-filled); while the
//     tensor cores take one tile's p·v, the block splits the next tile's k
//     and v into their B operands: K hi and lo as K-major rows of keys, v
//     transposed to K-major rows of dims (wgmma takes TF32 operands K-major
//     only), each a 64 x 64 tile in the 128-byte swizzle, two stages of them.
//   - q·kᵀ: 8 k-steps of m64n64k8, three wgmmas each; the accumulator comes
//     back in the mma.sync C layout (rows g and g + 8, columns 2t and 2t + 1
//     of each 8), where the softmax runs. p·v: the keys of each group of 8 are
//     stored in v's tile in the order 0 2 4 6 1 3 5 7, so that p's
//     accumulator is its own A fragment with no shuffle; 8 k-steps of three
//     wgmmas into the tile's fresh accumulator.
//   - Tails: a query past N computes from zero rows and stores nothing; a key
//     past N scores -inf, its v row zero.
//
// Resources a block: 256 threads; shared memory two stages of four 16 KB
// operand tiles and two of raw k and v (32 KB), 193 KB: one block an SM.
//
// The kernel's name is global_attn_fwd_kernel: the benchmark's global-attention
// metrics find it by that name.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kGroups = 2;                   // warpgroups a block, 64 queries each
constexpr int kThreads = 128 * kGroups;
constexpr int kRows = 64 * kGroups;          // queries a block
constexpr int kKeys = 64;                    // keys a tile
constexpr int kSteps = 8;                    // k-steps (of 8 dims or 8 keys) a tile
constexpr int kTileElems = 64 * 64;
constexpr int kTileBytes = kTileElems * 4;   // a 64 x 64 operand tile of TF32
constexpr int kAtomBytes = 64 * 128;         // its half along the contraction: 32 TF32 a row
constexpr int kStageBytes = 4 * kTileBytes;  // K hi, K lo, Vt hi, Vt lo
constexpr int kRawBytes = 2 * kTileBytes;    // a tile's raw k and v (float32 at most)
constexpr size_t kSmemBytes = 2 * kStageBytes + 2 * kRawBytes + 1024;  // + alignment
constexpr float kScaleLog2e = 0.125f * 1.4426950408889634f;            // 64^-0.5 · log2 e
constexpr int kCards = 64;

struct Geometry {
  int n;                              // tokens
  int heads;
  int q_blocks;                       // blocks a (clip, head)
  int64_t s_clip, s_head, s_token;    // elements, shared by q, k and v
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, two TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// this thread's shared-memory writes, visible to the wgmmas after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of d across a wgmma wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the descriptor of a K-major 64-row operand tile in the 128-byte swizzle
// (1024-byte aligned): rows 128 bytes apart, 8-row groups 1024 apart
__device__ __forceinline__ uint64_t descriptor(const uint8_t* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the descriptor at k-step `step` (8 TF32, 32 bytes, along the contraction)
__device__ __forceinline__ uint64_t at_step(uint64_t d, int step) {
  return d + (uint64_t)(((step / 4) * kAtomBytes + (step % 4) * 32) >> 4);
}

// d = a·b (+ d where `accumulate`), m64n64k8 TF32: a from registers, b a
// K-major shared tile
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// 4 TF32 values along the contraction from k0 into row `row` of a swizzled tile
__device__ __forceinline__ void put_chunk(uint8_t* tile, int row, int k0, uint4 v) {
  const int chunk = (k0 % 32) / 4;
  *reinterpret_cast<uint4*>(tile + (k0 / 32) * kAtomBytes + row * 128 +
                            ((chunk ^ (row & 7)) << 4)) = v;
}

// rows row0 .. row0 + 63 of one (clip, head)'s k or v (from `base`, a row
// every s_token elements) into dense shared rows by 16-byte cp.async, zero
// past the last token
template <typename T>
__device__ __forceinline__ void load_raw(T* dst, const T* base, int row0, const Geometry& g) {
  constexpr int kPer = 16 / sizeof(T), kChunks = kHeadDim / kPer;
  for (int idx = threadIdx.x; idx < kKeys * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks * kPer, i = row0 + r;
    const bool valid = i < g.n;
    const T* src = base + (valid ? (int64_t)i * g.s_token : 0) + c;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * kHeadDim + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  }
}

// x as the TF32 chunks hi (and lo where kSplit)
template <bool kSplit>
__device__ __forceinline__ void split4(const float (&x)[4], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (kSplit) {
      split(x[e], h[e], l[e]);
    } else {
      h[e] = __float_as_uint(x[e]);
    }
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

constexpr int kJobs = 64 * 16 / kThreads;  // 4-value chunks a thread a tile, of k or v

// A tile's raw k into its B operand of q·kᵀ: rows of keys, hi and lo. A
// warp reads along raw rows; its swizzled writes fall on distinct bank quads.
// Every load first, then every split and store.
template <typename T, bool kSplit>
__device__ __forceinline__ void prepare_k(const T* rk, uint8_t* stage) {
  float x[kJobs][4];
#pragma unroll
  for (int u = 0; u < kJobs; ++u) {
    const int j = threadIdx.x + u * kThreads;
    load4(rk + j / 16 * kHeadDim + j % 16 * 4, x[u]);
  }
#pragma unroll
  for (int u = 0; u < kJobs; ++u) {
    const int j = threadIdx.x + u * kThreads;
    uint4 hi, lo;
    split4<kSplit>(x[u], hi, lo);
    put_chunk(stage, j / 16, j % 16 * 4, hi);
    if (kSplit) put_chunk(stage + kTileBytes, j / 16, j % 16 * 4, lo);
  }
}

// A tile's raw v into its B operand of p·v: transposed to rows of dims, the
// keys of each group of 8 in the order 0 2 4 6 1 3 5 7, p's contraction
// order. A warp reads along the dims of raw rows.
template <typename T, bool kSplit>
__device__ __forceinline__ void prepare_v(const T* rv, uint8_t* stage) {
  float x[kJobs][4];
#pragma unroll
  for (int u = 0; u < kJobs; ++u) {
    const int j = threadIdx.x + u * kThreads, d = j % 64, r = j / 64;
#pragma unroll
    for (int e = 0; e < 4; ++e) x[u][e] = widen(rv[(8 * (r / 2) + r % 2 + 2 * e) * kHeadDim + d]);
  }
#pragma unroll
  for (int u = 0; u < kJobs; ++u) {
    const int j = threadIdx.x + u * kThreads, d = j % 64, r = j / 64;
    uint4 hi, lo;
    split4<kSplit>(x[u], hi, lo);
    put_chunk(stage + 2 * kTileBytes, d, 4 * r, hi);
    if (kSplit) put_chunk(stage + 3 * kTileBytes, d, 4 * r, lo);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Block b: (clip, head) b / q_blocks, queries from 128 · (b % q_blocks).
// kSplit: float32 operands through three TF32 products; else one (bfloat16).
template <typename T, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
global_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, Geometry g) {
  extern __shared__ uint8_t smem_base[];
  const uint32_t misalign = static_cast<uint32_t>(__cvta_generic_to_shared(smem_base)) & 1023;
  uint8_t* stages = smem_base + ((1024 - misalign) & 1023);     // 2 x kStageBytes
  T* raws = reinterpret_cast<T*>(stages + 2 * kStageBytes);     // 2 x (k, v)

  const int bh = blockIdx.x / g.q_blocks;  // clip · heads + head
  const int i0 = blockIdx.x % g.q_blocks * kRows;
  const int clip = bh / g.heads, head = bh % g.heads;
  const int64_t origin = clip * g.s_clip + head * g.s_head;
  const T* kb = k + origin;
  const T* vb = v + origin;
  const int tiles = (g.n + kKeys - 1) / kKeys;

  // raw tiles 0 and 1, one copy group each
  load_raw(raws, kb, 0, g);
  load_raw(raws + kTileElems, vb, 0, g);
  cp_async_commit();
  if (tiles > 1) {
    load_raw(raws + 2 * kTileElems, kb, kKeys, g);
    load_raw(raws + 3 * kTileElems, vb, kKeys, g);
  }
  cp_async_commit();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;  // a fragment's row group, column pair
  const int row0 = i0 + 64 * wg + 16 * warp + gid;  // this thread's rows: row0, row0 + 8

  // q as A fragments over the 8 k-steps of the head dims: a0 (row0, 8s + t),
  // a1 (row0 + 8, 8s + t), a2 and a3 the same rows at 8s + t + 4
  uint32_t qh[kSteps][4], ql[kSteps][4];
  {
    const T* q0 = q + origin + (int64_t)row0 * g.s_token;
    const T* q1 = q0 + 8 * g.s_token;
    const bool in0 = row0 < g.n, in1 = row0 + 8 < g.n;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int c = 8 * st + tig;
      const float x[4] = {in0 ? widen(q0[c]) : 0.f, in1 ? widen(q1[c]) : 0.f,
                          in0 ? widen(q0[c + 4]) : 0.f, in1 ? widen(q1[c + 4]) : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kSplit) {
          split(x[e] * kScaleLog2e, qh[st][e], ql[st][e]);
        } else {
          qh[st][e] = __float_as_uint(x[e]);
          ql[st][e] = 0u;
        }
      }
    }
  }

  cp_async_wait_one();  // tile 0 has landed
  __syncthreads();
  prepare_k<T, kSplit>(raws, stages);
  prepare_v<T, kSplit>(raws + kTileElems, stages);
  fence_proxy_async();
  __syncthreads();
  if (tiles > 2) {  // raw tile 2 into the buffer tile 0 has left
    load_raw(raws, kb, 2 * kKeys, g);
    load_raw(raws + kTileElems, vb, 2 * kKeys, g);
  }
  cp_async_commit();

  // o: rows row0 (elements 4nt, 4nt + 1) and row0 + 8 (4nt + 2, 4nt + 3) at
  // dims 8nt + 2t, + 1; m: each row's running maximum in log2 units; l: this
  // thread's part of each row's sum
  float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    const uint8_t* stage = stages + buf * kStageBytes;
    const uint64_t kh = descriptor(stage), kl = descriptor(stage + kTileBytes);
    const uint64_t vh = descriptor(stage + 2 * kTileBytes),
                   vl = descriptor(stage + 3 * kTileBytes);

    // s = q·kᵀ over the tile's 64 keys: the small products first, while the
    // sum is small, then the 8 large ones
    float s[32];
    wgmma_fence();
    if (kSplit) {
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        wgmma(s, ql[st], at_step(kh, st), st > 0);
        wgmma(s, qh[st], at_step(kl, st), 1);
      }
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) wgmma(s, qh[st], at_step(kh, st), kSplit || st > 0);
    wgmma_commit();
    if (tile + 1 < tiles) {  // every thread's copies of the next tile have landed
      cp_async_wait_one();
      __syncthreads();
    }
    wgmma_wait();
    pin(s);
    if (!kSplit) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= kScaleLog2e;
    }
    const int j0 = tile * kKeys;
    if (j0 + kKeys > g.n) {  // the ragged last tile: keys past N score -inf
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (j0 + 8 * (e / 4) + 2 * tig + (e & 1) >= g.n) s[e] = -INFINITY;
      }
    }

    // online softmax: each row's maximum over the quad's 4 threads
    float top[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) top[(e >> 1) & 1] = fmaxf(top[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 1));
      top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 2));
      const float alpha = ex2(m[r] - top[r]);  // 0 on the first tile
      m[r] = top[r];
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (((e >> 1) & 1) == r) o[e] *= alpha;
      }
    }
    // p of each k-step's 8 keys as its A fragment: keys 2t and 2t + 1 as
    // contraction indices t and t + 4
    uint32_t ph[kSteps][4], pl[kSteps][4];
#pragma unroll
    for (int kt = 0; kt < kSteps; ++kt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(s[4 * kt + e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      const float a[4] = {p[0], p[2], p[1], p[3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kSplit) {
          split(a[e], ph[kt][e], pl[kt][e]);
        } else {
          ph[kt][e] = tf32(a[e]);
          pl[kt][e] = 0u;
        }
      }
    }

    // the tile's p·v into a fresh accumulator, small products first, then
    // added to o
    float ot[32];
    wgmma_fence();
    if (kSplit) {
#pragma unroll
      for (int kt = 0; kt < kSteps; ++kt) {
        wgmma(ot, pl[kt], at_step(vh, kt), kt > 0);
        wgmma(ot, ph[kt], at_step(vl, kt), 1);
      }
    }
#pragma unroll
    for (int kt = 0; kt < kSteps; ++kt) wgmma(ot, ph[kt], at_step(vh, kt), kSplit || kt > 0);
    wgmma_commit();
    // the next tile's operands while the tensor cores take p·v (under q·kᵀ
    // they held the softmax back: PERF.md §6)
    if (tile + 1 < tiles) {
      const T* raw = raws + (buf ^ 1) * 2 * kTileElems;
      uint8_t* next = stages + (buf ^ 1) * kStageBytes;
      prepare_k<T, kSplit>(raw, next);
      prepare_v<T, kSplit>(raw + kTileElems, next);
    }
    fence_proxy_async();
    wgmma_wait();
    pin(ot);
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] += ot[e];
    __syncthreads();  // both warpgroups are done with this stage and raw buffer
    if (tile + 3 < tiles) {  // into the raw buffer the next tile has left
      load_raw(raws + (buf ^ 1) * 2 * kTileElems, kb, (tile + 3) * kKeys, g);
      load_raw(raws + (buf ^ 1) * 2 * kTileElems + kTileElems, vb, (tile + 3) * kKeys, g);
    }
    cp_async_commit();
  }

  // each row's sum over its quad, then normalise and store
  const int64_t width = (int64_t)g.heads * kHeadDim;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = l[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const float inv = 1.0f / total;
    const int i = row0 + 8 * r;
    if (i < g.n) {
      T* dst = out + ((int64_t)clip * g.n + i) * width + head * kHeadDim + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kSteps; ++nt) {
        store2(dst + 8 * nt, o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
      }
    }
  }
}

template <typename T, bool kSplit>
int launch_as(const void* q, const void* k, const void* v, void* out, int64_t blocks,
              const Geometry& g, cudaStream_t stream) {
  // raised once per card on the first (eager) launch: a graph capture of the
  // same kernel later makes no such call
  static bool raised[kCards] = {};
  int card = 0;
  cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return (int)got;
  if (card < 0 || card >= kCards) return (int)cudaErrorInvalidDevice;
  if (!raised[card]) {
    cudaError_t err = cudaFuncSetAttribute(global_attn_fwd_kernel<T, kSplit>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    raised[card] = true;
  }
  global_attn_fwd_kernel<T, kSplit><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (clips, heads, n, 64) of one dtype, float32 (dtype 0) or bfloat16
// (dtype 1), with one set of element strides (s_clip, s_head, s_token; the
// last stride 1), each row 16-byte aligned; out: (clips, n, heads·64)
// contiguous in that dtype, overlapping none of them.
extern "C" int global_attn_fwd(const void* q, const void* k, const void* v, void* out,
                               int64_t clips, int heads, int n, int64_t s_clip,
                               int64_t s_head, int64_t s_token, int dtype,
                               cudaStream_t stream) {
  if (clips <= 0) return (int)cudaSuccess;
  Geometry g;
  g.n = n;
  g.heads = heads;
  g.q_blocks = (n + kRows - 1) / kRows;
  g.s_clip = s_clip;
  g.s_head = s_head;
  g.s_token = s_token;
  const int64_t blocks = clips * heads * (int64_t)g.q_blocks;
  if (heads <= 0 || n <= 0 || dtype < 0 || dtype > 1 || blocks > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_as<float, true>(q, k, v, out, blocks, g, stream);
  return launch_as<__nv_bfloat16, false>(q, k, v, out, blocks, g, stream);
}
