// The core of MViTv2's pooling attention, forward only, for Hopper (sm_90a):
// for every clip b and head h, with q (1 + Nq queries), k and v (1 + Nk keys)
// pooled and normalised, head dimension 96, row 0 and key 0 the class token,
//   out[b, i, h] = softmax_j(q_i·k_j·scale + B[i, j]) · v + (i >= 1 ? q_i : 0)
// written straight into the (clips, 1 + Nq, heads·96) layout that the
// projection reads.
//   - B[i, j] = t_i[t(j)] + h_i[h(j)] + w_i[w(j)] for a spatial query i >= 1
//     and a spatial key j >= 1 at (t, h, w) of the (kt, kh, kw) key grid,
//     and 0 on the class token's row and column: the decomposed relative
//     positions, whose three per-query terms (Nq x kt, Nq x kh, Nq x kw a
//     clip and head) come computed from the unscaled q. No (Nq x Nk) score
//     tensor exists anywhere.
//   - The residual is the unscaled q (residual pooling), at every row but the
//     class token's.
//   - The softmax is exact: scores, sums and products in float32. Each
//     exponential is one ex2.approx.ftz of s·log2 e - m (2 ulp), m a row's
//     running reference maximum (times log2 e), which the online softmax
//     moves only when a score passes it by 2^8, so p <= 2^8 before the final
//     division by the row's sum. Float32 in and out; nothing runs on the
//     tensor cores, so PyTorch's TF32 flags do not apply.
//
// Replaces no TPU kernel: the JAX package has no MViT. The plain PyTorch
// version is i2v_tpu_torch/models/mvit.py, pool_attention_plain, the oracle
// on the card; the published code materialises the (Nq x Nk) scores and passes
// them through device memory about eight times (product, three broadcast adds,
// softmax in and out, the read by ·v): ~13 GB a clip at 32x224^2.
//
// What bounds it: float32 FFMA on the CUDA cores. A (clip, head) does
// 4·(1 + Nq)·(1 + Nk)·96 FLOPs (q·kᵀ and p·v) over q, k, v and the output
// moved once, ~380 FLOPs a byte against the card's ridge of 20 (67 TFLOP/s over
// 3.35 TB/s): 158.8 GFLOP a MViTv2-B clip, 2.37 ms at the float32 peak. So
// both products run as register-tiled outer products, as a SIMT SGEMM does,
// and K and V stream through shared memory in tiles shared by a block's 256
// queries (window_attn.cu's design, tiled for head dim 96 and long query runs).
//
// Tiles:
//   - A block takes 256 queries of one (clip, head), 8 warps of 32; blocks run
//     over the queries of a (clip, head) fastest, so that the blocks on the
//     card at one time read the same keys from L2. A warp whose queries all
//     lie past the last computes nothing.
//   - A warp is 4 groups of 8 lanes; group g owns the warp's rows g, g + 4,
//     ..., g + 28 (8 rows, interleaved so that the 4 groups' q reads of a step
//     fall on distinct bank quads: a Q row is 100 floats, 25 quads). Keys go in
//     tiles of 32, 4 to a lane (lane l of a group takes keys l, l + 8, ...).
//   - q·kᵀ: a thread holds an 8 x 4 score tile and adds rank-4 updates over
//     the 96 head dims: 12 LDS.128 feed 128 FFMAs. The tile then becomes
//     score·scale + B, the three terms read from the block's rows of them in
//     shared memory at the key's codes (t, kt + h, kt + kh + w), which the
//     loads of each key tile compute once.
//   - p·v: the tile's p goes through the warp's own buffer in shared memory
//     (32 keys x 32 floats, p transposed, each group's 8 rows in 2 quads),
//     under __syncwarp only; a thread holds o for its 8 rows x 12 of the 96
//     output dims (quads l, l + 8, l + 16), so a key costs 2 LDS.128 of p and
//     3 of v for 96 FFMAs. Each lane keeps its own part of the row sums, added
//     across the group's 8 lanes once at the end.
//   - Tails: a query row past the last computes and stores nothing useful
//     (its q and terms are zero), a key past the last scores -inf.
//   - Loads: the block's Q rows and terms go straight into shared memory with
//     cp.async, then K and V tiles double-buffered with cp.async: tile t + 1
//     lands while tile t is computed.
//
// Resources a block: shared memory Q 100 KB, K and V 2 x 12.5 KB and 2 x 12 KB,
// the eight P buffers 32 KB, the terms 256 x (kt + kh + kw) floats (30 KB at
// the first stage's 16 x 7 x 7 keys, 44 KB at block 2's 16 x 14 x 14) and the
// key codes 256 bytes: 225.3 KB at block 2, of the 227 KB (232,448 bytes) a
// block may have (kt + kh + kw <= 45 fits), so one block, 8 warps, an SM
// (PERF.md §6 has its registers and readings).
//
// The kernel's name is pool_attn_fwd_kernel: a profiler classes kernels by
// their names, this one must read as neither a GEMM nor a convolution, and the
// benchmark's pooling-attention metrics find it by that name.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 96;
constexpr int kQuads = kHeadDim / 4;           // 24
constexpr int kRows = 8;                       // query rows a thread (and its group)
constexpr int kLanes = 8;                      // lanes a group
constexpr int kGroups = 4;                     // groups a warp
constexpr int kKeys = 4;                       // keys a lane a tile
constexpr int kTile = kLanes * kKeys;          // 32 keys a tile
constexpr int kWarpRows = kGroups * kRows;     // 32 query rows a warp
constexpr int kWarps = 8;
constexpr int kBlockRows = kWarps * kWarpRows; // 256 query rows a block
constexpr int kThreads = 32 * kWarps;          // 256
constexpr int kStride = kHeadDim + 4;          // floats a Q or K row in shared memory
constexpr int kQStep = kStride / 4;            // quads a Q or K row: 25, odd
constexpr int kPRow = kGroups * kRows;         // floats a key's row of a P buffer: 32
constexpr int kMaxTerms = 45;                  // kt + kh + kw that shared memory holds
constexpr int kSpatial = 1 << 24;              // a key code's flag: a spatial key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSlack = 8.0f;                 // log2 of how far p may pass 1

struct Geometry {
  int nq1, nk1;     // queries and keys a (clip, head), the class token included
  int kt, kh, kw;   // the key grid
  int terms;        // kt + kh + kw
  int heads;
  int q_blocks;     // blocks a (clip, head)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from p (16-byte aligned) into shared s, asynchronously
__device__ __forceinline__ void copy16(float* s, const float* p) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(p));
}

// 4 bytes from p into shared s, asynchronously
__device__ __forceinline__ void copy4(float* s, const float* p) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(p));
}

size_t smem_bytes(int terms) {
  return (size_t)(kBlockRows * kStride + 2 * kTile * kStride + 2 * kTile * kHeadDim +
                  kWarps * kTile * kPRow + kBlockRows * terms) * sizeof(float) +
         2 * kTile * sizeof(int);
}

// Key tile `tile` of one (clip, head) into buffer `buf`: K and V rows by
// cp.async (zero past the last key), and each key's code: kSpatial | t |
// (kt + h) << 8 | (kt + kh + w) << 16 for a spatial key, 0 for the class token
// and past the last key.
__device__ __forceinline__ void load_keys(const float* kb, const float* vb, float* ks,
                                          float* vs, int* codes, int tile, int buf,
                                          const Geometry& g) {
  const int j0 = tile * kTile;
  for (int idx = threadIdx.x; idx < kTile * kQuads; idx += kThreads) {
    const int t = idx / kQuads, part = idx % kQuads * 4, j = j0 + t;
    float* kd = ks + (buf * kTile + t) * kStride + part;
    float* vd = vs + (buf * kTile + t) * kHeadDim + part;
    if (j < g.nk1) {
      copy16(kd, kb + (int64_t)j * kHeadDim + part);
      copy16(vd, vb + (int64_t)j * kHeadDim + part);
    } else {
      *reinterpret_cast<float4*>(kd) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vd) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    int code = 0;
    if (j >= 1 && j < g.nk1) {
      const int s = j - 1, hw = g.kh * g.kw;
      const int t = s / hw, h = s % hw / g.kw, w = s % g.kw;
      code = kSpatial | t | (g.kt + h) << 8 | (g.kt + g.kh + w) << 16;
    }
    codes[buf * kTile + threadIdx.x] = code;
  }
}

// Block b: (clip, head) b / q_blocks, queries from 256 · (b % q_blocks).
__global__ void __launch_bounds__(kThreads, 1)
pool_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ rel_t,
                     const float* __restrict__ rel_h, const float* __restrict__ rel_w,
                     float* __restrict__ out, Geometry g, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBlockRows x kStride, unscaled q
  float* ks = qs + kBlockRows * kStride;        // 2 x kTile x kStride
  float* vs = ks + 2 * kTile * kStride;         // 2 x kTile x kHeadDim
  float* ps = vs + 2 * kTile * kHeadDim;        // a warp's kTile x kPRow each
  float* ts = ps + kWarps * kTile * kPRow;      // kBlockRows x terms
  int* codes = reinterpret_cast<int*>(ts + kBlockRows * g.terms);  // 2 x kTile

  const int bh = blockIdx.x / g.q_blocks;       // clip · heads + head
  const int i0 = blockIdx.x % g.q_blocks * kBlockRows;
  const int nq = g.nq1 - 1;
  const float* qb = q + (int64_t)bh * g.nq1 * kHeadDim;
  const float* kb = k + (int64_t)bh * g.nk1 * kHeadDim;
  const float* vb = v + (int64_t)bh * g.nk1 * kHeadDim;

  // the block's q rows and their terms (zero on the class token's row and
  // past the last), with the first key tile, in the first copy group
  for (int idx = threadIdx.x; idx < kBlockRows * kQuads; idx += kThreads) {
    const int t = idx / kQuads, part = idx % kQuads * 4, i = i0 + t;
    float* qd = qs + t * kStride + part;
    if (i < g.nq1) {
      copy16(qd, qb + (int64_t)i * kHeadDim + part);
    } else {
      *reinterpret_cast<float4*>(qd) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int idx = threadIdx.x; idx < kBlockRows * g.terms; idx += kThreads) {
    const int t = idx / g.terms, c = idx % g.terms, i = i0 + t;
    if (i >= 1 && i < g.nq1) {
      const int64_t row = (int64_t)bh * nq + (i - 1);
      const float* src = c < g.kt          ? rel_t + row * g.kt + c
                         : c < g.kt + g.kh ? rel_h + row * g.kh + (c - g.kt)
                                           : rel_w + row * g.kw + (c - g.kt - g.kh);
      copy4(ts + idx, src);
    } else {
      ts[idx] = 0.f;
    }
  }
  load_keys(kb, vb, ks, vs, codes, 0, 0, g);
  asm volatile("cp.async.commit_group;\n" ::);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / kLanes, sub = lane % kLanes;
  const int row0 = warp * kWarpRows + grp;      // this thread's rows: row0 + 4r
  const bool active = i0 + warp * kWarpRows < g.nq1;
  float* pw = ps + warp * kTile * kPRow;
  const float4* q4 = reinterpret_cast<const float4*>(qs) + row0 * kQStep;
  const float* trow = ts + row0 * g.terms;
  const int tstep = kGroups * g.terms;          // floats between a thread's term rows

  // m: each row's reference maximum times log2 e; l: this lane's part of its sum
  float o[kRows][12], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 12; ++e) o[r][e] = 0.f;
  }

  const int tiles = (g.nk1 + kTile - 1) / kTile;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles) load_keys(kb, vb, ks, vs, codes, tile + 1, buf ^ 1, g);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile `tile` has landed
    __syncthreads();
    if (active) {
      const int j0 = tile * kTile;
      // q·kᵀ by rank-4 updates: this lane's keys are rows sub + 8u of the tile
      float s[kRows][kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int u = 0; u < kKeys; ++u) s[r][u] = 0.f;
      }
      const float4* k4 = reinterpret_cast<const float4*>(ks + buf * kTile * kStride) +
                         sub * kQStep;
#pragma unroll 4
      for (int d = 0; d < kQuads; ++d) {
        float4 kv[kKeys];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) kv[u] = k4[u * kLanes * kQStep + d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qv = q4[r * kGroups * kQStep + d];
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            s[r][u] = fmaf(qv.x, kv[u].x, s[r][u]);
            s[r][u] = fmaf(qv.y, kv[u].y, s[r][u]);
            s[r][u] = fmaf(qv.z, kv[u].z, s[r][u]);
            s[r][u] = fmaf(qv.w, kv[u].w, s[r][u]);
          }
        }
      }
      // scale, the relative terms, and -inf past the last key
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int j = j0 + sub + kLanes * u;
        const int code = codes[buf * kTile + sub + kLanes * u];
        const int at = code & 0xff, ah = code >> 8 & 0xff, aw = code >> 16 & 0xff;
        const bool spatial = code & kSpatial;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float* tr = trow + r * tstep;
          const float b = spatial ? tr[at] + tr[ah] + tr[aw] : 0.f;
          s[r][u] = j < g.nk1 ? fmaf(s[r][u], scale, b) : -INFINITY;
        }
      }
      // online softmax: m, a row's reference maximum, moves to the row's
      // maximum over the group's 32 keys (three shuffles), and o and l are
      // rescaled, only when some row of the warp has a score more than
      // 2^kSlack past it; so p stays at most 2^kSlack and mostly nothing
      // crosses lanes
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
          t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 4));
          const float m_new = fmaxf(m[r], t);
          const float alpha = m_new == m[r] ? 1.f : ex2(m[r] - m_new);  // 0 on the first tile
          m[r] = m_new;
          l[r] *= alpha;
#pragma unroll
          for (int e = 0; e < 12; ++e) o[r][e] *= alpha;
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
      // p into the warp's buffer, transposed: key row sub + 8u, this group's 8 rows
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        float4* pr = reinterpret_cast<float4*>(pw + (sub + kLanes * u) * kPRow + grp * kRows);
        pr[0] = make_float4(s[0][u], s[1][u], s[2][u], s[3][u]);
        pr[1] = make_float4(s[4][u], s[5][u], s[6][u], s[7][u]);
      }
      __syncwarp();
      // p·v: every key of the tile, this lane's 12 output dims
      const float4* p4 = reinterpret_cast<const float4*>(pw + grp * kRows);
      const float4* v4 = reinterpret_cast<const float4*>(vs + buf * kTile * kHeadDim) + sub;
#pragma unroll 4
      for (int jj = 0; jj < kTile; ++jj) {
        const float4 pa = p4[jj * (kPRow / 4)], pb = p4[jj * (kPRow / 4) + 1];
        const float4 va = v4[jj * kQuads], vb2 = v4[jj * kQuads + 8],
                     vc = v4[jj * kQuads + 16];
        const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          o[r][0] = fmaf(p[r], va.x, o[r][0]);
          o[r][1] = fmaf(p[r], va.y, o[r][1]);
          o[r][2] = fmaf(p[r], va.z, o[r][2]);
          o[r][3] = fmaf(p[r], va.w, o[r][3]);
          o[r][4] = fmaf(p[r], vb2.x, o[r][4]);
          o[r][5] = fmaf(p[r], vb2.y, o[r][5]);
          o[r][6] = fmaf(p[r], vb2.z, o[r][6]);
          o[r][7] = fmaf(p[r], vb2.w, o[r][7]);
          o[r][8] = fmaf(p[r], vc.x, o[r][8]);
          o[r][9] = fmaf(p[r], vc.y, o[r][9]);
          o[r][10] = fmaf(p[r], vc.z, o[r][10]);
          o[r][11] = fmaf(p[r], vc.w, o[r][11]);
        }
      }
      __syncwarp();  // the buffer is read before the next tile writes it
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (!active) return;

  // each row's sum over the group's lanes, then normalise, add the residual
  // (the unscaled q, from shared memory) and store
  const int clip = bh / g.heads, head = bh % g.heads;
  const int64_t width = (int64_t)g.heads * kHeadDim;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float total = l[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    total += __shfl_xor_sync(0xffffffffu, total, 4);
    const float inv = 1.0f / total;
    const int i = i0 + row0 + kGroups * r;
    if (i < g.nq1) {
      const float res = i >= 1 ? 1.f : 0.f;
      const float4* qr = q4 + r * kGroups * kQStep + sub;
      float4* dst = reinterpret_cast<float4*>(out + ((int64_t)clip * g.nq1 + i) * width +
                                              head * kHeadDim) + sub;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 qv = qr[8 * c];
        dst[8 * c] = make_float4(fmaf(o[r][4 * c], inv, res * qv.x),
                                 fmaf(o[r][4 * c + 1], inv, res * qv.y),
                                 fmaf(o[r][4 * c + 2], inv, res * qv.z),
                                 fmaf(o[r][4 * c + 3], inv, res * qv.w));
      }
    }
  }
}

}  // namespace

// q: (clips, heads, nq1, 96), k and v: (clips, heads, nk1, 96), float32,
// contiguous and 16-byte aligned; rel_t, rel_h, rel_w: (clips·heads, nq1 - 1,
// kt | kh | kw) float32, contiguous; out: (clips, nq1, heads·96). nk1 = 1 +
// kt·kh·kw, the keys in (t, h, w) order after the class token.
extern "C" int pool_attn_fwd(const void* q, const void* k, const void* v, const void* rel_t,
                             const void* rel_h, const void* rel_w, void* out, int64_t clips,
                             int heads, int nq1, int nk1, int kt, int kh, int kw, float scale,
                             cudaStream_t stream) {
  Geometry g;
  g.nq1 = nq1;
  g.nk1 = nk1;
  g.kt = kt;
  g.kh = kh;
  g.kw = kw;
  g.terms = kt + kh + kw;
  g.heads = heads;
  g.q_blocks = (nq1 + kBlockRows - 1) / kBlockRows;
  if (clips <= 0) return (int)cudaSuccess;
  if (heads <= 0 || nq1 <= 0 || kt <= 0 || kh <= 0 || kw <= 0 || g.terms > kMaxTerms ||
      (int64_t)kt * kh * kw + 1 != nk1 || clips * heads * g.q_blocks > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = smem_bytes(g.terms);
  // raised once per card and size, on the first (eager) launch of a shape: a
  // graph capture of the same shape makes no such call
  constexpr int kCards = 64;
  static size_t allowed[kCards] = {};
  int card = 0;
  cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return (int)got;
  if (card < 0 || card >= kCards) return (int)cudaErrorInvalidDevice;
  if (bytes > allowed[card]) {
    cudaError_t err = cudaFuncSetAttribute(pool_attn_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(pool_attn_fwd_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    allowed[card] = bytes;
  }
  pool_attn_fwd_kernel<<<(unsigned)(clips * heads * g.q_blocks), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(rel_t), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<float*>(out), g, scale);
  return (int)cudaGetLastError();
}
