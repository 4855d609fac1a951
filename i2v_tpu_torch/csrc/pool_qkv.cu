// MViTv2's q, k and v pooling, forward only, for Hopper (sm_90a): from the
// qkv Linear's output as it lies, (clips, 1 + T·H·W, 3, heads, 96) with row 0
// the class token, for each of q, k and v and every clip and head,
//   out[0]      = LN(x[0])                              (the class token, unpooled)
//   out[1 + n'] = LN(sum over the 27 taps of w[c, tap] · x[n'·s + tap - 1])
// a depthwise 3³ conv with zero padding 1 at the tensor's stride s (stride_q
// for q, stride_kv for k and v), then its LayerNorm over the 96 channels
// (float32 weight and bias, mean and variance in two passes), written as
// (clips, heads, 1 + N', 96) float32, the layout the relative terms and the
// pooling-attention kernel read. One launch does all three tensors.
//   - Arithmetic: products and sums in float32 on the CUDA cores (nothing on
//     the tensor cores, so PyTorch's TF32 flags do not apply), each output's
//     taps added in the conv's (t, h, w) order. A bfloat16 input (and
//     bfloat16 weights) is widened on read, and the pooled value is rounded
//     to bfloat16 before the norm, as the bfloat16 conv rounds its output.
//
// Replaces no TPU kernel: the JAX package has no MViT. The plain PyTorch
// version is i2v_tpu_torch/models/mvit.py, pool_qkv_plain (three
// attention_pool calls: a strided slice copied to NCDHW, aten's depthwise
// conv, the class token joined back by cat, a LayerNorm), the oracle on the
// card; it passes the pooled tensors through device memory four times.
//
// What bounds it: device-memory bytes. Each input row a tap touches is read
// once and each output row written once: at MViTv2-B's 32x224^2 about 720 MB
// a clip over the 24 blocks (0.215 ms at 3.35 TB/s); 2 x 27 FLOPs an output
// channel is ~1.3 FLOPs a byte.
//
// Design:
//   - A block (8 warps) takes one tensor of one (clip, head) and a tile of
//     its pooled grid: up to 16 output planes, and (th, tw) outputs of each.
//     It marches over the planes: the input rows that the tile's taps touch
//     in one input plane are staged in shared memory with 16-byte cp.async
//     loads, in a ring of 3 + min(st, 3) planes, so that the next plane's
//     rows land while the current one is computed and each staged plane is
//     read from device memory once however many outputs read it. Each
//     staged row's token within a plane is computed once a block.
//   - The stride sets the staging: along an axis of stride s the tile stages
//     (t - 1)·min(s, 3) + 3 rows, output o reading rows o·min(s, 3) + d for
//     its taps d = 0, 1, 2. At stride 1 that is the halo'd tile (each row
//     feeds up to 27 outputs); at stride 2 neighbours share one row; at a
//     stride of 3 or more (k and v at (1,8,8)) only the rows the taps hit are
//     staged, no row between them. At most 64 rows a plane (256 over the ring).
//   - A warp computes a run of 4, 2 or 1 neighbouring outputs along W
//     (stride 1, 2, 3+) over a token's 96 channels, 3 a lane (lane, lane + 32,
//     lane + 64: conflict-free shared reads), each staged value read once for
//     every output of the run that takes it. The tile's columns are staged
//     up to whole runs, so a run reads no guard; what it computes past the
//     tile is never stored.
//   - The norm: the warp's 96 channels are reduced by shuffles (mean, then
//     the squared deviations), so the pooled value never goes back to device
//     memory before the norm; each output row is stored as 3 coalesced
//     128-byte writes.
//   - Shared memory a block: the weights transposed to (tap, channel), the
//     norm's weight and bias, the staged rows' tokens (11,392 bytes), then
//     the ring (up to 98,304 bytes in float32): two blocks an SM at 116
//     registers a thread. Weights held in registers instead (81 a lane) cost
//     spills at two blocks an SM and ran 8% slower; a deeper ring or smaller
//     tiles for more blocks an SM ran slower still (PERF.md §6).
//
// The kernel's name is pool_qkv_kernel: the benchmark's metric of it finds it
// by that name, which holds neither "conv" nor the pooling-attention kernel's
// name, so that no other reader counts it.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 96;
constexpr int kPerLane = kHeadDim / 32;   // channels a lane: lane, lane + 32, lane + 64
constexpr int kTaps = 27;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRingRows = 256;            // staged rows a block, over its ring of planes
constexpr int kMaxPlanes = 16;            // output planes a block marches over
constexpr int kPlaneRows = kRingRows / 4;  // staged rows a plane, at most (a ring of 4)
constexpr int kCards = 64;

struct Plan {                 // one of q, k and v
  int st, sh, sw;             // its stride
  int ct, ch, cw;             // staged rows an output steps over: min(stride, 3)
  int ot, oh, ow;             // the pooled grid
  int tt, th, tw;             // a block's tile of it: planes, rows, columns
  int pw;                     // tw rounded up to whole runs (Run)
  int nh, nw;                 // a staged plane's rows and columns
  int ring;                   // staged planes a block: 3 + ct
  int chunks, tiles_h, tiles_w;
  int64_t blocks;             // clips · heads · chunks · tiles_h · tiles_w
};

struct Args {
  const void* qkv;
  const void* weight[3];      // (96, 27) each, the input's type
  const float* gamma[3];
  const float* beta[3];
  float* out[3];
  Plan plan[3];
  int t, h, w;                // the input grid
  int heads;
  float eps;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kParts = kHeadDim * 4 / 16;  // 16-byte parts a row
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kParts = kHeadDim * 2 / 16;
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// outputs a warp's task computes along W at a staging step of kCw
template <int kCw>
struct Run {
  static constexpr int value = kCw == 1 ? 4 : kCw == 2 ? 2 : 1;
};

// 16 bytes from p (16-byte aligned) into shared s, asynchronously
__device__ __forceinline__ void copy16(void* s, const void* p) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(p));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// The input index that staged row k of an axis holds, for a tile of `tile`
// outputs from o0 at stride s, c = min(s, 3): output o's taps d = 0, 1, 2
// read staged row o·c + d, which holds input o·s - 1 + d.
__device__ __forceinline__ int slot_input(int k, int o0, int tile, int s, int c) {
  const int o = min(k / c, tile - 1);
  return (o0 + o) * s - 1 + (k - o * c);
}

// LayerNorm over one token's 96 channels, 3 a lane, stored at dst; gamma and
// beta in shared memory
__device__ __forceinline__ void norm_store(const float (&v)[kPerLane], const float* gamma,
                                           const float* beta, float eps, float* dst,
                                           int lane) {
  const float mean = warp_sum(v[0] + v[1] + v[2]) * (1.0f / kHeadDim);
  float d[kPerLane], sq = 0.f;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    d[c] = v[c] - mean;
    sq = fmaf(d[c], d[c], sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) * (1.0f / kHeadDim) + eps);
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int ch = lane + 32 * c;
    dst[ch] = fmaf(d[c] * rstd, gamma[ch], beta[ch]);
  }
}

// One input plane into a ring position: the tile's staged rows, nh x nw of
// them, 16 bytes a thread at a time; `plane` is the plane's first grid token
// (nullptr: a plane outside the grid), `rows_at` each staged row's token in
// its plane (-1: outside the grid).
template <typename T>
__device__ __forceinline__ void stage_plane(T* dst, const T* plane, const int* rows_at, int rows,
                                            int64_t row_stride) {
  for (int e = threadIdx.x; e < rows * Io<T>::kParts; e += kThreads) {
    const int r = e / Io<T>::kParts, part = e % Io<T>::kParts;
    const int at = rows_at[r];
    float4* d = reinterpret_cast<float4*>(dst + r * kHeadDim) + part;
    if (plane != nullptr && at >= 0) {
      copy16(d, reinterpret_cast<const float4*>(plane + at * row_stride) + part);
    } else {
      *d = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// One output plane of the tile from its three staged planes (ring positions
// pos): a warp a run of outputs along W at a time, pooled, normalised,
// stored. A run past the tile's last column computes from staged padding
// and stores nothing there.
template <typename T, int kCw>
__device__ __forceinline__ void pool_plane(const T* stage, const int (&pos)[3], float* out_plane,
                                           int eh, int ew, const Plan& p, const float* w,
                                           const float* gamma, const float* beta, float eps,
                                           int lane, int warp) {
  constexpr int kRun = Run<kCw>::value;
  constexpr int kCols = (kRun - 1) * kCw + 3;  // staged columns a run reads
  const int runs = p.pw / kRun;
  const int rows = p.nh * p.nw;
  for (int task = warp; task < p.th * runs; task += kWarps) {
    const int oh = task / runs, ow = task % runs * kRun;
    if (oh >= eh || ow >= ew) continue;
    float acc[kRun][kPerLane];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) acc[r][c] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const T* row = stage + (pos[dt] * rows + (oh * p.ch + dh) * p.nw + ow * kCw) * kHeadDim +
                       lane;
#pragma unroll
        for (int col = 0; col < kCols; ++col) {
          float x[kPerLane];
#pragma unroll
          for (int c = 0; c < kPerLane; ++c) x[c] = Io<T>::get(row + col * kHeadDim + 32 * c);
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            if (col >= dw && (col - dw) % kCw == 0 && (col - dw) / kCw < kRun) {
              const int r = (col - dw) / kCw;
#pragma unroll
              for (int c = 0; c < kPerLane; ++c) {
                const float wt = w[((dt * 3 + dh) * 3 + dw) * kHeadDim + lane + 32 * c];
                acc[r][c] = fmaf(wt, x[c], acc[r][c]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (ow + r < ew) {
        float v[kPerLane];
#pragma unroll
        for (int c = 0; c < kPerLane; ++c) v[c] = Io<T>::round(acc[r][c]);
        norm_store(v, gamma, beta, eps, out_plane + ((int64_t)oh * p.ow + ow + r) * kHeadDim,
                   lane);
      }
    }
  }
}

// Block b: tensor j (q's blocks, then k's, then v's), then (clip, head),
// planes chunk, tile row and tile column, the last fastest, so that the
// blocks on the card at one time share their tiles' edge rows in L2.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) pool_qkv_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // the weights, (tap, channel)
  float* gs = ws + kTaps * kHeadDim;            // the norm's weight
  float* bs = gs + kHeadDim;                    // and bias
  int* rows_at = reinterpret_cast<int*>(bs + kHeadDim);
  T* stage = reinterpret_cast<T*>(rows_at + kPlaneRows);

  int64_t b = blockIdx.x;
  int j = 0;
  if (b >= a.plan[0].blocks) {
    b -= a.plan[0].blocks;
    j = 1;
    if (b >= a.plan[1].blocks) {
      b -= a.plan[1].blocks;
      j = 2;
    }
  }
  // the tensor's plan and pointers, read at constant offsets of the parameters
  const Plan p = j == 0 ? a.plan[0] : j == 1 ? a.plan[1] : a.plan[2];
  const T* wsrc =
      static_cast<const T*>(j == 0 ? a.weight[0] : j == 1 ? a.weight[1] : a.weight[2]);
  const float* gamma = j == 0 ? a.gamma[0] : j == 1 ? a.gamma[1] : a.gamma[2];
  const float* beta = j == 0 ? a.beta[0] : j == 1 ? a.beta[1] : a.beta[2];
  float* out = j == 0 ? a.out[0] : j == 1 ? a.out[1] : a.out[2];
  const int tile_w = (int)(b % p.tiles_w);
  b /= p.tiles_w;
  const int tile_h = (int)(b % p.tiles_h);
  b /= p.tiles_h;
  const int chunk = (int)(b % p.chunks);
  const int64_t bh = b / p.chunks;  // clip · heads + head
  const int clip = (int)(bh / a.heads), head = (int)(bh % a.heads);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const int64_t row_stride = 3LL * a.heads * kHeadDim;
  const int64_t grid_tokens = (int64_t)a.t * a.h * a.w;
  const T* src = static_cast<const T*>(a.qkv) + clip * (1 + grid_tokens) * row_stride +
                 (int64_t)(j * a.heads + head) * kHeadDim;
  const int ot0 = chunk * p.tt, oh0 = tile_h * p.th, ow0 = tile_w * p.tw;
  const int et = min(p.tt, p.ot - ot0), eh = min(p.th, p.oh - oh0), ew = min(p.tw, p.ow - ow0);
  out += bh * (1 + (int64_t)p.ot * p.oh * p.ow) * kHeadDim;
  const int rows = p.nh * p.nw;

  // the weights transposed, the norm, and each staged row's token in its plane
  for (int e = threadIdx.x; e < kTaps * kHeadDim; e += kThreads) {
    ws[e % kTaps * kHeadDim + e / kTaps] = Io<T>::get(wsrc + e);
  }
  if (threadIdx.x < kHeadDim) {
    gs[threadIdx.x] = gamma[threadIdx.x];
    bs[threadIdx.x] = beta[threadIdx.x];
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int ih = slot_input(r / p.nw, oh0, p.th, p.sh, p.ch);
    const int iw = slot_input(r % p.nw, ow0, p.pw, p.sw, p.cw);
    rows_at[r] = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w ? ih * a.w + iw : -1;
  }
  __syncthreads();

  // staged plane k of the block (its input plane by slot_input) into ring position k % ring
  auto stage_slot = [&](int k) {
    const int it = slot_input(k, ot0, p.tt, p.st, p.ct);
    const T* plane = it >= 0 && it < a.t ? src + (1 + (int64_t)it * a.h * a.w) * row_stride
                                         : nullptr;
    stage_plane<T>(stage + (k % p.ring) * rows * kHeadDim, plane, rows_at, rows, row_stride);
  };
  // the first output plane's three staged planes
  for (int k = 0; k < 3; ++k) stage_slot(k);
  asm volatile("cp.async.commit_group;\n" ::);

  // the class token, unpooled, by the last warp of the (clip, head)'s first block
  if (chunk == 0 && tile_h == 0 && tile_w == 0 && warp == kWarps - 1) {
    float v[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) v[c] = Io<T>::get(src + lane + 32 * c);
    norm_store(v, gs, bs, a.eps, out, lane);
  }

  for (int ot = 0; ot < et; ++ot) {
    __syncthreads();  // every warp is done with the plane before its ring position is refilled
    if (ot + 1 < et) {  // the next plane's new staged planes
      for (int k = ot * p.ct + 3; k < (ot + 1) * p.ct + 3; ++k) stage_slot(k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // plane ot's rows have landed
    __syncthreads();
    const int pos[3] = {(ot * p.ct) % p.ring, (ot * p.ct + 1) % p.ring,
                        (ot * p.ct + 2) % p.ring};
    float* out_plane = out + (1 + ((int64_t)(ot0 + ot) * p.oh + oh0) * p.ow + ow0) * kHeadDim;
    if (p.cw == 1) {
      pool_plane<T, 1>(stage, pos, out_plane, eh, ew, p, ws, gs, bs, a.eps, lane, warp);
    } else if (p.cw == 2) {
      pool_plane<T, 2>(stage, pos, out_plane, eh, ew, p, ws, gs, bs, a.eps, lane, warp);
    } else {
      pool_plane<T, 3>(stage, pos, out_plane, eh, ew, p, ws, gs, bs, a.eps, lane, warp);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tile of one tensor: columns up to 8, 4 or 7 outputs at staging steps
// 1, 2 and 3, rounded up to whole runs (and staging at most a third of a
// plane's rows), as many rows as the plane's share of the ring holds, both
// balanced over the grid; planes up to kMaxPlanes a block.
Plan make_plan(int t, int h, int w, int st, int sh, int sw, int64_t clips, int heads) {
  Plan p;
  p.st = st;
  p.sh = sh;
  p.sw = sw;
  p.ct = st < 3 ? st : 3;
  p.ch = sh < 3 ? sh : 3;
  p.cw = sw < 3 ? sw : 3;
  p.ot = (t - 1) / st + 1;
  p.oh = (h - 1) / sh + 1;
  p.ow = (w - 1) / sw + 1;
  p.ring = 3 + p.ct;
  const int cap = kRingRows / p.ring;
  const int run = p.cw == 1 ? Run<1>::value : p.cw == 2 ? Run<2>::value : Run<3>::value;
  const auto columns = [&](int tw) { return (ceil_div(tw, run) * run - 1) * p.cw + 3; };
  int tw = p.cw == 1 ? 8 : p.cw == 2 ? 4 : 7;
  tw = tw < p.ow ? tw : p.ow;
  while (tw > 1 && 3 * columns(tw) > cap) --tw;
  p.tiles_w = ceil_div(p.ow, tw);
  p.tw = ceil_div(p.ow, p.tiles_w);
  p.pw = ceil_div(p.tw, run) * run;
  p.nw = columns(p.tw);
  int th = (cap / p.nw - 3) / p.ch + 1;
  th = th < p.oh ? th : p.oh;
  p.tiles_h = ceil_div(p.oh, th);
  p.th = ceil_div(p.oh, p.tiles_h);
  p.nh = (p.th - 1) * p.ch + 3;
  p.chunks = ceil_div(p.ot, kMaxPlanes);
  p.tt = ceil_div(p.ot, p.chunks);
  p.blocks = clips * heads * p.chunks * p.tiles_h * p.tiles_w;
  return p;
}

template <typename T>
int launch_as(const Args& a, cudaStream_t stream) {
  int rows = 0;
  for (int j = 0; j < 3; ++j) {
    const int r = a.plan[j].ring * a.plan[j].nh * a.plan[j].nw;
    rows = r > rows ? r : rows;
  }
  // the weights, the norm and the rows' tokens, then the ring
  const size_t fixed = (kTaps + 2) * kHeadDim * sizeof(float) + kPlaneRows * sizeof(int);
  const size_t bytes = fixed + (size_t)rows * kHeadDim * sizeof(T);
  const size_t most = fixed + (size_t)kRingRows * kHeadDim * sizeof(float);
  // raised to the most any launch takes, once per card and type, on the
  // first (eager) launch: a graph capture later makes no such call
  static bool raised[kCards] = {};
  int card = 0;
  cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return (int)got;
  if (card < 0 || card >= kCards) return (int)cudaErrorInvalidDevice;
  if (!raised[card]) {
    cudaError_t err = cudaFuncSetAttribute(pool_qkv_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)most);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(pool_qkv_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    raised[card] = true;
  }
  const int64_t blocks = a.plan[0].blocks + a.plan[1].blocks + a.plan[2].blocks;
  pool_qkv_kernel<T><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (clips, 1 + t·h·w, 3, heads, 96) contiguous and 16-byte aligned,
// float32 (dtype 0) or bfloat16 (dtype 1); wq, wk, wv: (96, 1, 3, 3, 3) in
// qkv's type; gq, bq, gk, bk, gv, bv: (96,) float32, each norm's weight and
// bias; oq: (clips, heads, 1 + Nq, 96), ok and ov (clips, heads, 1 + Nk, 96)
// float32, the grids (n - 1) / s + 1 an axis at stride (sqt, sqh, sqw) for q
// and (skt, skh, skw) for k and v.
extern "C" int pool_qkv_fwd(const void* qkv, const void* wq, const void* wk, const void* wv,
                            const void* gq, const void* bq, const void* gk, const void* bk,
                            const void* gv, const void* bv, void* oq, void* ok, void* ov,
                            int64_t clips, int heads, int t, int h, int w, int sqt, int sqh,
                            int sqw, int skt, int skh, int skw, float eps, int dtype,
                            cudaStream_t stream) {
  if (clips <= 0) return (int)cudaSuccess;
  if (heads <= 0 || t <= 0 || h <= 0 || w <= 0 || sqt <= 0 || sqh <= 0 || sqw <= 0 ||
      skt <= 0 || skh <= 0 || skw <= 0 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.qkv = qkv;
  a.weight[0] = wq;
  a.weight[1] = wk;
  a.weight[2] = wv;
  a.gamma[0] = static_cast<const float*>(gq);
  a.gamma[1] = static_cast<const float*>(gk);
  a.gamma[2] = static_cast<const float*>(gv);
  a.beta[0] = static_cast<const float*>(bq);
  a.beta[1] = static_cast<const float*>(bk);
  a.beta[2] = static_cast<const float*>(bv);
  a.out[0] = static_cast<float*>(oq);
  a.out[1] = static_cast<float*>(ok);
  a.out[2] = static_cast<float*>(ov);
  a.plan[0] = make_plan(t, h, w, sqt, sqh, sqw, clips, heads);
  a.plan[1] = make_plan(t, h, w, skt, skh, skw, clips, heads);
  a.plan[2] = a.plan[1];
  a.t = t;
  a.h = h;
  a.w = w;
  a.heads = heads;
  a.eps = eps;
  if (a.plan[0].blocks + a.plan[1].blocks + a.plan[2].blocks > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  return dtype == 0 ? launch_as<float>(a, stream) : launch_as<__nv_bfloat16>(a, stream);
}
