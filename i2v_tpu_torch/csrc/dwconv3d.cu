// UniFormer's depthwise 3-D convs, forward only, for Hopper (sm_90a): over a
// token-major grid x (clips, T·H·W, C), the tokens in (T, H, W) row-major
// order and the C channels of a token contiguous, for every clip, token n and
// channel c,
//   out[n, c] = (residual ? x[n, c] : 0) + bias[c] + sum over the k³ taps of
//               w[c, tap] · x[n + tap, c]
// a depthwise conv of kernel k³ (k = 3 or 5), stride 1, zero padding k / 2,
// written in x's layout: the DPE (x + dw3(x)) of every UniFormer block, and
// the 5³ local affinity of its conv blocks.
//   - Arithmetic: products and sums in float32 on the CUDA cores (nothing on
//     the tensor cores, so PyTorch's TF32 flags do not apply), each output's
//     taps added in the conv's (t, h, w) order, then the residual and the
//     bias. A bfloat16 input (and bfloat16 weights and bias) is widened on
//     read, and the output rounded to bfloat16 once.
//
// Replaces no TPU kernel: the JAX package has no UniFormer. The plain PyTorch
// version is i2v_tpu_torch/models/uniformer.py, dwconv3d_plain (the grouped
// F.conv3d on an NCDHW view, then the residual added), the oracle on the
// card; in float32 PyTorch sends it to aten's conv_depthwise3d.
//
// What bounds it: a launch reads x once and writes out once from device
// memory, 2·C·N elements a clip, and makes 2·k³ FLOPs an output against its
// 8 bytes in float32: at k = 3 54 FLOPs, 6.75 a byte, under the card's ~20
// (bound by bytes); at k = 5 250, 31 a byte (bound by float32 arithmetic).
// port_bench/dwconv3d.py counts both the same way; over UniFormer-B's 53
// launches at 32x224^2 that is ~0.23 ms a clip at 67 TFLOP/s and 3.35 TB/s.
//
// Design:
//   - A block (8 warps) takes one clip, 32 channels (a lane a channel: each
//     staged token's 32 values are one 128-byte shared-memory row, so every
//     read is conflict-free) and a tile of the (H, W) plane, and marches over
//     all T planes. Each input plane's tile and its k - 1 halo rows and
//     columns are staged in shared memory by 16-byte cp.async loads (zeros
//     past the grid), double-buffered, so that the next plane lands while the
//     current one is computed; each plane is read from device memory once a
//     block.
//   - A lane computes a patch of 2 x 7 outputs of its channel, and holds the
//     patch for k output planes at once: input plane i adds its k² taps of
//     temporal offset dt to the output plane i + k / 2 - dt for every dt, so
//     that a staged plane is read once for all k output planes it feeds;
//     after plane i the output plane i - k / 2 is whole and stored, and the
//     k planes of accumulators shift by one. At k = 5 a lane keeps 70 sums.
//   - Within a plane, the 2 staged rows a tap row dh reads are kept in
//     registers (11 values each at k = 5) and slide down by a row at each dh;
//     each weight is read once a plane from shared memory and used for the 14
//     outputs of the patch in the output plane it feeds: with the staged
//     rows, 9 FMAs a shared read at k = 5.
//   - The tile is 2·wh x 7·ww outputs, ww = min(ceil(W / 7), 4) warps across
//     and wh = 8 / ww down: 4 x 28 at W = 56 and 28, 8 x 14 at 14, 16 x 7 at 7
//     (UniFormer-B's four grids at 224²; 56 and 28 split exactly). A patch
//     past the grid computes from staged zeros and stores nothing; a warp
//     whose patch lies wholly past it only stages.
//   - Shared memory a block: the weights transposed to (tap, channel), then
//     the two staged planes, 80 KB in float32 at k = 5 and W = 56: two
//     blocks an SM.
//
// The kernel's name is dwconv3d_kernel: the benchmark's metrics of it find it
// by that name.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                // channels a block, one a lane
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kPh = 2;                    // a lane's patch: rows
constexpr int kPw = 7;                    // and columns of one output plane
constexpr int kMaxWarpsW = 4;
constexpr int kCards = 64;

struct Args {
  const void* x;
  const void* weight;         // (C, k³), x's type
  const void* bias;           // (C,), x's type
  void* out;
  int t, h, w, c;
  int residual;
  int wh, ww;                 // warps down and across a tile
  int tiles_h, tiles_w, slices;
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// 16 bytes from p (16-byte aligned) into shared s, asynchronously; zeros
// where `valid` is false (nothing is read then)
__device__ __forceinline__ void copy16(void* s, const void* p, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(p), "r"(bytes));
}

// Block b: clip, channel slice, tile row, tile column, the last fastest, so
// that the blocks on the card at one time share their tiles' halo rows in L2.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2) dwconv3d_kernel(const Args a) {
  constexpr int P = K / 2;
  constexpr int kTaps = K * K * K;
  constexpr int kCols = kPw + K - 1;      // staged columns a patch row reads
  constexpr int kParts = kLanes * (int)sizeof(T) / 16;  // 16-byte parts a staged token
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // the weights, (tap, channel)
  T* stage = reinterpret_cast<T*>(ws + kTaps * kLanes);

  int64_t b = blockIdx.x;
  const int tile_w = (int)(b % a.tiles_w);
  b /= a.tiles_w;
  const int tile_h = (int)(b % a.tiles_h);
  b /= a.tiles_h;
  const int slice = (int)(b % a.slices);
  const int64_t clip = b / a.slices;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;

  const int th = a.wh * kPh, tw = a.ww * kPw;  // the tile
  const int nh = th + K - 1, nw = tw + K - 1;  // its staged rows and columns
  const int h0 = tile_h * th, w0 = tile_w * tw, c0 = slice * kLanes;
  const int ph = warp / a.ww * kPh, pw = warp % a.ww * kPw;  // the warp's patch in the tile
  const bool active = warp < a.wh * a.ww && h0 + ph < a.h && w0 + pw < a.w;
  const int64_t plane_tokens = (int64_t)a.h * a.w;
  const T* src = static_cast<const T*>(a.x) + clip * a.t * plane_tokens * a.c + c0;
  T* dst = static_cast<T*>(a.out) + clip * a.t * plane_tokens * a.c + c0 + lane;

  const T* wsrc = static_cast<const T*>(a.weight);
  for (int e = threadIdx.x; e < kTaps * kLanes; e += kThreads) {
    const int ch = e / kTaps, tap = e % kTaps;
    ws[tap * kLanes + ch] = Io<T>::get(wsrc + (int64_t)(c0 + ch) * kTaps + tap);
  }
  const float bias = Io<T>::get(static_cast<const T*>(a.bias) + c0 + lane);
  const int staged = nh * nw;

  // input plane i's tile and halo into buffer i % 2
  auto stage_plane = [&](int i) {
    T* buf = stage + (i % 2) * staged * kLanes;
    const T* plane = src + (int64_t)i * plane_tokens * a.c;
    for (int e = threadIdx.x; e < staged * kParts; e += kThreads) {
      const int pos = e / kParts, part = e % kParts;
      const int ih = h0 - P + pos / nw, iw = w0 - P + pos % nw;
      const bool inside = ih >= 0 && ih < a.h && iw >= 0 && iw < a.w;
      const T* from = inside ? plane + ((int64_t)ih * a.w + iw) * a.c : src;
      copy16(reinterpret_cast<float4*>(buf + pos * kLanes) + part,
             reinterpret_cast<const float4*>(from) + (inside ? part : 0), inside);
    }
  };

  // acc[j] holds output plane i - P + j while input plane i is added
  float acc[K][kPh][kPw];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int r = 0; r < kPh; ++r) {
#pragma unroll
      for (int q = 0; q < kPw; ++q) acc[j][r][q] = 0.f;
    }
  }

  stage_plane(0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = 0; i < a.t + P; ++i) {
    if (i + 1 < a.t) stage_plane(i + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // plane i has landed
    __syncthreads();
    if (active && i < a.t) {
      const T* pl = stage + (i % 2) * staged * kLanes + lane;
      float rows[kPh][kCols];  // staged rows ph + dh + r, slid down a row a dh
#pragma unroll
      for (int r = 0; r < kPh - 1; ++r) {
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          rows[r][q] = Io<T>::get(pl + ((ph + r) * nw + pw + q) * kLanes);
        }
      }
#pragma unroll
      for (int dh = 0; dh < K; ++dh) {
        {
          constexpr int r = kPh - 1;
          const int slot = (dh + r) % kPh;
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            rows[slot][q] = Io<T>::get(pl + ((ph + dh + r) * nw + pw + q) * kLanes);
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int o = i - P + j;  // the output plane of slot j, at dt = K - 1 - j
          if (o < 0 || o >= a.t) continue;
#pragma unroll
          for (int dw = 0; dw < K; ++dw) {
            const float wt = ws[(((K - 1 - j) * K + dh) * K + dw) * kLanes + lane];
#pragma unroll
            for (int r = 0; r < kPh; ++r) {
#pragma unroll
              for (int q = 0; q < kPw; ++q) {
                acc[j][r][q] = fmaf(wt, rows[(dh + r) % kPh][q + dw], acc[j][r][q]);
              }
            }
          }
        }
      }
      if (a.residual) {  // the centre tap's value, once, into output plane i (slot P)
#pragma unroll
        for (int r = 0; r < kPh; ++r) {
#pragma unroll
          for (int q = 0; q < kPw; ++q) {
            acc[P][r][q] += Io<T>::get(pl + ((ph + r + P) * nw + pw + q + P) * kLanes);
          }
        }
      }
    }
    const int o = i - P;  // whole after plane i: stored, and the slots shift
    if (active && o >= 0) {
#pragma unroll
      for (int r = 0; r < kPh; ++r) {
        const int oh = h0 + ph + r;
#pragma unroll
        for (int q = 0; q < kPw; ++q) {
          const int ow = w0 + pw + q;
          if (oh < a.h && ow < a.w) {
            Io<T>::put(dst + (((int64_t)o * a.h + oh) * a.w + ow) * a.c, acc[0][r][q] + bias);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
#pragma unroll
      for (int r = 0; r < kPh; ++r) {
#pragma unroll
        for (int q = 0; q < kPw; ++q) acc[j][r][q] = acc[j + 1][r][q];
      }
    }
#pragma unroll
    for (int r = 0; r < kPh; ++r) {
#pragma unroll
      for (int q = 0; q < kPw; ++q) acc[K - 1][r][q] = 0.f;
    }
    __syncthreads();  // every warp is done with buffer i % 2 before plane i + 2 fills it
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int K>
int launch_as(Args a, int64_t clips, cudaStream_t stream) {
  a.ww = ceil_div(a.w, kPw);
  a.ww = a.ww < kMaxWarpsW ? a.ww : kMaxWarpsW;
  a.wh = kWarps / a.ww;
  a.tiles_h = ceil_div(a.h, a.wh * kPh);
  a.tiles_w = ceil_div(a.w, a.ww * kPw);
  a.slices = a.c / kLanes;
  const int64_t blocks = clips * a.slices * a.tiles_h * a.tiles_w;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t staged = (size_t)(a.wh * kPh + K - 1) * (a.ww * kPw + K - 1);
  const size_t bytes = K * K * K * kLanes * sizeof(float) + 2 * staged * kLanes * sizeof(T);
  // raised to the most any launch of the instance takes (8 warps in any
  // arrangement: at most 16 x 28 staged tokens at k = 5), once per card, on
  // the first (eager) launch: a graph capture later makes no such call
  const size_t most = K * K * K * kLanes * sizeof(float) +
                      2 * (size_t)(kWarps * kPh + K - 1) * (kMaxWarpsW * kPw + K - 1) * kLanes *
                          sizeof(T);
  static bool raised[kCards] = {};
  int card = 0;
  cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return (int)got;
  if (card < 0 || card >= kCards) return (int)cudaErrorInvalidDevice;
  if (!raised[card]) {
    cudaError_t err = cudaFuncSetAttribute(dwconv3d_kernel<T, K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dwconv3d_kernel<T, K>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    raised[card] = true;
  }
  dwconv3d_kernel<T, K><<<(unsigned)blocks, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (clips, t·h·w, c) contiguous and 16-byte aligned, float32 (dtype 0)
// or bfloat16 (dtype 1), c a multiple of 32; weight: (c, 1, k, k, k) and bias
// (c,) in x's type; k 3 or 5; residual 0 or 1. out must not overlap x.
extern "C" int dwconv3d_fwd(const void* x, const void* weight, const void* bias, void* out,
                            int64_t clips, int t, int h, int w, int c, int k, int residual,
                            int dtype, cudaStream_t stream) {
  if (clips <= 0) return (int)cudaSuccess;
  if (t <= 0 || h <= 0 || w <= 0 || c <= 0 || c % kLanes != 0 || (k != 3 && k != 5) ||
      dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x;
  a.weight = weight;
  a.bias = bias;
  a.out = out;
  a.t = t;
  a.h = h;
  a.w = w;
  a.c = c;
  a.residual = residual != 0;
  if (dtype == 0) {
    return k == 3 ? launch_as<float, 3>(a, clips, stream) : launch_as<float, 5>(a, clips, stream);
  }
  return k == 3 ? launch_as<__nv_bfloat16, 3>(a, clips, stream)
                : launch_as<__nv_bfloat16, 5>(a, clips, stream);
}
