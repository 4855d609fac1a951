// The epilogue of a biased convolution, in place on its output y (N, C, ...):
//   y = act(y + bias[c] (+ r))       act: ReLU or the identity; r: optional
// as one elementwise kernel for Hopper (sm_90a). The surrogates' convs run in
// cuDNN without their bias, and this pass adds the bias, the ResNet residual
// and the ReLU that follows, where PyTorch would run three or four passes:
// cuDNN's output.add_(bias), the residual add and clamp_min.
//
// Replaces no TPU kernel: XLA fuses this epilogue into the convolution on
// the TPU, so the JAX package never wrote one. The eager port ran it as
// separate passes through device memory.
//
// What bounds it: memory. Each element costs one or two adds and a compare,
// against 8 bytes moved in float32 (read y, write y) or 12 with a residual
// (read y and r, write y); half of that in bfloat16. At VGG-16's conv1_2 over
// 256 frames (256, 64, 224, 224) that is 6.6 GB, 1.96 ms at 3.35 TB/s.
//
// What the design does about it:
//   - One pass, in place: the output is the conv's own buffer, so nothing is
//     allocated and no second copy of the activation is held.
//   - The grid is (planes, chunks of a plane): block (p, k) walks chunk k of
//     plane p = n*C + c. Its bias is read once, into a register, and its
//     channel is one modulo per block: no per-element division.
//   - 16-byte accesses (4 floats or 8 bfloat16s) where a plane holds a whole
//     number of them and every pointer is 16-byte aligned, which holds for
//     224^2, 112^2, 56^2 and 28^2; 2- or 4-byte accesses otherwise (111^2,
//     55^2, 27^2, 13^2), still coalesced: neighbouring threads take
//     neighbouring elements of one plane.
//   - Each thread issues all of its loads (up to kUnroll = 8 accesses of y
//     and of r, 128 bytes each) before its first store, so that enough bytes
//     are in flight, and makes up to kTrips = 2 such trips.
//   - The block is sized to the plane (32 to 512 threads) and a plane is cut
//     into as many chunks as fill the blocks, so that small planes (13^2 and
//     28^2) run many small blocks and large ones (224^2) full ones: 16K to
//     131K blocks a launch for the surrogates at 256 frames, over 132 SMs.
//   - Chosen on an H100 80GB HBM3 (700 W) among 128, 256 and 512 threads, 4
//     and 8 accesses in flight, 1 and 2 trips and streaming cache hints, as
//     the share of the byte bound at VGG-16's conv1_2 over 256 frames: 82.7%
//     with 256 threads, 4 accesses and 1 trip, 88.7% as set here; the
//     streaming hints (ld/st.global.cs) gained nothing.
//
// Exactness: bit for bit torch.relu(F.conv2d(x, w, b) + r) on the card, which
// runs cuDNN's convolution, output.add_(bias), the add and clamp_min.
//   - float32: __fadd_rn for each add (nothing multiplies, so no FMA
//     contraction can change a bit), then clamp_min's own rule: a NaN is
//     returned as it is, else fmaxf(v, 0).
//   - bfloat16: each add in float on the bfloat16 values, rounded back to
//     bfloat16 after each add (__float2bfloat16_rn, the conversion c10's
//     BFloat16 uses on sm_80 and later), as add_ on bfloat16 tensors does;
//     then the same ReLU, in float, on the rounded value.
//   - The plain PyTorch version (i2v_tpu_torch/ops/pixel.py, bias_act) is the
//     oracle on the card.
//
// The kernel's name is bias_act_kernel: a profiler classes kernels by their
// names, and this one must not read as a convolution or a PyTorch
// elementwise kernel.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 32;
constexpr int kUnroll = 8;          // accesses a thread keeps in flight
constexpr int kTrips = 2;           // trips through its loop a thread is sized for
constexpr int64_t kMaxChunks = 65535;  // gridDim.y's limit

__device__ __forceinline__ float relu_like_clamp_min(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

template <bool kRes, bool kRelu>
__device__ __forceinline__ float epilogue(float y, float b, float r) {
  float v = __fadd_rn(y, b);
  if (kRes) v = __fadd_rn(v, r);
  if (kRelu) v = relu_like_clamp_min(v);
  return v;
}

template <bool kRes, bool kRelu>
__device__ __forceinline__ __nv_bfloat16 epilogue(__nv_bfloat16 y, float b, __nv_bfloat16 r) {
  __nv_bfloat16 v = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
  if (kRes) v = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), __bfloat162float(r)));
  if (kRelu) {
    const float f = __bfloat162float(v);
    if (!isnan(f)) v = __float2bfloat16_rn(fmaxf(f, 0.0f));
  }
  return v;
}

// One access: a single element (A = T) or 16 bytes of them (A = uint4).
template <typename T, typename A, bool kRes, bool kRelu>
__device__ __forceinline__ A apply(A y, float b, A r) {
  constexpr int kPer = sizeof(A) / sizeof(T);
  T* ye = reinterpret_cast<T*>(&y);
  const T* re = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < kPer; ++k) ye[k] = epilogue<kRes, kRelu>(ye[k], b, re[k]);
  return y;
}

template <typename T>
__device__ __forceinline__ float to_float(T b);
template <>
__device__ __forceinline__ float to_float<float>(float b) { return b; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 b) {
  return __bfloat162float(b);
}

// Block (p, k): chunk k of plane p. plane_len and chunk_len count accesses.
template <typename T, typename A, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
bias_act_kernel(A* y, const A* __restrict__ r, const T* __restrict__ bias,
                int64_t plane_len, int channels, int64_t chunk_len) {
  const int64_t plane = blockIdx.x;
  const float b = to_float<T>(bias[plane % channels]);
  const int64_t begin = (int64_t)blockIdx.y * chunk_len;
  const int64_t end = begin + chunk_len < plane_len ? begin + chunk_len : plane_len;
  A* yp = y + plane * plane_len;
  const A* rp = kRes ? r + plane * plane_len : nullptr;
  const int64_t step = blockDim.x;
  for (int64_t i = begin + threadIdx.x; i < end; i += step * kUnroll) {
    A v[kUnroll];
    A rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * step;
      if (j < end) {
        v[u] = yp[j];
        if (kRes) rv[u] = __ldg(rp + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * step;
      if (j < end) yp[j] = apply<T, A, kRes, kRelu>(v[u], b, kRes ? rv[u] : v[u]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename A, bool kRes, bool kRelu>
int launch_as(void* y, const void* bias, const void* r, int64_t planes, int64_t plane_len,
              int channels, cudaStream_t stream) {
  const int64_t per_thread = (plane_len + kUnroll - 1) / kUnroll;
  int64_t threads = (per_thread + 31) / 32 * 32;
  threads = threads < kMinThreads ? kMinThreads : threads > kMaxThreads ? kMaxThreads : threads;
  const int64_t per_block = threads * kUnroll * kTrips;
  int64_t chunks = (plane_len + per_block - 1) / per_block;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  const int64_t chunk_len = (plane_len + chunks - 1) / chunks;
  const dim3 grid((unsigned)planes, (unsigned)chunks);
  bias_act_kernel<T, A, kRes, kRelu><<<grid, (unsigned)threads, 0, stream>>>(
      static_cast<A*>(y), static_cast<const A*>(r), static_cast<const T*>(bias), plane_len,
      channels, chunk_len);
  return (int)cudaGetLastError();
}

template <typename T, typename A>
int launch_flags(void* y, const void* bias, const void* r, int64_t planes, int64_t plane_len,
                 int channels, int relu, cudaStream_t stream) {
  if (r != nullptr) {
    return relu ? launch_as<T, A, true, true>(y, bias, r, planes, plane_len, channels, stream)
                : launch_as<T, A, true, false>(y, bias, r, planes, plane_len, channels, stream);
  }
  return relu ? launch_as<T, A, false, true>(y, bias, r, planes, plane_len, channels, stream)
              : launch_as<T, A, false, false>(y, bias, r, planes, plane_len, channels, stream);
}

template <typename T>
int launch_typed(void* y, const void* bias, const void* r, int64_t planes, int64_t plane_elems,
                 int channels, int relu, cudaStream_t stream) {
  constexpr int64_t kPer = 16 / sizeof(T);
  const bool vec = plane_elems % kPer == 0 && aligned16(y) && (r == nullptr || aligned16(r));
  if (vec) {
    return launch_flags<T, uint4>(y, bias, r, planes, plane_elems / kPer, channels, relu,
                                  stream);
  }
  return launch_flags<T, T>(y, bias, r, planes, plane_elems, channels, relu, stream);
}

}  // namespace

// y: (planes / channels, channels, plane_elems) contiguous, in place; bias:
// (channels,); residual: y's shape, or null. dtype 0 is float32, 1 bfloat16.
// planes must be at most 2^31 - 1 (gridDim.x).
extern "C" int bias_act(void* y, const void* bias, const void* residual, int64_t planes,
                        int64_t plane_elems, int channels, int dtype, int relu,
                        cudaStream_t stream) {
  if (planes <= 0 || plane_elems <= 0) return (int)cudaSuccess;
  if (planes > 2147483647LL || channels <= 0 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch_typed<float>(y, bias, residual, planes, plane_elems, channels, relu, stream);
  }
  return launch_typed<__nv_bfloat16>(y, bias, residual, planes, plane_elems, channels, relu,
                                     stream);
}
