// The differentiable modifier rebuild of the Adam-based image-guided attacks,
//   out = clamp(clean + clamp(m, -eps, eps), 0, 1)                  (forward)
//   dm  = g * [-eps <= m <= eps] * [0 <= clean + clamp(m) <= 1]     (backward)
// as two elementwise kernels for Hopper (sm_90a).
//
// Replaces the Pallas pair in i2v_tpu/ops/pallas_kernels.py:
//   _rebuild_fwd_kernel (forward) and _rebuild_bwd_kernel (its custom VJP).
//
// What bounds it: memory. Each element costs a handful of compares and one
// add, against 12 bytes moved by the forward (read clean and m, write out)
// and 16 by the backward (read clean, m, g; write dm). At one 32-frame 224^2
// clip that is 3 x 19.3 MB and 4 x 19.3 MB of device-memory traffic.
//
// What the design does about it: one pass over a flat element count, with a
// grid-stride loop, float4 (16-byte) loads and stores when every pointer is
// 16-byte aligned, and a masked scalar tail so that any size is taken. There
// is no tiling and no shared memory: nothing is reused. The TPU kernel's
// (rows, 128) tiling is not carried over.
//
// Exactness: the plain PyTorch version (i2v_tpu_torch/ops/pixel.py) is the
// oracle, bit for bit. eps arrives as the float32 value the plain version
// compares against; the clamps are compares and selects, so a NaN passes
// through as torch.clamp passes it (fminf/fmaxf would drop it); the gradient
// masks are closed intervals, as torch.clamp's backward is. Nothing here
// multiplies, so no FMA contraction can change a bit.
//
// Interface: plain C, loaded with ctypes. Each function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Blocks per SM for the grid-stride loop: enough resident warps to keep the
// memory system busy, few enough that each thread walks several elements.
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  v = v < lo ? lo : v;  // NaN compares false: it is kept
  return v > hi ? hi : v;
}

__device__ __forceinline__ float rebuild_one(float c, float m, float eps) {
  return clamp_keep_nan(c + clamp_keep_nan(m, -eps, eps), 0.0f, 1.0f);
}

__device__ __forceinline__ float rebuild_grad_one(float c, float m, float g, float eps) {
  const float u = c + clamp_keep_nan(m, -eps, eps);
  const bool pass = (m >= -eps) && (m <= eps) && (u >= 0.0f) && (u <= 1.0f);
  return pass ? g : 0.0f;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rebuild_fwd_kernel(const float* __restrict__ clean, const float* __restrict__ mod,
                   float* __restrict__ out, int64_t n, float eps) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* c4 = reinterpret_cast<const float4*>(clean);
    const float4* m4 = reinterpret_cast<const float4*>(mod);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 c = c4[i];
      const float4 m = m4[i];
      float4 r;
      r.x = rebuild_one(c.x, m.x, eps);
      r.y = rebuild_one(c.y, m.y, eps);
      r.z = rebuild_one(c.z, m.z, eps);
      r.w = rebuild_one(c.w, m.w, eps);
      o4[i] = r;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    out[i] = rebuild_one(clean[i], mod[i], eps);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rebuild_bwd_kernel(const float* __restrict__ clean, const float* __restrict__ mod,
                   const float* __restrict__ g, float* __restrict__ dmod, int64_t n,
                   float eps) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* c4 = reinterpret_cast<const float4*>(clean);
    const float4* m4 = reinterpret_cast<const float4*>(mod);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* d4 = reinterpret_cast<float4*>(dmod);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 c = c4[i];
      const float4 m = m4[i];
      const float4 gg = g4[i];
      float4 r;
      r.x = rebuild_grad_one(c.x, m.x, gg.x, eps);
      r.y = rebuild_grad_one(c.y, m.y, gg.y, eps);
      r.z = rebuild_grad_one(c.z, m.z, gg.z, eps);
      r.w = rebuild_grad_one(c.w, m.w, gg.w, eps);
      d4[i] = r;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    dmod[i] = rebuild_grad_one(clean[i], mod[i], g[i], eps);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int grid_for(int64_t work_items) {
  int device = 0;
  int sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return -1;
  }
  const int64_t want = (work_items + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  return (int)(want < cap ? want : cap);
}

}  // namespace

extern "C" int rebuild_adv_fwd(const float* clean, const float* mod, float* out,
                               int64_t n, float eps, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = aligned16(clean) && aligned16(mod) && aligned16(out);
  const int grid = grid_for(vec ? (n + 3) / 4 : n);
  if (grid < 0) return (int)cudaGetLastError();
  if (vec) {
    rebuild_fwd_kernel<true><<<grid, kThreads, 0, stream>>>(clean, mod, out, n, eps);
  } else {
    rebuild_fwd_kernel<false><<<grid, kThreads, 0, stream>>>(clean, mod, out, n, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int rebuild_adv_bwd(const float* clean, const float* mod, const float* g,
                               float* dmod, int64_t n, float eps, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = aligned16(clean) && aligned16(mod) && aligned16(g) && aligned16(dmod);
  const int grid = grid_for(vec ? (n + 3) / 4 : n);
  if (grid < 0) return (int)cudaGetLastError();
  if (vec) {
    rebuild_bwd_kernel<true><<<grid, kThreads, 0, stream>>>(clean, mod, g, dmod, n, eps);
  } else {
    rebuild_bwd_kernel<false><<<grid, kThreads, 0, stream>>>(clean, mod, g, dmod, n, eps);
  }
  return (int)cudaGetLastError();
}
