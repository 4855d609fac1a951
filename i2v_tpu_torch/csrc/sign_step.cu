// The per-step pixel update of every iterative white-box sign attack,
//   out = clamp(clean + clamp(adv + alpha * sign(g) - clean, -eps, eps), 0, 1)
// as one elementwise kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel _sign_step_kernel in i2v_tpu/ops/pallas_kernels.py
// (reached through _sign_step_pallas and sign_step_project, and called once a
// step by the sign-attack engine, i2v_tpu/attacks/core.py:run_sign_attack).
//
// What bounds it: memory. Each element costs a few compares, one multiply and
// three adds, against 16 bytes moved (read adv, g, clean; write out). At one
// 32-frame 224^2 clip that is 4 x 19.3 MB of device-memory traffic, a floor of
// about 23 us at the datasheet's 3.35 TB/s.
//
// What the design does about it: the design of rebuild_adv.cu. One pass over
// a flat element count with a grid-stride loop, float4 (16-byte) loads and
// stores when every pointer is 16-byte aligned, and a scalar tail so that any
// size is taken. Nothing is reused, so there is no tiling and no shared
// memory; the TPU kernel's (rows, 128) blocks are not carried over.
//
// Exactness: the plain PyTorch version (i2v_tpu_torch/ops/pixel.py,
// sign_step_project) is the oracle, bit for bit.
//   - sign(NaN) is NaN, as jnp.sign and the repaired plain version give it;
//     sign(+-0) is 0.
//   - alpha and eps arrive as the float32 values the plain version uses.
//   - alpha * s is exact for s in {-1, 0, +1}, so a contracted FMA could not
//     change a bit either; __fadd_rn(adv, __fmul_rn(alpha, s)) keeps the two
//     roundings of the plain version's mul-then-add explicit all the same.
//   - The clamps are compares and selects, so a NaN passes through as
//     torch.clamp passes it (fminf/fmaxf would drop it).
//
// Interface: plain C, loaded with ctypes. The function launches on the given
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

__device__ __forceinline__ float sign_keep_nan(float g) {
  // g != g only for NaN, which is returned as it is
  return g > 0.0f ? 1.0f : (g < 0.0f ? -1.0f : (g != g ? g : 0.0f));
}

__device__ __forceinline__ float step_one(float adv, float g, float clean, float alpha,
                                          float eps) {
  const float stepped = __fadd_rn(adv, __fmul_rn(alpha, sign_keep_nan(g)));
  const float delta = clamp_keep_nan(__fsub_rn(stepped, clean), -eps, eps);
  return clamp_keep_nan(__fadd_rn(clean, delta), 0.0f, 1.0f);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sign_step_kernel(const float* __restrict__ adv, const float* __restrict__ g,
                 const float* __restrict__ clean, float* __restrict__ out, int64_t n,
                 float alpha, float eps) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* a4 = reinterpret_cast<const float4*>(adv);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* c4 = reinterpret_cast<const float4*>(clean);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = a4[i];
      const float4 gg = g4[i];
      const float4 c = c4[i];
      float4 r;
      r.x = step_one(a.x, gg.x, c.x, alpha, eps);
      r.y = step_one(a.y, gg.y, c.y, alpha, eps);
      r.z = step_one(a.z, gg.z, c.z, alpha, eps);
      r.w = step_one(a.w, gg.w, c.w, alpha, eps);
      o4[i] = r;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    out[i] = step_one(adv[i], g[i], clean[i], alpha, eps);
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

extern "C" int sign_step_project(const float* adv, const float* g, const float* clean,
                                 float* out, int64_t n, float alpha, float eps,
                                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool vec = aligned16(adv) && aligned16(g) && aligned16(clean) && aligned16(out);
  const int grid = grid_for(vec ? (n + 3) / 4 : n);
  if (grid < 0) return (int)cudaGetLastError();
  if (vec) {
    sign_step_kernel<true><<<grid, kThreads, 0, stream>>>(adv, g, clean, out, n, alpha, eps);
  } else {
    sign_step_kernel<false><<<grid, kThreads, 0, stream>>>(adv, g, clean, out, n, alpha, eps);
  }
  return (int)cudaGetLastError();
}
