// Fused AdamW update of the trainer's optimizer (train/optimizer.py) for
// Hopper (sm_90a), f32.
//
// Replaces no Pallas kernel: the JAX package's update is the optax chain of
// multi_modal_tracking_tpu/train/optimizer.py:171 (optax.adamw per regime
// group: scale_by_adam, add_decayed_weights, scale_by_learning_rate, then
// apply_updates), which XLA fuses into one elementwise program. This kernel
// reads the parameter, its gradient and both moments once and writes the
// parameter and the moments once.
//
// Per element, in optax's order, each operation rounded once (the __*_rn
// intrinsics keep nvcc from contracting a product and a sum into an FMA),
// so that the result is the same bits as the plain version
// (ops/adamw.py adamw_ref, one PyTorch operation per step) on the card and
// on the CPU:
//
//     mu  = mu * b1 + g * (1 - b1)
//     nu  = nu * b2 + (g * g) * (1 - b2)
//     u   = (mu / bc1) / (sqrt(nu / bc2) + eps)      bc = 1 - b^count
//     u   = u + p * weight_decay                      (if weight_decay)
//     p   = p + u * (-lr)
//
// -lr (one per parameter group) and the two bias corrections are read from
// device memory, filled by the host before each update, so that a CUDA
// graph that holds the launch follows the schedule. The tensors are the
// optimizer's static buffers: their addresses, sizes and groups sit in
// device tables built once (ops/adamw.py AdamWTable), and the work is cut
// into chunks of at most kChunk elements of one tensor, one block a chunk.
//
// What bounds it on the H100: 7 floats moved per element (3 in, 3 out and
// the gradient), about 15 operations; bytes bound it, 0.87 ms at 3.35 TB/s
// for the flagship's 104 M parameters.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 1 << 16;          // a multiple of 4 * kThreads

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v, float neg_lr,
                                              float bc1, float bc2, const Consts& c) {
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.omb1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(g, g), c.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  if (c.wd != 0.f) u = __fadd_rn(u, __fmul_rn(p, c.wd));
  p = __fadd_rn(p, __fmul_rn(u, neg_lr));
}

__global__ void __launch_bounds__(kThreads)
adamw_f32_kernel(const int64_t* __restrict__ ptrs, const int64_t* __restrict__ numel,
                 const int32_t* __restrict__ group, const int32_t* __restrict__ chunk_tensor,
                 const int64_t* __restrict__ chunk_start, int n_tensors,
                 const float* __restrict__ neg_lr, const float* __restrict__ bc, Consts c) {
  const int t = chunk_tensor[blockIdx.x];
  const int64_t start = chunk_start[blockIdx.x];
  const int64_t rest = numel[t] - start;
  const int64_t n = rest < kChunk ? rest : kChunk;
  float* p = reinterpret_cast<float*>(ptrs[t]) + start;
  const float* g = reinterpret_cast<const float*>(ptrs[n_tensors + t]) + start;
  float* m = reinterpret_cast<float*>(ptrs[2 * n_tensors + t]) + start;
  float* v = reinterpret_cast<float*>(ptrs[3 * n_tensors + t]) + start;
  const float lr = neg_lr[group[t]], bc1 = bc[0], bc2 = bc[1];
  int64_t i0 = 0;
  const uintptr_t any = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  if ((any & 15) == 0) {                     // 16-byte aligned: float4 accesses
    const int64_t n4 = n / 4;
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float4 pp = reinterpret_cast<float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      adamw_element(pp.x, gg.x, mm.x, vv.x, lr, bc1, bc2, c);
      adamw_element(pp.y, gg.y, mm.y, vv.y, lr, bc1, bc2, c);
      adamw_element(pp.z, gg.z, mm.z, vv.z, lr, bc1, bc2, c);
      adamw_element(pp.w, gg.w, mm.w, vv.w, lr, bc1, bc2, c);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    i0 = n4 * 4;
  }
  for (int64_t i = i0 + threadIdx.x; i < n; i += kThreads) {
    float pp = p[i], mm = m[i], vv = v[i];
    adamw_element(pp, g[i], mm, vv, lr, bc1, bc2, c);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// ptrs: (4, n_tensors) int64 addresses of the parameters, gradients, first
// and second moments; numel (n_tensors) int64; group (n_tensors) int32,
// the index into neg_lr; chunk_tensor (n_chunks) int32 and chunk_start
// (n_chunks) int64, each chunk's tensor and first element (chunks of at
// most 65,536 elements); neg_lr (groups) f32; bc (2) f32 = 1 - b1^count,
// 1 - b2^count. Returns a cudaError_t.
extern "C" int adamw_f32(const void* ptrs, const void* numel, const void* group,
                         const void* chunk_tensor, const void* chunk_start, int n_tensors,
                         int n_chunks, const void* neg_lr, const void* bc, float b1, float omb1,
                         float b2, float omb2, float eps, float wd, void* stream) {
  if (n_chunks == 0) return cudaSuccess;
  const Consts c{b1, omb1, b2, omb2, eps, wd};
  adamw_f32_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ptrs), static_cast<const int64_t*>(numel),
      static_cast<const int32_t*>(group), static_cast<const int32_t*>(chunk_tensor),
      static_cast<const int64_t*>(chunk_start), n_tensors, static_cast<const float*>(neg_lr),
      static_cast<const float*>(bc), c);
  return static_cast<int>(cudaGetLastError());
}
