// Closest-hit mesh query: one thread per ray walks the flattened SAH BVH
// with a private 64-entry stack, the reference's own design
// (IntersectBVH, reference src/intersections.h:265-329).
//
// Rule for rule this matches the plain traversal
// ptdn.ops.bvh_traverse.mesh_bvh_batched, which is its oracle:
//   * pure AABB test of every visited node (no t-range cull);
//   * near child first by the sign of the ray direction on the split axis;
//   * on a full stack the interior node is given up (its far subtree is
//     dropped, intersections.h:308-311);
//   * leaves test up to `count` triangles with glm's backface-culled
//     Moller-Trumbore; the closest hit is updated with strict `<`.
// Results: t (-1 on a miss), u, v and the triangle index (-1 on a miss).
//
// Bound to XLA as the FFI handler PtdnBvhClosestHit; the Python side is
// ptdn/ops/cuda_bvh.py, which pads the ray count to kBlock.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxDepth = 64;  // intersections.h:265
constexpr int kBlock = 128;    // cuda_bvh.BLOCK
constexpr float kFltEpsilon = 1.1920929e-07f;
constexpr float kFltMax = 3.402823466e38f;

// XLA's min and max propagate NaN; the slab test must too, so a ray
// whose origin lies on a slab plane with a zero direction component
// misses here exactly when it misses in the plain traversal.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kBlock) bvh_closest_hit(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ bmin, const float* __restrict__ bmax,
    const int32_t* __restrict__ count, const int32_t* __restrict__ axis,
    const int32_t* __restrict__ prim_off, const int32_t* __restrict__ right,
    const float* __restrict__ tri_v, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int32_t* __restrict__ idx_out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best_t = kFltMax, best_u = 0.0f, best_v = 0.0f;
  int32_t best_i = -1;
  int32_t stack[kMaxDepth];
  int sp = 0;
  int32_t cur = 0;
  while (true) {
    const float* lo = bmin + 3 * cur;
    const float* hi = bmax + 3 * cur;
    const float t0x = (__ldg(lo) - ox) * ix, t1x = (__ldg(hi) - ox) * ix;
    const float t0y = (__ldg(lo + 1) - oy) * iy;
    const float t1y = (__ldg(hi + 1) - oy) * iy;
    const float t0z = (__ldg(lo + 2) - oz) * iz;
    const float t1z = (__ldg(hi + 2) - oz) * iz;
    const float tmin = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                               nan_min(t0z, t1z));
    const float tmax = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                               nan_max(t0z, t1z));
    const bool box = (tmax >= 0.0f) && (tmin <= tmax);
    const int32_t cnt = __ldg(count + cur);

    if (box && cnt > 0) {
      const int32_t off = __ldg(prim_off + cur);
      for (int32_t k = 0; k < cnt; ++k) {
        const float* tv = tri_v + 9 * static_cast<int64_t>(off + k);
        const float v0x = __ldg(tv), v0y = __ldg(tv + 1), v0z = __ldg(tv + 2);
        const float e1x = __ldg(tv + 3) - v0x, e1y = __ldg(tv + 4) - v0y;
        const float e1z = __ldg(tv + 5) - v0z;
        const float e2x = __ldg(tv + 6) - v0x, e2y = __ldg(tv + 7) - v0y;
        const float e2z = __ldg(tv + 8) - v0z;
        // glm::intersectRayTriangle (glm/gtx/intersect.inl:36-74)
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float a = e1x * px + e1y * py + e1z * pz;
        const bool front = a >= kFltEpsilon;
        const float f = 1.0f / (front ? a : 1.0f);
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float u = f * (sx * px + sy * py + sz * pz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = f * (dx * qx + dy * qy + dz * qz);
        const float t = f * (e2x * qx + e2y * qy + e2z * qz);
        const bool hit = front && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                         u + v <= 1.0f && t >= 0.0f;
        if (hit && t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_i = off + k;
        }
      }
    }

    if (box && cnt == 0 && sp < kMaxDepth) {
      const int32_t ax = max(__ldg(axis + cur), 0);
      const float d_ax = ax == 0 ? dx : (ax == 1 ? dy : dz);
      const int32_t r = __ldg(right + cur);
      const bool neg = d_ax < 0.0f;
      stack[sp++] = neg ? cur + 1 : r;  // far child
      cur = neg ? r : cur + 1;          // near child
    } else {
      // missed box, finished leaf, or interior node on a full stack
      if (sp == 0) break;
      cur = stack[--sp];
    }
  }
  const bool hit = best_i >= 0;
  t_out[i] = hit ? best_t : -1.0f;
  u_out[i] = best_u;
  v_out[i] = best_v;
  idx_out[i] = best_i;
}

ffi::Error BvhClosestHitImpl(
    cudaStream_t stream, ffi::Buffer<ffi::F32> orig, ffi::Buffer<ffi::F32> dir,
    ffi::Buffer<ffi::F32> bmin, ffi::Buffer<ffi::F32> bmax,
    ffi::Buffer<ffi::S32> count, ffi::Buffer<ffi::S32> axis,
    ffi::Buffer<ffi::S32> prim_off, ffi::Buffer<ffi::S32> right,
    ffi::Buffer<ffi::F32> tri_v, ffi::ResultBuffer<ffi::F32> t,
    ffi::ResultBuffer<ffi::F32> u, ffi::ResultBuffer<ffi::F32> v,
    ffi::ResultBuffer<ffi::S32> idx) {
  const int64_t n = static_cast<int64_t>(orig.dimensions()[0]);
  if (n == 0) return ffi::Error::Success();
  const int64_t grid = (n + kBlock - 1) / kBlock;
  bvh_closest_hit<<<static_cast<unsigned int>(grid), kBlock, 0, stream>>>(
      orig.typed_data(), dir.typed_data(), bmin.typed_data(),
      bmax.typed_data(), count.typed_data(), axis.typed_data(),
      prim_off.typed_data(), right.typed_data(), tri_v.typed_data(),
      t->typed_data(), u->typed_data(), v->typed_data(), idx->typed_data(),
      n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PtdnBvhClosestHit, BvhClosestHitImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // origins
                                  .Arg<ffi::Buffer<ffi::F32>>()  // directions
                                  .Arg<ffi::Buffer<ffi::F32>>()  // bvh_min
                                  .Arg<ffi::Buffer<ffi::F32>>()  // bvh_max
                                  .Arg<ffi::Buffer<ffi::S32>>()  // bvh_count
                                  .Arg<ffi::Buffer<ffi::S32>>()  // bvh_axis
                                  .Arg<ffi::Buffer<ffi::S32>>()  // prim_off
                                  .Arg<ffi::Buffer<ffi::S32>>()  // bvh_right
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tri_v
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // v
                                  .Ret<ffi::Buffer<ffi::S32>>());  // tri idx
