// The barycentric value of a located 2D query: the epilogue that
// cells2d.cu and walk2d.cu share, so that both give the same bits.
//
// Its plain version is the tail of models/device_tri.py::interp:
//   vals = response_ext[tri_verts[leaf]]  (or resp_tri[leaf, :3])
//   out = torch.where(in_domain, torch.sum(w * vals, dim=-1), 0.0)
// torch.sum over a contiguous last dimension of 3 runs on the card as a
// reduce kernel with two threads per output (block_width = last_pow2(3)):
// the first accumulates elements 0 and 2 in two accumulators started at 0
// and combines them, the second holds element 1, and the warp shuffle
// adds the second's to the first's.  So the sum is (p0 + p2) + p1, each
// product and sum rounded on its own (__f*_rn, and the build keeps
// -fmad=false); the final + 0 turns a -0 into the +0 that the reduction's
// zero-started accumulators give.  (On the CPU torch sums (p0 + p1) + p2.)
// A query out of the domain gives +0.

#pragma once

// The value at weights (w0, w1, w2) of a triangle whose vertex responses
// are r.x, r.y, r.z (its 16-byte row of device_tri.vertex_responses):
// interp's tail.
__device__ __forceinline__ float bary_value(float4 r, float w0, float w1, float w2,
                                            bool in_domain) {
  if (!in_domain) return 0.0f;
  const float p0 = __fmul_rn(w0, r.x);
  const float p1 = __fmul_rn(w1, r.y);
  const float p2 = __fmul_rn(w2, r.z);
  return __fadd_rn(__fadd_rn(__fadd_rn(p0, p2), p1), 0.0f);
}
