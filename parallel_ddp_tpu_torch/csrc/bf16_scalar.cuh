// bfloat16 scalar of the thread-group core (kuka_soa_group.cuh): the Kuka
// dynamics at the precision of `models/kuka/soa.py` run on bfloat16 tensors,
// as `SolverConfig.bf16_rollout`'s step asks (rollout.cu's bf16 entry).
//
// Bf16 holds the 16 bits of a bfloat16.  Every operation computes in float
// on the operands' exact float values and rounds its result to bfloat16
// (round to nearest even) before the next operation reads it: what PyTorch
// does on a bfloat16 tensor, op by op.  Each rounding is a conversion
// between the operations, so nvcc cannot contract a multiply and an add
// across it into one fused multiply-add.  A float operand (a chain constant,
// the step size) enters unrounded, as PyTorch takes a Python float in a
// product; where the Python core rounds a constant first, the core does too
// (KcAs in kuka_soa.cuh, specialised below).
//
// Built with KG_HOST_EMULATION (tests/test_torch_group_core.py) the
// conversions are written out in integer arithmetic for the host compiler.
#pragma once

#include "kuka_soa_group.cuh"

#ifndef KG_HOST_EMULATION
#include <cuda_bf16.h>
#else
#include <cstdint>
#include <cstring>
#endif

__device__ __forceinline__ unsigned short bf16_bits(float f) {
#ifndef KG_HOST_EMULATION
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
#else
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<unsigned short>((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<unsigned short>(u >> 16);
#endif
}

__device__ __forceinline__ float bf16_value(unsigned short b) {
#ifndef KG_HOST_EMULATION
  return __uint_as_float(static_cast<unsigned>(b) << 16);
#else
  const uint32_t u = static_cast<uint32_t>(b) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

struct __align__(2) Bf16 {
  unsigned short b;
  Bf16() = default;
  __device__ __forceinline__ Bf16(float f) : b(bf16_bits(f)) {}
  __device__ __forceinline__ float f() const { return bf16_value(b); }
};

__device__ __forceinline__ Bf16 operator+(Bf16 a, Bf16 b) { return Bf16(a.f() + b.f()); }
__device__ __forceinline__ Bf16 operator-(Bf16 a, Bf16 b) { return Bf16(a.f() - b.f()); }
__device__ __forceinline__ Bf16 operator*(Bf16 a, Bf16 b) { return Bf16(a.f() * b.f()); }
__device__ __forceinline__ Bf16 operator/(Bf16 a, Bf16 b) { return Bf16(a.f() / b.f()); }
__device__ __forceinline__ Bf16 operator+(float a, Bf16 b) { return Bf16(a + b.f()); }
__device__ __forceinline__ Bf16 operator+(Bf16 a, float b) { return Bf16(a.f() + b); }
__device__ __forceinline__ Bf16 operator*(float a, Bf16 b) { return Bf16(a * b.f()); }
__device__ __forceinline__ Bf16 operator*(Bf16 a, float b) { return Bf16(a.f() * b); }
__device__ __forceinline__ Bf16 operator/(float a, Bf16 b) { return Bf16(a / b.f()); }
__device__ __forceinline__ Bf16 operator-(Bf16 a) {      // exact: the sign bit
  Bf16 r;
  r.b = static_cast<unsigned short>(a.b ^ 0x8000u);
  return r;
}

__device__ __forceinline__ Bf16 s_sin(Bf16 a) { return Bf16(sinf(a.f())); }
__device__ __forceinline__ Bf16 s_cos(Bf16 a) { return Bf16(cosf(a.f())); }
__device__ __forceinline__ Bf16 s_sqrt(Bf16 a) { return Bf16(sqrtf(a.f())); }

// the Python core multiplies channels by its constants at float precision,
// and rounds a constant that it adds as a channel of its own
template <>
struct KcAs<Bf16> {
  typedef float factor;
  typedef Bf16 term;
};
