// The element type of a kernel build and the arithmetic the kernels take
// in it.  A build is float32 by default and float64 with -DC2R_F64 (one
// shared library each, ops/sweep_cuda.build_for).
//
// The plain PyTorch versions hold every constant as a Python float and
// torch casts it to the tensor's type before the op, so the kernels take
// each constant as rl(double literal): the same cast, float or double.
// Each math function maps to its libdevice routine of that type (logf or
// log, expf or exp, ...), the ones torch's elementwise kernels call.

#pragma once

#ifdef C2R_F64
typedef double real;
#else
typedef float real;
#endif

__host__ __device__ constexpr real rl(double x) {
  return static_cast<real>(x);
}

// The constants the march and the rate pass share, in the build's type.
constexpr real kSigma = rl(6.30e-18);             // SIGMA_HI_AT_ION_FREQ
constexpr real kFourPi = rl(12.566370614359172);
constexpr real kSqrt2 = rl(1.4142135623730951);
constexpr real kSqrt3 = rl(1.7320508075688772);   // the longest path, cells

__device__ __forceinline__ float r_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double r_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double r_expm1(double x) { return expm1(x); }
__device__ __forceinline__ float r_log(float x) { return logf(x); }
__device__ __forceinline__ double r_log(double x) { return log(x); }
__device__ __forceinline__ float r_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double r_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float r_floor(float x) { return floorf(x); }
__device__ __forceinline__ double r_floor(double x) { return floor(x); }
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) {
  return fmax(a, b);
}
