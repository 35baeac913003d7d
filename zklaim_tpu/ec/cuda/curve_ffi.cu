// GPU kernels for the complete point add/double (curve.cuh), bound as XLA
// FFI handlers.  One thread per point; n is a run-time argument, so one
// compiled kernel serves every batch width.
//
//   zk_curve_add     p (rows, n), q (rows, n)  -> (rows, n)
//   zk_curve_double  p (rows, n)               -> (rows, n)
//   zk_curve_halves  p (rows, 2h)              -> (rows, h): p[:, :h] + p[:, h:]
//
// Attribute `deg`: 1 for G1 (48 rows), 2 for G2 (96 rows).
#include <cstdint>

#include <cuda_runtime.h>

#include "curve.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
add_kernel(const uint32_t* p, int64_t ps, const uint32_t* q, int64_t qs,
           uint32_t* o, int64_t os, int64_t n) {
  int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i < n) zk::add_at<F>(p, ps, q, qs, o, os, i);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
double_kernel(const uint32_t* p, int64_t ps, uint32_t* o, int64_t os,
              int64_t n) {
  int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i < n) zk::double_at<F>(p, ps, o, os, i);
}

int64_t blocks(int64_t n) { return (n + kThreads - 1) / kThreads; }

ffi::Error check(int32_t deg, int64_t rows) {
  if (deg != 1 && deg != 2) return ffi::Error::InvalidArgument("deg must be 1 or 2");
  if (rows != 48 * deg) return ffi::Error::InvalidArgument("rows must be 48 * deg");
  return ffi::Error::Success();
}

ffi::Error launched() {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

void launch_add(cudaStream_t s, int32_t deg, const uint32_t* p, int64_t ps,
                const uint32_t* q, int64_t qs, uint32_t* o, int64_t os,
                int64_t n) {
  if (n == 0) return;
  if (deg == 1)
    add_kernel<zk::G1Field><<<blocks(n), kThreads, 0, s>>>(p, ps, q, qs, o, os, n);
  else
    add_kernel<zk::G2Field><<<blocks(n), kThreads, 0, s>>>(p, ps, q, qs, o, os, n);
}

ffi::Error Add(cudaStream_t s, ffi::Buffer<ffi::U32> p, ffi::Buffer<ffi::U32> q,
               ffi::ResultBuffer<ffi::U32> o, int32_t deg) {
  auto d = p.dimensions();
  if (d.size() != 2) return ffi::Error::InvalidArgument("expected (rows, n)");
  ffi::Error e = check(deg, d[0]);
  if (e.failure()) return e;
  int64_t n = d[1];
  launch_add(s, deg, p.typed_data(), n, q.typed_data(), n, o->typed_data(), n, n);
  return launched();
}

ffi::Error Halves(cudaStream_t s, ffi::Buffer<ffi::U32> p,
                  ffi::ResultBuffer<ffi::U32> o, int32_t deg) {
  auto d = p.dimensions();
  if (d.size() != 2) return ffi::Error::InvalidArgument("expected (rows, n)");
  ffi::Error e = check(deg, d[0]);
  if (e.failure()) return e;
  int64_t n = d[1], h = n / 2;
  launch_add(s, deg, p.typed_data(), n, p.typed_data() + h, n, o->typed_data(), h, h);
  return launched();
}

ffi::Error Double(cudaStream_t s, ffi::Buffer<ffi::U32> p,
                  ffi::ResultBuffer<ffi::U32> o, int32_t deg) {
  auto d = p.dimensions();
  if (d.size() != 2) return ffi::Error::InvalidArgument("expected (rows, n)");
  ffi::Error e = check(deg, d[0]);
  if (e.failure()) return e;
  int64_t n = d[1];
  if (n == 0) return ffi::Error::Success();
  if (deg == 1)
    double_kernel<zk::G1Field><<<blocks(n), kThreads, 0, s>>>(p.typed_data(), n, o->typed_data(), n, n);
  else
    double_kernel<zk::G2Field><<<blocks(n), kThreads, 0, s>>>(p.typed_data(), n, o->typed_data(), n, n);
  return launched();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ZkCurveAdd, Add,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("deg"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(ZkCurveHalves, Halves,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("deg"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(ZkCurveDouble, Double,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("deg"));
