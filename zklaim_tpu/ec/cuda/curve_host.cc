// The point arithmetic of curve.cuh compiled for the CPU, behind a C ABI,
// so that tests check the kernels' own source where there is no GPU.
#include <cstdint>

#include "curve.cuh"

extern "C" {

// o[:, i] = p[:, i] + q[:, i] for i < n; strides are row lengths.
void zk_host_add(int32_t deg, const uint32_t* p, int64_t ps,
                 const uint32_t* q, int64_t qs, uint32_t* o, int64_t os,
                 int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (deg == 1)
      zk::add_at<zk::G1Field>(p, ps, q, qs, o, os, i);
    else
      zk::add_at<zk::G2Field>(p, ps, q, qs, o, os, i);
  }
}

void zk_host_double(int32_t deg, const uint32_t* p, int64_t ps, uint32_t* o,
                    int64_t os, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (deg == 1)
      zk::double_at<zk::G1Field>(p, ps, o, os, i);
    else
      zk::double_at<zk::G2Field>(p, ps, o, os, i);
  }
}

}  // extern "C"
