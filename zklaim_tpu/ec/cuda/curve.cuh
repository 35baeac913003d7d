// Complete point add/double for BN254 G1 and G2, for one point per call.
//
// Shared by the GPU kernels (curve_ffi.cu, nvcc) and the CPU build of the
// same arithmetic that the tests check (curve_host.cc, g++).
//
// Field: BN254 Fq as 8 little-endian 32-bit words, Montgomery form with
// R = 2^256 -- the same residues as the 16x16-bit limb code in
// ff/montgomery.py, so results are bit-identical once repacked.
// Multiplication is word-serial Montgomery (CIOS) on 64-bit products.
//
// Points: homogeneous projective (X, Y, Z); the Renes-Costello-Batina
// 2016 complete formulas for a = 0, computing the same polynomials as
// ec/jaxcurve.py point_add/point_double.
//
// Memory layout ("planes"): a batch of n points is a row-major (rows, n)
// uint32 array, rows = 48 (G1) or 96 (G2): 16 rows of 16-bit limbs per Fq
// value, in the order x, y, z (G2: x.c0, x.c1, y.c0, y.c1, z.c0, z.c1).
// Element i of row r sits at r * stride + i, so a warp reads contiguous
// words of every row.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif

namespace zk {

constexpr int kWords = 8;

ZK_HD constexpr uint32_t p_word(int i) {
  return i == 0 ? 0xd87cfd47u : i == 1 ? 0x3c208c16u : i == 2 ? 0x6871ca8du
       : i == 3 ? 0x97816a91u : i == 4 ? 0x8181585du : i == 5 ? 0xb85045b6u
       : i == 6 ? 0xe131a029u : 0x30644e72u;
}
constexpr uint32_t kNp0 = 0xe4866389u;  // -p^-1 mod 2^32

// 3b' of the G2 twist (b' = 3 / (9 + u)), Montgomery form
ZK_HD constexpr uint32_t b3_c0_word(int i) {
  return i == 0 ? 0xb62e0d6au : i == 1 ? 0x3baa927cu : i == 2 ? 0xd1b664fdu
       : i == 3 ? 0xd71e7c52u : i == 4 ? 0xd95d4664u : i == 5 ? 0x03873e63u
       : i == 6 ? 0x082ab8f4u : 0x0e75b5b1u;
}
ZK_HD constexpr uint32_t b3_c1_word(int i) {
  return i == 0 ? 0x7596fe35u : i == 1 ? 0xaab7c666u : i == 2 ? 0xbb6a27bau
       : i == 3 ? 0x31d21a78u : i == 4 ? 0x680401ffu : i == 5 ? 0x85dd7297u
       : i == 6 ? 0xdf39a7e9u : 0x03c52d6au;
}

struct Fq {
  uint32_t w[kWords];
};

// r = t - p if t (plus hi * 2^256) >= p, else t.
ZK_HD Fq reduce_once(const uint32_t t[kWords], uint32_t hi) {
  Fq d;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint64_t s = (uint64_t)t[j] - p_word(j) - borrow;
    d.w[j] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  if (hi == 0 && borrow) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) d.w[j] = t[j];
  }
  return d;
}

ZK_HD Fq fq_add(const Fq& a, const Fq& b) {
  uint32_t s[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint64_t v = (uint64_t)a.w[j] + b.w[j] + c;
    s[j] = (uint32_t)v;
    c = v >> 32;
  }
  return reduce_once(s, (uint32_t)c);
}

ZK_HD Fq fq_sub(const Fq& a, const Fq& b) {
  Fq d;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    d.w[j] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      uint64_t v = (uint64_t)d.w[j] + p_word(j) + c;
      d.w[j] = (uint32_t)v;
      c = v >> 32;
    }
  }
  return d;
}

ZK_HD Fq fq_mul(const Fq& a, const Fq& b) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      uint64_t s = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)s;
    t[kWords + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * kNp0;
    s = (uint64_t)m * p_word(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      s = (uint64_t)m * p_word(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[kWords] + c;
    t[kWords - 1] = (uint32_t)s;
    t[kWords] = t[kWords + 1] + (uint32_t)(s >> 32);
  }
  return reduce_once(t, t[kWords]);
}

struct Fq2 {
  Fq c0, c1;
};

// Field namespaces over which the group law is written.
struct G1Field {
  using T = Fq;
  static constexpr int kRows = 16;  // 16-bit limb rows per element
  ZK_HD static T add(const T& a, const T& b) { return fq_add(a, b); }
  ZK_HD static T sub(const T& a, const T& b) { return fq_sub(a, b); }
  ZK_HD static T mul(const T& a, const T& b) { return fq_mul(a, b); }
  ZK_HD static T dbl(const T& a) { return fq_add(a, a); }
  // 3b = 9 for y^2 = x^3 + 3
  ZK_HD static T mul_b3(const T& x) {
    T x8 = dbl(dbl(dbl(x)));
    return add(x8, x);
  }
};

struct G2Field {
  using T = Fq2;
  static constexpr int kRows = 32;
  ZK_HD static T add(const T& a, const T& b) {
    return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)};
  }
  ZK_HD static T sub(const T& a, const T& b) {
    return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)};
  }
  ZK_HD static T dbl(const T& a) { return add(a, a); }
  // Karatsuba over Fq, u^2 = -1
  ZK_HD static T mul(const T& a, const T& b) {
    Fq t0 = fq_mul(a.c0, b.c0);
    Fq t1 = fq_mul(a.c1, b.c1);
    Fq t2 = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
    return {fq_sub(t0, t1), fq_sub(fq_sub(t2, t0), t1)};
  }
  ZK_HD static T mul_b3(const T& x) {
    T b3;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      b3.c0.w[j] = b3_c0_word(j);
      b3.c1.w[j] = b3_c1_word(j);
    }
    return mul(x, b3);
  }
};

template <class F>
struct Point {
  typename F::T x, y, z;
};

template <class F>
ZK_HD Point<F> rcb_add(const Point<F>& p, const Point<F>& q) {
  using T = typename F::T;
  T t0 = F::mul(p.x, q.x);
  T t1 = F::mul(p.y, q.y);
  T t2 = F::mul(p.z, q.z);
  T t3 = F::sub(F::mul(F::add(p.x, p.y), F::add(q.x, q.y)), F::add(t0, t1));
  T t4 = F::sub(F::mul(F::add(p.y, p.z), F::add(q.y, q.z)), F::add(t1, t2));
  T t5 = F::sub(F::mul(F::add(p.x, p.z), F::add(q.x, q.z)), F::add(t0, t2));
  T m = F::add(F::dbl(t0), t0);
  T n = F::mul_b3(t2);
  T bv = F::mul_b3(t5);
  T wmn = F::sub(t1, n);
  T wpn = F::add(t1, n);
  Point<F> r;
  r.x = F::sub(F::mul(t3, wmn), F::mul(t4, bv));
  r.y = F::add(F::mul(wpn, wmn), F::mul(m, bv));
  r.z = F::add(F::mul(t4, wpn), F::mul(t3, m));
  return r;
}

template <class F>
ZK_HD Point<F> rcb_double(const Point<F>& p) {
  using T = typename F::T;
  T t0 = F::mul(p.y, p.y);
  T t1 = F::mul(p.y, p.z);
  T t2 = F::mul(p.z, p.z);
  T t3 = F::mul(p.x, p.y);
  T z8 = F::dbl(F::dbl(F::dbl(t0)));
  T n = F::mul_b3(t2);
  T n3 = F::add(F::dbl(n), n);
  T t0m = F::sub(t0, n3);
  T t0p = F::add(t0, n);
  Point<F> r;
  r.z = F::mul(t1, z8);
  r.y = F::add(F::mul(t0m, t0p), F::mul(n, z8));
  r.x = F::dbl(F::mul(t0m, t3));
  return r;
}

// -- planes <-> registers -------------------------------------------------

ZK_HD Fq load_fq(const uint32_t* a, int64_t stride, int row, int64_t i) {
  Fq v;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    v.w[j] = a[(row + 2 * j) * stride + i] |
             (a[(row + 2 * j + 1) * stride + i] << 16);
  }
  return v;
}

ZK_HD void store_fq(uint32_t* a, int64_t stride, int row, int64_t i,
                    const Fq& v) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    a[(row + 2 * j) * stride + i] = v.w[j] & 0xffffu;
    a[(row + 2 * j + 1) * stride + i] = v.w[j] >> 16;
  }
}

ZK_HD void load(const uint32_t* a, int64_t s, int row, int64_t i, Fq& v) {
  v = load_fq(a, s, row, i);
}
ZK_HD void load(const uint32_t* a, int64_t s, int row, int64_t i, Fq2& v) {
  v.c0 = load_fq(a, s, row, i);
  v.c1 = load_fq(a, s, row + 16, i);
}
ZK_HD void store(uint32_t* a, int64_t s, int row, int64_t i, const Fq& v) {
  store_fq(a, s, row, i, v);
}
ZK_HD void store(uint32_t* a, int64_t s, int row, int64_t i, const Fq2& v) {
  store_fq(a, s, row, i, v.c0);
  store_fq(a, s, row + 16, i, v.c1);
}

template <class F>
ZK_HD Point<F> load_point(const uint32_t* a, int64_t stride, int64_t i) {
  Point<F> p;
  load(a, stride, 0, i, p.x);
  load(a, stride, F::kRows, i, p.y);
  load(a, stride, 2 * F::kRows, i, p.z);
  return p;
}

template <class F>
ZK_HD void store_point(uint32_t* a, int64_t stride, int64_t i,
                       const Point<F>& p) {
  store(a, stride, 0, i, p.x);
  store(a, stride, F::kRows, i, p.y);
  store(a, stride, 2 * F::kRows, i, p.z);
}

// One output lane: o[:, i] = p[:, i] + q[:, i] (each with its own stride).
template <class F>
ZK_HD void add_at(const uint32_t* p, int64_t ps, const uint32_t* q,
                  int64_t qs, uint32_t* o, int64_t os, int64_t i) {
  store_point<F>(o, os, i,
                 rcb_add<F>(load_point<F>(p, ps, i), load_point<F>(q, qs, i)));
}

template <class F>
ZK_HD void double_at(const uint32_t* p, int64_t ps, uint32_t* o, int64_t os,
                     int64_t i) {
  store_point<F>(o, os, i, rcb_double<F>(load_point<F>(p, ps, i)));
}

}  // namespace zk
