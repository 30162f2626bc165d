// Operation counting (host build only, -DRAMSES_COUNT_OPS; kernels/build.py
// build("count")): the kernels' templates instantiated with Counted, a
// double that counts every floating-point operation it takes part in, so
// the operation count of a launch comes from the kernel's own code path on
// its own data. Counted: + - * / and sqrt, rsqrt (1 each; an FMA is two);
// free: sign flips, abs, min/max and comparisons. The count is the work the
// roofline bound of a kernel divides by the card's peak FLOP/s.
#pragma once

#ifndef __CUDACC__
#include <cmath>
#include <vector>

namespace ramses {

struct Counted {
  double v;
  static inline long long ops = 0;
  Counted() = default;
  Counted(double x) : v(x) {}
  explicit operator double() const { return v; }
};

inline Counted operator+(Counted a, Counted b) { ++Counted::ops; return a.v + b.v; }
inline Counted operator-(Counted a, Counted b) { ++Counted::ops; return a.v - b.v; }
inline Counted operator*(Counted a, Counted b) { ++Counted::ops; return a.v * b.v; }
inline Counted operator/(Counted a, Counted b) { ++Counted::ops; return a.v / b.v; }
inline Counted operator-(Counted a) { return -a.v; }
inline bool operator<(Counted a, Counted b) { return a.v < b.v; }
inline bool operator>(Counted a, Counted b) { return a.v > b.v; }
inline bool operator<=(Counted a, Counted b) { return a.v <= b.v; }
inline bool operator>=(Counted a, Counted b) { return a.v >= b.v; }
inline bool operator==(Counted a, Counted b) { return a.v == b.v; }
inline bool operator!=(Counted a, Counted b) { return a.v != b.v; }
inline Counted r_sqrt(Counted x) { ++Counted::ops; return std::sqrt(x.v); }
inline Counted r_rsqrt(Counted x) { ++Counted::ops; return 1.0 / std::sqrt(x.v); }
inline Counted r_abs(Counted x) { return std::fabs(x.v); }
inline Counted r_mul(Counted a, Counted b) { return a * b; }
inline Counted r_fmod(Counted a, Counted b) { ++Counted::ops; return std::fmod(a.v, b.v); }
inline Counted r_floor(Counted a) { return std::floor(a.v); }
inline int to_int(Counted a) { return (int)a.v; }

inline std::vector<Counted> counted_copy(const double* x, long long n) {
  return std::vector<Counted>(x, x + n);
}

}  // namespace ramses
#endif
