// K3 on Hopper: per-particle pair forces over key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/pallas_pairs.py::_make_forces_kernel
// (:583, via pair_lag_forces). It computes the same function:
//
//   f_i = sum over unique pairs (p, q = p - lag), lag = 1..L, that hold i,
//         of +g d for i == p and -g d for i == q, where
//     key_q >= key_p - W       (candidate key window, W = sum(strides))
//     0 < dsq < csq            (strict cutoff; coincident particles excluded)
//     d = pos_p - pos_q, g = gfn(dsq)
//
// with dsq = (d0 d0 + d1 d1) + d2 d2, and in split mode each axis'
// separation d = (hi_p - hi_q) + (lo_p - lo_q). In split mode a pair whose
// f32 dsq lies within 1e-6 csq of the cutoff is decided on the f64 dsq of
// its split separations instead, so that no pair flips at the cutoff (the
// TPU kernel decides on the f32 dsq). Force factors: LJ
// 24 t (2t - 1) inv with inv = 1/dsq by true division, or inv =
// rsqrtf(dsq)^2; t = inv^3.
//
// What it does not copy: the TPU kernel's Horner shift accumulator, which
// lands the j-side contributions at their window slots because Mosaic has
// no scatter, and its rolling VMEM window and sequential grid. Here one
// thread owns one sorted slot i and walks both of its partner lists:
// backwards over j = i - lag while key_j >= key_i - W, and forwards over
// k = i + lag while key_i >= key_k - W, each for at most L lags (the exact
// lag set of the TPU kernel, so the result is defined where the coverage
// flag is False). Keys ascend, so each walk stops at its first partner out
// of window. Every pair is evaluated twice, once from each end, and both
// evaluations agree bitwise: IEEE subtraction is exactly antisymmetric,
// also in the split form, so dsq, g and |d| are the same from both sides
// and action equals reaction per pair. There are no float atomics, and the
// result is deterministic. The index bounds 0 <= j and k < n replace the
// TPU's spread tail coordinates; padding rows (SENTINEL_KEY) read as
// ascending spaced keys above every real key, K1's rule (lag_reduce.cu).
//
// Accumulation: each thread sums its f32 products g d in f64 and writes
// f32 planes, or f64 planes when asked (the checks compare f64 sums).
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane + 3 force planes) x n, 280 MB at n = 1e7 in f32 mode,
// 84 us at 3.35 TB/s. Operations, counted as FP32 instructions with FMA
// contraction allowed, once per unique pair: 7 for each half-stencil
// candidate (13 in split mode) plus 11 for the force factor and 9 for
// g d on both sides of each cutoff pair. At the benchmark's density (132
// candidates and 21 cutoff pairs per slot) that is about 0.4 ms at
// 33.5 T instructions/s, so it is bound by operations. This design walks
// every in-window pair from both ends, about twice that work, plus the
// lag-window candidates that are not stencil candidates; a Newton
// half-pair form with a shared-memory j-side window is left for later.
// No single PyTorch call computes this function.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence the pair masks match
// it bitwise on identical sorted inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kGfnLj = 0;
constexpr int kGfnLjFast = 1;
constexpr int32_t kSentinelKey = 2147483647;  // INT32_MAX
constexpr int32_t kPadKeyBase = kSentinelKey / 2;
// Split mode's tie band around the cutoff (_TIE_BAND in lag_pairs.py)
constexpr float kTieBand = 1e-6f;

// A padding row's key is replaced by kPadKeyBase + slot * spacing, where
// spacing <= (INT32_MAX - kPadKeyBase - 1) / n keeps it below int32 overflow.
__device__ __forceinline__ int32_t load_key(const int32_t* __restrict__ keys,
                                            int slot, int spacing) {
  const int32_t k = keys[slot];
  return k == kSentinelKey ? kPadKeyBase + slot * spacing : k;
}

template <int GFN>
__device__ __forceinline__ float force_factor(float dsq) {
  float inv;
  if (GFN == kGfnLj) {
    inv = 1.0f / dsq;
  } else {
    const float r = rsqrtf(dsq);
    inv = r * r;
  }
  const float t = inv * inv * inv;
  return 24.0f * t * (2.0f * t - 1.0f) * inv;
}

struct Args {
  const float* pos;       // (3, n) planes
  const float* lo;        // (3, n) low parts, or null
  const int32_t* keys;    // (n,) ascending, SENTINEL_KEY rows last
  const int32_t* w_key;   // one int32 on the device
  int n;
  int L;
  int spacing;
  float csq;
  void* out;              // (3, n) planes of float or double
};

struct Own {
  float x, y, z;     // hi parts
  float lx, ly, lz;  // lo parts (split mode)
};

// g d of the pair (i, j) seen from i, added to i's sums when the pair is
// inside the cutoff and not coincident. Masks select; nothing multiplies
// by a mask, so the inf of a masked-out dsq = 0 never reaches a sum.
template <bool SPLIT, int GFN>
__device__ __forceinline__ void add_pair(const Own& o, const Args& a,
                                         int64_t j, double& fx, double& fy,
                                         double& fz) {
  const int64_t n = a.n;
  float dx = o.x - a.pos[j];
  float dy = o.y - a.pos[n + j];
  float dz = o.z - a.pos[2 * n + j];
  if (SPLIT) {
    dx = dx + (o.lx - a.lo[j]);
    dy = dy + (o.ly - a.lo[n + j]);
    dz = dz + (o.lz - a.lo[2 * n + j]);
  }
  float dsq = dx * dx;
  dsq = dsq + dy * dy;
  dsq = dsq + dz * dz;
  bool inside = dsq < a.csq;
  if (SPLIT && fabsf(dsq - a.csq) <= kTieBand * a.csq) {
    // near the cutoff the f32 dsq may fall on the wrong side: decide on the
    // f64 dsq of the split separations (split_cutoff_test in lag_pairs.py)
    const double ex = (static_cast<double>(o.x) - static_cast<double>(a.pos[j])) +
                      (static_cast<double>(o.lx) - static_cast<double>(a.lo[j]));
    const double ey =
        (static_cast<double>(o.y) - static_cast<double>(a.pos[n + j])) +
        (static_cast<double>(o.ly) - static_cast<double>(a.lo[n + j]));
    const double ez =
        (static_cast<double>(o.z) - static_cast<double>(a.pos[2 * n + j])) +
        (static_cast<double>(o.lz) - static_cast<double>(a.lo[2 * n + j]));
    double dsq64 = ex * ex;
    dsq64 = dsq64 + ey * ey;
    dsq64 = dsq64 + ez * ez;
    inside = dsq64 < static_cast<double>(a.csq);
  }
  if (inside && dsq > 0.0f) {
    const float g = force_factor<GFN>(dsq);
    fx += static_cast<double>(g * dx);
    fy += static_cast<double>(g * dy);
    fz += static_cast<double>(g * dz);
  }
}

template <bool SPLIT, int GFN, typename Out>
__global__ void __launch_bounds__(kBlock) lag_forces_kernel(Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const int64_t n = a.n;
  const int32_t w = *a.w_key;
  const int32_t key_i = load_key(a.keys, i, a.spacing);
  Own o;
  o.x = a.pos[i];
  o.y = a.pos[n + i];
  o.z = a.pos[2 * n + i];
  if (SPLIT) {
    o.lx = a.lo[i];
    o.ly = a.lo[n + i];
    o.lz = a.lo[2 * n + i];
  }
  double fx = 0.0, fy = 0.0, fz = 0.0;
  // partners behind: pairs (i, j = i - lag), in window iff key_j >= key_i - W
  const int32_t lo_key = key_i - w;
  const int jmin = i > a.L ? i - a.L : 0;
  for (int j = i - 1; j >= jmin; --j) {
    if (load_key(a.keys, j, a.spacing) < lo_key) break;
    add_pair<SPLIT, GFN>(o, a, j, fx, fy, fz);
  }
  // partners ahead: pairs (k = i + lag, i), in window iff key_i >= key_k - W
  const int kmax = a.n - 1 - i > a.L ? i + a.L : a.n - 1;
  for (int k = i + 1; k <= kmax; ++k) {
    if (load_key(a.keys, k, a.spacing) - w > key_i) break;
    add_pair<SPLIT, GFN>(o, a, k, fx, fy, fz);
  }
  Out* out = static_cast<Out*>(a.out);
  out[i] = static_cast<Out>(fx);
  out[n + i] = static_cast<Out>(fy);
  out[2 * n + i] = static_cast<Out>(fz);
}

template <bool SPLIT, int GFN>
void launch_out(const Args& a, bool f64_out, cudaStream_t s) {
  const int blocks = (a.n + kBlock - 1) / kBlock;
  if (f64_out)
    lag_forces_kernel<SPLIT, GFN, double><<<blocks, kBlock, 0, s>>>(a);
  else
    lag_forces_kernel<SPLIT, GFN, float><<<blocks, kBlock, 0, s>>>(a);
}

template <bool SPLIT>
void launch_gfn(const Args& a, int gfn, bool f64_out, cudaStream_t s) {
  if (gfn == kGfnLj)
    launch_out<SPLIT, kGfnLj>(a, f64_out, s);
  else
    launch_out<SPLIT, kGfnLjFast>(a, f64_out, s);
}

}  // namespace

extern "C" {

// Threads per block.
int zelll_lag_forces_block() { return kBlock; }

// pos, lo: (3, n) f32 planes (lo null unless split); keys: (n,) int32
// ascending, SENTINEL_KEY rows last; w_key: one int32 on the device;
// spacing: the padding-key spacing, (INT32_MAX - INT32_MAX / 2 - 1) / n at
// least 1; gfn: 0 for the LJ force factor, 1 for its rsqrt form; out: (3, n)
// planes of float (f64_out == 0) or double (f64_out != 0). Returns
// cudaGetLastError() after the launch.
int zelll_lag_forces(const void* pos, const void* lo, const void* keys,
                     const void* w_key, int n, int L, int spacing, float csq,
                     int gfn, int f64_out, void* out, void* stream) {
  if (n <= 0 || L < 1 || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      (gfn != kGfnLj && gfn != kGfnLjFast))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.lo = static_cast<const float*>(lo);
  a.keys = static_cast<const int32_t*>(keys);
  a.w_key = static_cast<const int32_t*>(w_key);
  a.n = n;
  a.L = L;
  a.spacing = spacing;
  a.csq = csq;
  a.out = out;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.lo != nullptr)
    launch_gfn<true>(a, gfn, f64_out != 0, s);
  else
    launch_gfn<false>(a, gfn, f64_out != 0, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
