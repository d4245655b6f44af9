// K4 on Hopper: the configurational stress tensor over the lag window of
// key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/pallas_pairs.py::_make_stress_kernel
// (:1018, via pair_lag_stress). It computes the same function:
//
//   sigma_ab = sum over slots i and lags 1..L, j = i - lag >= 0, of
//              (g(dsq) d_a) d_b,  d = pos_i - pos_j,  a <= b
//   where key_j >= key_i - W  (candidate key window, W = sum(strides))
//     and 0 < dsq < csq       (strict cutoff; coincident pairs excluded:
//                              g(0) = inf and inf * 0 would poison every
//                              component)
//
// with dsq accumulated axis by axis, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j); the pair decision is the
// f32 dsq of the split separations, as in K1 and the TPU kernel. Force
// factors: LJ g = 24 t (2t - 1) inv with inv = 1/dsq by true division, or
// inv = rsqrt(dsq)^2; t = inv^3. Coordinates are f32 (optionally with f32
// low parts) or f64.
//
// What it does not copy: the TPU kernel's rolling VMEM window, lane rolls,
// per-component Kahan sums and sequential grid. Here one thread owns one
// sorted slot i and walks its lags downwards, K1's walk (lag_reduce.cu):
// keys ascend, so the first j with key_j < key_i - W ends the loop, which
// also stops at lag L. Padding rows (SENTINEL_KEY) read as ascending spaced
// keys above every real key, so they end the key window.
//
// Accumulation: each thread sums the six upper-triangle products
// (xx, xy, xz, yy, yz, zz; absent axes give 0) in f64 registers; the block
// folds its threads in a fixed shared-memory tree and writes six partials.
// The caller sums the partials (the second pass). No float atomics, so the
// result is deterministic.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (f64: 8 B planes), 160-280 MB at n = 1e7,
// 48-84 us at 3.35 TB/s. Operations: K1's 7 (13 split) FP32 instructions
// per lag-window candidate, plus, per cutoff pair, the force factor (11),
// three g d_a products, six d_a d_b products and six f64 adds (counted
// twice: FP64 runs at half the rate): far above the bytes, so it is bound
// by operations. The design keeps all of it in registers; the j-side reads
// hit L1/L2, since neighbouring threads read neighbouring slots. No single
// PyTorch call computes this function.
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
constexpr int kMaxDim = 3;
constexpr int kComps = 6;  // xx, xy, xz, yy, yz, zz
constexpr int kGfnLj = 0;
constexpr int kGfnLjFast = 1;
constexpr int32_t kSentinelKey = 2147483647;  // INT32_MAX
constexpr int32_t kPadKeyBase = kSentinelKey / 2;

// A padding row's key is replaced by kPadKeyBase + slot * spacing, where
// spacing <= (INT32_MAX - kPadKeyBase - 1) / n keeps it below int32 overflow.
__device__ __forceinline__ int32_t load_key(const int32_t* __restrict__ keys,
                                            int slot, int spacing) {
  const int32_t k = keys[slot];
  return k == kSentinelKey ? kPadKeyBase + slot * spacing : k;
}

__device__ __forceinline__ float recip_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double recip_sqrt(double x) { return rsqrt(x); }

template <int GFN, typename T>
__device__ __forceinline__ T force_factor(T dsq) {
  T inv;
  if (GFN == kGfnLj) {
    inv = T(1) / dsq;
  } else {
    const T r = recip_sqrt(dsq);
    inv = r * r;
  }
  const T t = inv * inv * inv;
  return T(24) * t * (T(2) * t - T(1)) * inv;
}

template <typename T, bool SPLIT, int GFN>
__global__ void __launch_bounds__(kBlock)
lag_stress_kernel(const T* __restrict__ pos, const float* __restrict__ lo,
                  const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ w_key, int n, int dim, int L,
                  int spacing, T csq, double* __restrict__ partial) {
  __shared__ double red[kComps][kBlock];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kBlock + t;
  double acc[kComps] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (i < n) {
    const int32_t lo_key = load_key(keys, i, spacing) - *w_key;
    T own[kMaxDim];
    float own_lo[kMaxDim];
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      own[a] = T(0);
      own_lo[a] = 0.0f;
      if (a < dim) {
        own[a] = pos[static_cast<int64_t>(i) * dim + a];
        if (SPLIT) own_lo[a] = lo[static_cast<int64_t>(i) * dim + a];
      }
    }
    const int jmin = i > L ? i - L : 0;
    for (int j = i - 1; j >= jmin; --j) {
      if (load_key(keys, j, spacing) < lo_key) break;
      const int64_t jo = static_cast<int64_t>(j) * dim;
      T d[kMaxDim] = {T(0), T(0), T(0)};
      T dsq = T(0);
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) {
        if (a < dim) {
          T da = own[a] - pos[jo + a];
          if (SPLIT) da = da + (own_lo[a] - lo[jo + a]);
          d[a] = da;
          dsq = dsq + da * da;
        }
      }
      if (dsq < csq && dsq > T(0)) {
        const T g = force_factor<GFN>(dsq);
        const T g0 = g * d[0];
        const T g1 = g * d[1];
        const T g2 = g * d[2];
        acc[0] += static_cast<double>(g0 * d[0]);
        acc[1] += static_cast<double>(g0 * d[1]);
        acc[2] += static_cast<double>(g0 * d[2]);
        acc[3] += static_cast<double>(g1 * d[1]);
        acc[4] += static_cast<double>(g1 * d[2]);
        acc[5] += static_cast<double>(g2 * d[2]);
      }
    }
  }
  // fixed-order block fold: a shared-memory tree per component
#pragma unroll
  for (int k = 0; k < kComps; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k < kComps; ++k) red[k][t] += red[k][t + s];
    }
    __syncthreads();
  }
  if (t < kComps) partial[static_cast<int64_t>(blockIdx.x) * kComps + t] = red[t][0];
}

template <typename T, bool SPLIT>
void launch(const void* pos, const float* lo, const int32_t* keys,
            const int32_t* w_key, int n, int dim, int L, int spacing,
            double csq, int gfn, double* partial, cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  const T* p = static_cast<const T*>(pos);
  const T c = static_cast<T>(csq);
  if (gfn == kGfnLj)
    lag_stress_kernel<T, SPLIT, kGfnLj><<<blocks, kBlock, 0, stream>>>(
        p, lo, keys, w_key, n, dim, L, spacing, c, partial);
  else
    lag_stress_kernel<T, SPLIT, kGfnLjFast><<<blocks, kBlock, 0, stream>>>(
        p, lo, keys, w_key, n, dim, L, spacing, c, partial);
}

}  // namespace

extern "C" {

// Threads per block: the caller allocates ceil(n / block) x 6 partials.
int zelll_lag_stress_block() { return kBlock; }

// pos: (n, dim) row-major f32 (f64 != 0: f64); lo: (n, dim) f32 low parts
// or null (f32 only); keys: (n,) int32 ascending, SENTINEL_KEY rows last;
// w_key: one int32 on the device; spacing: the padding-key spacing; csq:
// cutoff^2 in the coordinates' type; partial: ceil(n / block) x 6 doubles
// (xx, xy, xz, yy, yz, zz per block). Returns cudaGetLastError() after the
// launch.
int zelll_lag_stress(const void* pos, const void* lo, const void* keys,
                     const void* w_key, int n, int dim, int L, int spacing,
                     double csq, int gfn, int f64, void* partial,
                     void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || L < 1 || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      (gfn != kGfnLj && gfn != kGfnLjFast) || (f64 != 0 && lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* w = static_cast<const int32_t*>(w_key);
  auto* out = static_cast<double*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  if (f64 != 0)
    launch<double, false>(pos, l, k, w, n, dim, L, spacing, csq, gfn, out, s);
  else if (l != nullptr)
    launch<float, true>(pos, l, k, w, n, dim, L, spacing, csq, gfn, out, s);
  else
    launch<float, false>(pos, l, k, w, n, dim, L, spacing, csq, gfn, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
