// K8 on Hopper: the configurational stress tensor over segment tiles of
// key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/tile_pairs.py::
// _make_tile_stress_kernel_packed (:735, via tile_pair_stress). It computes
// the same function:
//
//   sigma_ab = sum over own chunks c (slots 128c .. 128c + 127), bands
//              s < S and j-chunks jc of the band's window
//              [jlo + toff, jlo + toff + jnum), of (g(dsq) d_a) d_b,
//              d = pos_i - pos_j, a <= b, over slots i of c and j of jc where
//     i < n and j < n                  (index bound)
//     lo_s <= key_i - key_j <= hi_s    (only with the band mask)
//     jc < c, or jc == c and j < i     (band 0 only: the slot triangle)
//     0 < dsq < csq                    (strict cutoff; coincident excluded)
//
// with dsq accumulated axis by axis, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j) (the f32 dsq decides, as
// in the TPU kernel). The windows and bands come from ops/segments.py on
// the torch side (chunk_bounds, trimmed disjoint for the maskless body).
// Force factors: LJ 24 t (2t - 1) inv with inv = 1/dsq by true division,
// or inv = rsqrt(dsq)^2; t = inv^3. Coordinates are f32 (optionally with
// f32 low parts) or f64.
//
// What it does not copy: the packed 8-row blocks with f32 keys, the DMA
// windows and their semaphores, the lane broadcasts and the fused
// (128, ncomp x 128) accumulator with its cross-program Kahan fold are TPU
// devices. Keys stay int32 here; the index bound replaces the spread
// coordinates of the TPU's tail padding.
//
// Design (K6's, tile_reduce.cu): one block of 128 threads per own chunk;
// thread t owns slot i = 128c + t and keeps its coordinates in registers.
// For each j-chunk of each band window the block stages the chunk's
// coordinates and keys in shared memory, then every thread runs over the
// 128 lanes. Masks select, never multiply, so the inf of a masked-out
// dsq = 0 cannot reach a sum.
//
// Accumulation: each thread sums the six upper-triangle products (xx, xy,
// xz, yy, yz, zz; absent axes give 0) in f64 registers; the block folds
// its threads in a fixed shared-memory tree and writes six partials per
// own chunk. The caller sums the partials. No float atomics, so the result
// is deterministic.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (8 B planes in f64) plus the window bounds,
// about 160 MB at n = 1e7 in f32, 48 us at 3.35 TB/s. Operations: the
// half-stencil candidates times 7 FP32 instructions (13 split), plus per
// cutoff pair the force factor (11), nine products and six f64 adds
// (counted twice), so it is bound by operations. This design evaluates
// every lane of every tile in the windows, many times the candidates, and
// stages through shared memory with a barrier per tile, as K6 does;
// tighter tiles are left for later. No single PyTorch call computes this
// function.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false rounds every product
// and sum on its own, as the plain PyTorch version does, so dsq and hence
// the pair masks match it bitwise on identical inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;  // slots per chunk = threads per block
constexpr int kMaxBands = 5;
constexpr int kMaxDim = 3;
constexpr int kComps = 6;  // xx, xy, xz, yy, yz, zz
constexpr int kGfnLj = 0;
constexpr int kGfnLjFast = 1;

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

template <typename T>
struct Args {
  const T* pos;           // (dim, n) planes
  const float* lo;        // (dim, n) f32 low parts, or null
  const int32_t* keys;    // (nc_pad * 128,) padded keys
  const int32_t* bounds;  // (nc_pad, 3 S): jlo, toff, jnum per band
  const int32_t* bands;   // (S, 2): lo, hi per band
  int n;
  int dim;
  int S;
  T csq;
  double* partial;        // 6 per own chunk
};

// Axis a of slot j (< n) from (dim, n) planes; absent axes and slots at or
// past n read 0, which adds exactly 0 to dsq.
template <typename P>
__device__ __forceinline__ P plane_at(const P* planes, int n, int dim, int a,
                                      int j) {
  return (a < dim && j < n) ? planes[static_cast<int64_t>(a) * n + j] : P(0);
}

template <typename T, bool SPLIT, int GFN, bool BANDMASK>
__global__ void __launch_bounds__(kChunk) tile_stress_kernel(Args<T> a) {
  // the staged j-chunk: coordinates, keys and (split) low parts per lane
  __shared__ T sj[kMaxDim][kChunk];
  __shared__ float sl[kMaxDim][SPLIT ? kChunk : 1];
  __shared__ int32_t sk[kChunk];
  __shared__ double red[kComps][kChunk];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int i = c * kChunk + t;
  const bool own_real = i < a.n;
  const int32_t own_key = a.keys[i];  // keys cover every launched chunk
  T oh[kMaxDim];
  float ol[kMaxDim];
#pragma unroll
  for (int ax = 0; ax < kMaxDim; ++ax) {
    oh[ax] = plane_at(a.pos, a.n, a.dim, ax, i);
    ol[ax] = SPLIT ? plane_at(a.lo, a.n, a.dim, ax, i) : 0.0f;
  }
  double acc[kComps] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int s = 0; s < a.S; ++s) {
    const int32_t* w = a.bounds + (static_cast<int64_t>(c) * a.S + s) * 3;
    const int first = w[0] + w[1];
    const int num = w[2];
    const int32_t band_lo = a.bands[2 * s];
    const int32_t band_hi = a.bands[2 * s + 1];
    for (int jt = 0; jt < num; ++jt) {
      const int jc = first + jt;
      const int j0 = jc * kChunk;
      sk[t] = a.keys[j0 + t];
#pragma unroll
      for (int ax = 0; ax < kMaxDim; ++ax) {
        sj[ax][t] = plane_at(a.pos, a.n, a.dim, ax, j0 + t);
        if (SPLIT) sl[ax][t] = plane_at(a.lo, a.n, a.dim, ax, j0 + t);
      }
      __syncthreads();
      // lanes at or past n hold no particle
      const int lanes = min(kChunk, a.n - j0);
      for (int q = 0; q < lanes; ++q) {
        T d[kMaxDim];
        T dsq = T(0);
#pragma unroll
        for (int ax = 0; ax < kMaxDim; ++ax) {
          T da = oh[ax] - sj[ax][q];
          if (SPLIT) da = da + (ol[ax] - sl[ax][q]);
          d[ax] = da;
          dsq = dsq + da * da;
        }
        bool m = own_real && dsq < a.csq && dsq > T(0);
        if (BANDMASK) {
          const long long diff =
              static_cast<long long>(own_key) - static_cast<long long>(sk[q]);
          m = m && diff >= band_lo && diff <= band_hi;
        }
        if (s == 0) m = m && (jc < c || (jc == c && q < t));
        if (m) {
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
      __syncthreads();
    }
  }
  // fixed-order block fold: a shared-memory tree per component
#pragma unroll
  for (int k = 0; k < kComps; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int h = kChunk / 2; h > 0; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int k = 0; k < kComps; ++k) red[k][t] += red[k][t + h];
    }
    __syncthreads();
  }
  if (t < kComps) a.partial[static_cast<int64_t>(c) * kComps + t] = red[t][0];
}

template <typename T, bool SPLIT, int GFN>
void launch_mask(const Args<T>& a, bool bandmask, int blocks, cudaStream_t s) {
  if (bandmask)
    tile_stress_kernel<T, SPLIT, GFN, true><<<blocks, kChunk, 0, s>>>(a);
  else
    tile_stress_kernel<T, SPLIT, GFN, false><<<blocks, kChunk, 0, s>>>(a);
}

template <typename T, bool SPLIT>
void launch(const void* pos, const float* lo, const int32_t* keys,
            const int32_t* bounds, const int32_t* bands, int n, int dim, int S,
            double csq, int gfn, bool bandmask, double* partial,
            cudaStream_t s) {
  Args<T> a;
  a.pos = static_cast<const T*>(pos);
  a.lo = lo;
  a.keys = keys;
  a.bounds = bounds;
  a.bands = bands;
  a.n = n;
  a.dim = dim;
  a.S = S;
  a.csq = static_cast<T>(csq);
  a.partial = partial;
  const int blocks = (n + kChunk - 1) / kChunk;
  if (gfn == kGfnLj)
    launch_mask<T, SPLIT, kGfnLj>(a, bandmask, blocks, s);
  else
    launch_mask<T, SPLIT, kGfnLjFast>(a, bandmask, blocks, s);
}

}  // namespace

extern "C" {

// Slots per chunk (threads per block); the caller allocates 6 partials per
// chunk that holds a slot below n.
int zelll_tile_stress_chunk() { return kChunk; }

// pos: (dim, n) planes, f32 (f64 != 0: f64); lo: (dim, n) f32 low parts or
// null (f32 only); keys: the padded (nc_pad * 128,) int32 keys; bounds:
// (nc_pad, 3 S) int32 (jlo, toff, jnum) per band; bands: (S, 2) int32 on
// the device; csq: cutoff^2 in the coordinates' type; partial:
// ceil(n / 128) x 6 doubles (xx, xy, xz, yy, yz, zz per chunk). Returns
// cudaGetLastError() after the launch.
int zelll_tile_stress(const void* pos, const void* lo, const void* keys,
                      const void* bounds, const void* bands, int n, int dim,
                      int S, double csq, int gfn, int bandmask, int f64,
                      void* partial, void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands ||
      (gfn != kGfnLj && gfn != kGfnLjFast) || (f64 != 0 && lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* b = static_cast<const int32_t*>(bounds);
  const auto* bd = static_cast<const int32_t*>(bands);
  auto* out = static_cast<double*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  const bool bm = bandmask != 0;
  if (f64 != 0)
    launch<double, false>(pos, l, k, b, bd, n, dim, S, csq, gfn, bm, out, s);
  else if (l != nullptr)
    launch<float, true>(pos, l, k, b, bd, n, dim, S, csq, gfn, bm, out, s);
  else
    launch<float, false>(pos, l, k, b, bd, n, dim, S, csq, gfn, bm, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
