// K9 on Hopper: the cumulative pair-distance histogram over segment tiles
// of key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/tile_pairs.py::
// _make_tile_hist_kernel_packed (:453, via tile_pair_hist). It computes the
// same function:
//
//   count_k = #{own chunks c, bands s < S, j-chunks jc of the band's window
//               [jlo + toff, jlo + toff + jnum), slots i of c, j of jc :
//     i < n and j < n                  (index bound)
//     lo_s <= key_i - key_j <= hi_s    (only with the band mask)
//     jc < c, or jc == c and j < i     (band 0 only: the slot triangle)
//     dsq < edges[K - 1]               (the cutoff is the last edge)
//     mask(w_i, w_j)                   (optional payload pair mask)
//     dsq < edges[k]}                  (strict, per edge)
//
// for k < K <= 64, with dsq accumulated axis by axis, and in split mode
// each axis' separation d = (hi_i - hi_j) + (lo_i - lo_j) (the f32 dsq
// decides, as in the TPU kernel). No dsq > 0 test: coincident pairs count
// in every bin whose edge is above 0. Masks: none, or the species pair
// mask of ops/rdf.py (keep {w_i, w_j} == {a, b}) over one payload plane;
// mask id 2 is left for the periodic keep mask.
//
// What it does not copy: the TPU kernel compares every pair with all K
// edges and packs four 8-bit bins into each int32 of a per-chunk VMEM
// accumulator (a Mosaic workaround that caps sum(MAXJ) at 255, a limit the
// wrapper keeps on both devices), plus the packed blocks, DMA windows and
// lane broadcasts. Here the tiles are walked as in K6 (tile_reduce.cu):
// one block of 128 threads per own chunk, each j-chunk staged in shared
// memory. For each pair inside the cutoff a thread finds the first edge
// above dsq by binary search over the edges (ascending, in shared memory)
// and adds 1 to that bin of the block's shared-memory histogram with an
// integer atomic; the caller's prefix sum gives the cumulative counts,
// equal to the K compares for ascending edges. Each block adds its bins to
// the (K,) int64 output with one integer atomic per non-empty bin. Integer
// atomics are exact, so the counts do not depend on their order.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (8 B planes in f64; + the payload plane with a
// mask) plus the window bounds, about 160 MB at n = 1e7 in f32, 48 us at
// 3.35 TB/s. Operations: the half-stencil candidates times 7 FP32
// instructions (13 split), plus a binary search and a shared atomic per
// cutoff pair, so it is bound by operations. This design evaluates every
// lane of every tile in the windows, as K6 does. No single PyTorch call
// computes this function.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false rounds every product
// and sum on its own, as the plain PyTorch version does, so dsq and hence
// the bins match it bitwise on identical inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;  // slots per chunk = threads per block
constexpr int kMaxBands = 5;
constexpr int kMaxDim = 3;
constexpr int kMaxBins = 64;
constexpr int kMaskNone = 0;
constexpr int kMaskSpecies = 1;

template <typename T>
struct Args {
  const T* pos;           // (dim, n) planes
  const float* lo;        // (dim, n) f32 low parts, or null
  const T* pay;           // (n,) payload plane, or null without a mask
  const int32_t* keys;    // (nc_pad * 128,) padded keys
  const int32_t* bounds;  // (nc_pad, 3 S): jlo, toff, jnum per band
  const int32_t* bands;   // (S, 2): lo, hi per band
  const T* edges;         // (K,) ascending squared edges
  int n;
  int dim;
  int S;
  int K;
  int mask;
  T ma, mb;               // the species pair of the mask
  unsigned long long* counts;  // (K,) first-bin counts
};

// Axis a of slot j (< n) from (dim, n) planes; absent axes and slots at or
// past n read 0, which adds exactly 0 to dsq.
template <typename P>
__device__ __forceinline__ P plane_at(const P* planes, int n, int dim, int a,
                                      int j) {
  return (a < dim && j < n) ? planes[static_cast<int64_t>(a) * n + j] : P(0);
}

// The first bin k < K whose edge is above dsq, for dsq < edges[K - 1].
template <typename T>
__device__ __forceinline__ int first_bin_above(const T* edges, int K, T dsq) {
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dsq < edges[mid])
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ bool species_pair(T wi, T wj, T a, T b) {
  return (wi == a && wj == b) || (wi == b && wj == a);
}

template <typename T, bool SPLIT, bool BANDMASK>
__global__ void __launch_bounds__(kChunk) tile_hist_kernel(Args<T> a) {
  __shared__ T sj[kMaxDim][kChunk];
  __shared__ float sl[kMaxDim][SPLIT ? kChunk : 1];
  __shared__ T sw[kChunk];
  __shared__ int32_t sk[kChunk];
  __shared__ T sedges[kMaxBins];
  __shared__ unsigned long long bins[kMaxBins];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  if (t < a.K) {
    sedges[t] = a.edges[t];
    bins[t] = 0ULL;
  }
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
  const bool masked = a.mask != kMaskNone;
  const T own_w = masked && own_real ? a.pay[i] : T(0);
  __syncthreads();
  const T csq = sedges[a.K - 1];
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
      if (masked) sw[t] = j0 + t < a.n ? a.pay[j0 + t] : T(0);
      __syncthreads();
      // lanes at or past n hold no particle
      const int lanes = min(kChunk, a.n - j0);
      for (int q = 0; q < lanes; ++q) {
        T dsq = T(0);
#pragma unroll
        for (int ax = 0; ax < kMaxDim; ++ax) {
          T d = oh[ax] - sj[ax][q];
          if (SPLIT) d = d + (ol[ax] - sl[ax][q]);
          dsq = dsq + d * d;
        }
        bool m = own_real && dsq < csq;
        if (BANDMASK) {
          const long long diff =
              static_cast<long long>(own_key) - static_cast<long long>(sk[q]);
          m = m && diff >= band_lo && diff <= band_hi;
        }
        if (s == 0) m = m && (jc < c || (jc == c && q < t));
        if (m && masked) m = species_pair(own_w, sw[q], a.ma, a.mb);
        if (m) atomicAdd(&bins[first_bin_above(sedges, a.K, dsq)], 1ULL);
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (t < a.K && bins[t] != 0ULL) atomicAdd(&a.counts[t], bins[t]);
}

template <typename T, bool SPLIT>
void launch(const void* pos, const float* lo, const void* pay,
            const int32_t* keys, const int32_t* bounds, const int32_t* bands,
            const void* edges, int n, int dim, int S, int K, int mask,
            double ma, double mb, bool bandmask, unsigned long long* counts,
            cudaStream_t s) {
  Args<T> a;
  a.pos = static_cast<const T*>(pos);
  a.lo = lo;
  a.pay = static_cast<const T*>(pay);
  a.keys = keys;
  a.bounds = bounds;
  a.bands = bands;
  a.edges = static_cast<const T*>(edges);
  a.n = n;
  a.dim = dim;
  a.S = S;
  a.K = K;
  a.mask = mask;
  a.ma = static_cast<T>(ma);
  a.mb = static_cast<T>(mb);
  a.counts = counts;
  const int blocks = (n + kChunk - 1) / kChunk;
  if (bandmask)
    tile_hist_kernel<T, SPLIT, true><<<blocks, kChunk, 0, s>>>(a);
  else
    tile_hist_kernel<T, SPLIT, false><<<blocks, kChunk, 0, s>>>(a);
}

}  // namespace

extern "C" {

// Slots per chunk (threads per block).
int zelll_tile_hist_chunk() { return kChunk; }

// pos: (dim, n) planes, f32 (f64 != 0: f64); lo: (dim, n) f32 low parts or
// null (f32 only); pay: (n,) payload plane in the coordinates' type, or
// null without a mask; keys: the padded (nc_pad * 128,) int32 keys; bounds:
// (nc_pad, 3 S) int32 (jlo, toff, jnum) per band; bands: (S, 2) int32;
// edges: (K,) ascending squared edges in the coordinates' type, K <= 64;
// mask: 0 none, 1 species pair {ma, mb}; counts: (K,) int64 on the device,
// zeroed by the caller, to which the kernel adds each pair's first bin
// above its dsq. Returns cudaGetLastError() after the launch.
int zelll_tile_hist(const void* pos, const void* lo, const void* pay,
                    const void* keys, const void* bounds, const void* bands,
                    const void* edges, int n, int dim, int S, int K, int mask,
                    double ma, double mb, int bandmask, int f64, void* counts,
                    void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands || K < 1 ||
      K > kMaxBins || (mask != kMaskNone && mask != kMaskSpecies) ||
      (mask != kMaskNone && pay == nullptr) || (f64 != 0 && lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* b = static_cast<const int32_t*>(bounds);
  const auto* bd = static_cast<const int32_t*>(bands);
  auto* out = static_cast<unsigned long long*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const bool bm = bandmask != 0;
  if (f64 != 0)
    launch<double, false>(pos, l, pay, k, b, bd, edges, n, dim, S, K, mask, ma,
                          mb, bm, out, s);
  else if (l != nullptr)
    launch<float, true>(pos, l, pay, k, b, bd, edges, n, dim, S, K, mask, ma,
                        mb, bm, out, s);
  else
    launch<float, false>(pos, l, pay, k, b, bd, edges, n, dim, S, K, mask, ma,
                         mb, bm, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
