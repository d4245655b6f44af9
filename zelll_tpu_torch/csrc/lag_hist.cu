// K5 on Hopper: the cumulative pair-distance histogram over the lag window
// of key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/pallas_pairs.py::_make_hist_kernel
// (:1314, via pair_lag_hist). It computes the same function:
//
//   count_k = #{slots i, lags 1..L, j = i - lag >= 0 :
//               key_j >= key_i - W       (candidate key window)
//               dsq < edges[K - 1]       (the cutoff is the last edge)
//               mask(w_i, w_j)           (optional payload pair mask)
//               dsq < edges[k]}          (strict, per edge)
//
// for k < K, with dsq accumulated axis by axis, and in split mode each
// axis' separation d = (hi_i - hi_j) + (lo_i - lo_j); the bins see the
// f32 dsq of the split separations, as in K1 and the TPU kernel. There is
// no dsq > 0 test: coincident pairs count in every bin whose edge is above
// 0, as in the reference. Masks: none, or the species pair mask of
// ops/rdf.py (keep {w_i, w_j} == {a, b}) over one payload plane; mask id 2
// is left for the periodic keep mask.
//
// What it does not copy: the TPU kernel compares every pair with all K
// edges and adds K int32 planes of a revisited VMEM block. Here one thread
// owns one sorted slot i and walks its lags as K1 does (lag_reduce.cu). For
// each pair it finds the first edge above dsq by binary search over the
// edges (ascending, staged in shared memory) and adds 1 to that bin of a
// per-block shared-memory histogram with an integer atomic; a prefix sum
// over the bins on the caller's side gives the cumulative counts, equal to
// the K compares for ascending edges. Integer atomics are exact, so the
// counts do not depend on the order of the additions. Each block adds its
// bins to the (K,) int64 output with one integer atomic per non-empty bin:
// no bin wraps below 2^63.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (+ the payload plane with a mask; f64 planes
// are 8 B), 160-280 MB at n = 1e7, 48-84 us at 3.35 TB/s. Operations: K1's
// 7 (13 split) FP32 instructions per lag-window candidate, plus the binary
// search (log2 K compares) and the shared atomic per cutoff pair, so it is
// bound by operations. The shared histogram keeps every per-pair update
// on chip; a histogram of K = 32 bins takes 256 + 128 bytes of shared
// memory per block. Register pressure does not grow with K. No single
// PyTorch call computes this function (torch.histc and torch.bincount
// take the distances, which the fused pass never stores).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false rounds every product
// and sum on its own, as the plain PyTorch version does, so dsq and hence
// the bins match it bitwise on identical sorted inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxDim = 3;
constexpr int kMaxBins = 2048;
constexpr int kMaskNone = 0;
constexpr int kMaskSpecies = 1;
constexpr int32_t kSentinelKey = 2147483647;  // INT32_MAX
constexpr int32_t kPadKeyBase = kSentinelKey / 2;

// A padding row's key is replaced by kPadKeyBase + slot * spacing, where
// spacing <= (INT32_MAX - kPadKeyBase - 1) / n keeps it below int32 overflow.
__device__ __forceinline__ int32_t load_key(const int32_t* __restrict__ keys,
                                            int slot, int spacing) {
  const int32_t k = keys[slot];
  return k == kSentinelKey ? kPadKeyBase + slot * spacing : k;
}

// The first bin k < K whose edge is above dsq, for dsq < edges[K - 1]:
// the pair counts in bins k .. K - 1 of the cumulative histogram.
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

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(kBlock)
lag_hist_kernel(const T* __restrict__ pos, const float* __restrict__ lo,
                const T* __restrict__ pay, const int32_t* __restrict__ keys,
                const int32_t* __restrict__ w_key, const T* __restrict__ edges,
                int n, int dim, int L, int spacing, int K, int mask, T ma,
                T mb, unsigned long long* __restrict__ counts) {
  // K bin counters, then the K edges
  extern __shared__ unsigned long long smem[];
  unsigned long long* bins = smem;
  T* sedges = reinterpret_cast<T*>(smem + K);
  const int t = threadIdx.x;
  for (int k = t; k < K; k += kBlock) {
    bins[k] = 0ULL;
    sedges[k] = edges[k];
  }
  __syncthreads();
  const T csq = sedges[K - 1];
  const int i = blockIdx.x * kBlock + t;
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
    const T own_w = mask != kMaskNone ? pay[i] : T(0);
    const int jmin = i > L ? i - L : 0;
    for (int j = i - 1; j >= jmin; --j) {
      if (load_key(keys, j, spacing) < lo_key) break;
      const int64_t jo = static_cast<int64_t>(j) * dim;
      T dsq = T(0);
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) {
        if (a < dim) {
          T d = own[a] - pos[jo + a];
          if (SPLIT) d = d + (own_lo[a] - lo[jo + a]);
          dsq = dsq + d * d;
        }
      }
      if (!(dsq < csq)) continue;
      if (mask == kMaskSpecies && !species_pair(own_w, pay[j], ma, mb))
        continue;
      atomicAdd(&bins[first_bin_above(sedges, K, dsq)], 1ULL);
    }
  }
  __syncthreads();
  for (int k = t; k < K; k += kBlock)
    if (bins[k] != 0ULL) atomicAdd(&counts[k], bins[k]);
}

template <typename T, bool SPLIT>
void launch(const void* pos, const float* lo, const void* pay,
            const int32_t* keys, const int32_t* w_key, const void* edges,
            int n, int dim, int L, int spacing, int K, int mask, double ma,
            double mb, unsigned long long* counts, cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  const size_t shared = static_cast<size_t>(K) * (sizeof(unsigned long long) + sizeof(T));
  lag_hist_kernel<T, SPLIT><<<blocks, kBlock, shared, stream>>>(
      static_cast<const T*>(pos), lo, static_cast<const T*>(pay), keys, w_key,
      static_cast<const T*>(edges), n, dim, L, spacing, K, mask,
      static_cast<T>(ma), static_cast<T>(mb), counts);
}

}  // namespace

extern "C" {

// The largest bin count K the kernel takes (its shared-memory histogram).
int zelll_lag_hist_max_bins() { return kMaxBins; }

// pos: (n, dim) row-major f32 (f64 != 0: f64); lo: (n, dim) f32 low parts
// or null (f32 only); pay: (n,) payload plane in the coordinates' type, or
// null without a mask; keys: (n,) int32 ascending, SENTINEL_KEY rows last;
// w_key: one int32 on the device; edges: (K,) ascending squared edges in
// the coordinates' type on the device; mask: 0 none, 1 species pair
// {ma, mb}; counts: (K,) int64 on the device, zeroed by the caller, to
// which the kernel adds each pair's first bin above its dsq. Returns
// cudaGetLastError() after the launch.
int zelll_lag_hist(const void* pos, const void* lo, const void* pay,
                   const void* keys, const void* w_key, const void* edges,
                   int n, int dim, int L, int spacing, int K, int mask,
                   double ma, double mb, int f64, void* counts, void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || L < 1 || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      K < 1 || K > kMaxBins || (mask != kMaskNone && mask != kMaskSpecies) ||
      (mask != kMaskNone && pay == nullptr) || (f64 != 0 && lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* w = static_cast<const int32_t*>(w_key);
  auto* out = static_cast<unsigned long long*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (f64 != 0)
    launch<double, false>(pos, l, pay, k, w, edges, n, dim, L, spacing, K,
                          mask, ma, mb, out, s);
  else if (l != nullptr)
    launch<float, true>(pos, l, pay, k, w, edges, n, dim, L, spacing, K, mask,
                        ma, mb, out, s);
  else
    launch<float, false>(pos, l, pay, k, w, edges, n, dim, L, spacing, K,
                         mask, ma, mb, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
