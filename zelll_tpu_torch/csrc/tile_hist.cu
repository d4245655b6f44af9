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
// mask of ops/rdf.py (keep {w_i, w_j} == {a, b}) over one payload plane,
// or (mask id 2, ops/rdf.py's rdf on the tile path) the periodic keep mask
// rdf._pbc_keep over the shift-sign plane (0 real, +/-1 ghost): (w_i w_j
// == 0) & (w_i + w_j >= 0), each cross-boundary pair once. Its instances
// run under a kernel name of their own, tile_hist_keep_kernel, so the
// open-boundary instances keep their names and code.
//
// The distributed ownership rule (min_islot, tile_pairs.py:534-536;
// parallel/domain.py's sharded_pair_hist) adds tile_hist_islot_kernel, open
// coordinates (f32 and f64) without the band mask or a payload rule,
// min_islot a runtime kernel parameter beside Args: only pairs whose larger
// slot, the lane's own i on the half stencil, is at or above min_islot
// count. As in K6, a lane below it pairs with nothing, a cluster wholly
// below it skips its walk, and the boundary cluster takes its box from its
// owned lanes; the existing instances keep their code (their ISLOT
// branches are discarded at compile time).
//
// What it does not copy: the TPU kernel compares every pair with all K
// edges and packs four 8-bit bins into each int32 of a per-chunk VMEM
// accumulator (a Mosaic workaround that caps sum(MAXJ) at 255, a limit the
// wrapper keeps on both devices), plus the packed blocks, DMA windows and
// lane broadcasts.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (8 B planes in f64; + the payload plane with a
// mask) plus the window bounds, about 160 MB at n = 1e7 in f32, 48 us at
// 3.35 TB/s. Operations: the half-stencil candidates times 7 FP32
// instructions (13 split), plus a binary search over the edges per cutoff
// pair, so it is bound by operations, that is by the instructions issued
// per evaluated lane. No single PyTorch call computes this function.
//
// Design: K6's half-stencil cluster sweep (tile_reduce.cu) on
// cluster_sweep.cuh, with a histogram per hit. A warp owns a cluster of 32
// consecutive slots, i = 128 c + 32 w + lane; the 4 warps of a block share
// chunk c's windows. Each warp
//   1. reduces its cluster's box over the real slots (< n), and in split
//      mode the largest |lo| per axis (f64: the box and the gap in double;
//      ClusterPrune);
//   2. walks the j-chunks of every band window in order, stopping at n
//      (the header's half_stencil_walk, to which the kernel gives
//      its key and payload planes and its sweep through HistSweeper):
//      lane t loads slot t of each of the chunk's 4 clusters and tests the
//      point against the own box; a ballot per cluster compacts the
//      survivors, in slot order, into the warp's buffer in shared memory
//      (x, y, z and a tag w; the low parts in split mode, the key with the
//      band mask, the payload with the species mask). Band 0 stores the
//      slot in w and the other bands -1, so the triangle is one unsigned
//      range test; band 0's j-clusters after the own cluster, which the
//      triangle masks for every lane, are not loaded;
//   3. sweeps the buffer 32 entries at a time: phase A reads each entry by
//      a broadcast and sets the lane's hit bit where the triangle, the band
//      (with the band mask; the buffer is then swept at the end of each
//      band), dsq < edges[K - 1] and the species mask hold; phase B finds
//      the bin of each hit by a binary search over the edges (ascending, in
//      shared memory) and adds 1 to it in the warp's own 32-bit bins in
//      shared memory.
// Every rule of the function stays a lane mask, so the counts are the
// plain version's wherever the windows come from, also where the coverage
// flag is False. At the end each block sums its warps' bins and adds each
// non-empty bin to the (K,) int64 output with one integer atomic; the
// caller's prefix sum gives the cumulative counts, equal to the K compares
// for ascending edges. Integer sums are exact, so the counts do not depend
// on their order. A warp's bin stays below 2^32: at most 32 lanes x
// sum(MAXJ) <= 255 chunks x 128 slots.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false rounds every product
// and sum on its own, as the plain PyTorch version does, so dsq and hence
// the bins match it bitwise on identical inputs, and the prune's bound
// holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"

namespace {

constexpr int kChunk = 128;  // slots per chunk = threads per block
constexpr int kClusters = kChunk / kWarp;  // per chunk: warps per block
// a warp's buffer: a remainder (< one sweep of 32) and a j-chunk's survivors
constexpr int kBuf = kWarp + kChunk;
constexpr int kMaxBands = 5;
constexpr int kMaxDim = 3;
constexpr int kMaxBins = 64;
// The pair masks over the payload plane (lag_pairs._MASK_*): none, the
// species pair, the periodic keep mask
constexpr int kMaskNone = 0;
constexpr int kMaskSpecies = 1;
constexpr int kMaskKeep = 2;

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
  T ma, mb;               // the species pair of the mask
  unsigned long long* counts;  // (K,) first-bin counts
};

// A lane: its own point, low parts, key and payload, and the slots it pairs
// with: entry tag w pairs iff -1 <= w < -1 + span, as unsigned arithmetic
// tests it (band 0's triangle w < i; the other bands carry w = -1). span =
// 0 for a slot at or past n.
template <typename T>
struct HistLane {
  typename Vec4Of<T>::type h;
  float4 l;
  int32_t key;
  unsigned span;
  T w;
};

// What a sweep reads besides the buffers.
template <typename T>
struct SweepArgs {
  T csq;  // edges[K - 1]
  int32_t band_lo, band_hi;
  const T* edges;  // in shared memory
  int K;
  T ma, mb;
  unsigned* bins;  // the warp's bins in shared memory
};

// Phase A of one entry: whether it is a hit of the lane (the triangle, the
// band, dsq < edges[K - 1], the payload plane's mask RULE: the species
// pair or the keep mask).
template <typename T, bool SPLIT, bool BANDMASK, int RULE, typename V>
__device__ __forceinline__ bool hist_hit(const HistLane<T>& o, const V* bh,
                                         const float4* bl, const int32_t* bk,
                                         const T* bp, int q,
                                         const SweepArgs<T>& sa) {
  const V b = bh[q];
  const T dsq = sep_dsq<SPLIT>(o.h, o.l, b,
                               SPLIT ? bl[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  bool m = static_cast<unsigned>(tag_from(b.w) + 1) < o.span && dsq < sa.csq;
  if (BANDMASK) {
    const long long diff = static_cast<long long>(o.key) -
                           static_cast<long long>(bk[q]);
    m = m && diff >= sa.band_lo && diff <= sa.band_hi;
  }
  if (RULE == kMaskSpecies) m = m && species_pair(o.w, bp[q], sa.ma, sa.mb);
  if (RULE == kMaskKeep) m = m && keep_pair_of(o.w, bp[q]);
  return m;
}

// Sweeps entries [0, cnt) of the warp's buffers (cnt <= 32, warp-uniform;
// FULL: cnt == 32, unrolled): phase A sets the lane's hit bits, phase B
// bins each hit, in ascending q.
template <typename T, bool SPLIT, bool BANDMASK, int RULE, bool FULL,
          typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ void hist_sweep(const HistLane<T>& o, const V* bh,
                                           const float4* bl, const int32_t* bk,
                                           const T* bp, int cnt,
                                           const SweepArgs<T>& sa) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  unsigned hits = 0u;
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kWarp; ++q)
      if (hist_hit<T, SPLIT, BANDMASK, RULE>(o, bh, bl, bk, bp, q, sa)) hits |= 1u << q;
  } else {
#pragma unroll 4
    for (int q = 0; q < cnt; ++q)
      if (hist_hit<T, SPLIT, BANDMASK, RULE>(o, bh, bl, bk, bp, q, sa)) hits |= 1u << q;
  }
  while (hits != 0u) {
    const int q = __ffs(static_cast<int>(hits)) - 1;
    hits &= hits - 1u;
    const T dsq = sep_dsq<SPLIT>(o.h, o.l, bh[q], SPLIT ? bl[q] : zero);
    atomicAdd(&sa.bins[first_bin_above(sa.edges, sa.K, dsq)], 1u);
  }
}

// What the half-stencil walk of cluster_sweep.cuh asks of K9: the band,
// the key (band mask) and payload (the species or keep mask) planes beside
// the coordinates, and the sweep.
template <typename T, bool SPLIT, bool BANDMASK, int RULE,
          typename V = typename Vec4Of<T>::type>
struct HistSweeper {
  const Args<T>& a;
  const HistLane<T>& o;
  const V* bh;
  const float4* bl;
  int32_t* bk;
  T* bp;
  SweepArgs<T>& sa;
  __device__ __forceinline__ void band(int32_t lo, int32_t hi) {
    sa.band_lo = lo;
    sa.band_hi = hi;
  }
  __device__ __forceinline__ void store(int at, int j) {
    if (BANDMASK) bk[at] = a.keys[j];
    if (RULE != kMaskNone) bp[at] = a.pay[j];
  }
  template <bool FULL>
  __device__ __forceinline__ void sweep(int at, int cnt) {
    hist_sweep<T, SPLIT, BANDMASK, RULE, FULL>(o, bh + at, bl + at, bk + at, bp + at, cnt,
                                               sa);
  }
  __device__ __forceinline__ void shift(int done, int cnt, int lane) {
    if (BANDMASK) shift_front<1, false>(bk, bk, done, cnt, lane);
    if (RULE != kMaskNone) shift_front<1, false>(bp, bp, done, cnt, lane);
  }
};

// The kernel's body: RULE is the payload plane's mask.
// min_islot: the ownership rule's first owned slot (ISLOT)
template <typename T, bool SPLIT, bool BANDMASK, int RULE, bool ISLOT = false>
__device__ __forceinline__ void tile_hist_body(const Args<T>& a, int min_islot = 0) {
  using V = typename Vec4Of<T>::type;
  __shared__ V buf_hi[kClusters][kBuf];
  __shared__ float4 buf_lo[kClusters][SPLIT ? kBuf : 1];
  __shared__ int32_t buf_key[kClusters][BANDMASK ? kBuf : 1];
  __shared__ T buf_pay[kClusters][RULE != kMaskNone ? kBuf : 1];
  __shared__ T sedges[kMaxBins];
  __shared__ unsigned bins[kClusters][kMaxBins];
  const int c = blockIdx.x;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int k = threadIdx.x; k < kClusters * kMaxBins; k += kChunk)
    bins[k / kMaxBins][k % kMaxBins] = 0u;
  if (threadIdx.x < a.K) sedges[threadIdx.x] = a.edges[threadIdx.x];
  const int base = c * kChunk + w * kWarp;  // the own cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  // the lanes whose pairs count: the real ones, and with ISLOT those at or
  // above min_islot (the lane's i is the larger slot of each of its pairs)
  bool own = real;
  if constexpr (ISLOT) own = own && i >= min_islot;
  V* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  int32_t* bk = buf_key[w];
  T* bp = buf_pay[w];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  HistLane<T> o;
  o.h = real ? load_point(a.pos, a.n, a.dim, i, 0) : vzero;
  o.l = SPLIT && real ? load_point(a.lo, a.n, a.dim, i, 0) : zero;
  o.key = a.keys[i];  // keys cover every launched chunk
  o.span = own ? static_cast<unsigned>(i) + 1u : 0u;
  o.w = RULE != kMaskNone && real ? a.pay[i] : T(0);
  __syncthreads();
  SweepArgs<T> sa{sedges[a.K - 1], 0, 0, sedges, a.K, a.ma, a.mb, bins[w]};
  // a cluster past n holds no particle, nor (ISLOT) one wholly below
  // min_islot any owned one: its warp only joins the fold
  bool live = base < a.n;
  if constexpr (ISLOT) live = live && base + kWarp > min_islot;
  if (live) {
    const ClusterPrune<T, SPLIT> prune(o.h, o.l, own, sa.csq);
    HistSweeper<T, SPLIT, BANDMASK, RULE> sw{a, o, bh, bl, bk, bp, sa};
    half_stencil_walk<kClusters, SPLIT, BANDMASK>(a, c, base, lane, prune, bh, bl, sw);
  }
  __syncthreads();
  if (threadIdx.x < a.K) {
    unsigned long long sum = 0ULL;
#pragma unroll
    for (int k = 0; k < kClusters; ++k) sum += bins[k][threadIdx.x];
    if (sum != 0ULL) atomicAdd(&a.counts[threadIdx.x], sum);
  }
}

// The open-boundary instances: no mask, or the species mask
template <typename T, bool SPLIT, bool BANDMASK, bool MASK>
__global__ void __launch_bounds__(kChunk) tile_hist_kernel(Args<T> a) {
  tile_hist_body<T, SPLIT, BANDMASK, MASK ? kMaskSpecies : kMaskNone>(a);
}

// The periodic instances: the keep mask over the payload plane, under a
// kernel name of their own, so the instances above keep their code
template <typename T, bool SPLIT, bool BANDMASK>
__global__ void __launch_bounds__(kChunk) tile_hist_keep_kernel(Args<T> a) {
  tile_hist_body<T, SPLIT, BANDMASK, kMaskKeep>(a);
}

// The distributed instances (ISLOT): open coordinates, no band mask or
// payload rule, min_islot a runtime parameter beside Args
template <typename T>
__global__ void __launch_bounds__(kChunk) tile_hist_islot_kernel(Args<T> a, int min_islot) {
  tile_hist_body<T, false, false, kMaskNone, true>(a, min_islot);
}

template <typename T, bool SPLIT, bool BANDMASK>
void launch_mask(const Args<T>& a, int mask, int blocks, cudaStream_t s) {
  if (mask == kMaskKeep)
    tile_hist_keep_kernel<T, SPLIT, BANDMASK><<<blocks, kChunk, 0, s>>>(a);
  else if (mask == kMaskSpecies)
    tile_hist_kernel<T, SPLIT, BANDMASK, true><<<blocks, kChunk, 0, s>>>(a);
  else
    tile_hist_kernel<T, SPLIT, BANDMASK, false><<<blocks, kChunk, 0, s>>>(a);
}

template <typename T, bool SPLIT>
void launch(const void* pos, const float* lo, const void* pay,
            const int32_t* keys, const int32_t* bounds, const int32_t* bands,
            const void* edges, int n, int dim, int S, int K, int mask,
            double ma, double mb, bool bandmask, unsigned long long* counts,
            int min_islot, cudaStream_t s) {
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
  a.ma = static_cast<T>(ma);
  a.mb = static_cast<T>(mb);
  a.counts = counts;
  const int blocks = (n + kChunk - 1) / kChunk;
  if (min_islot != 0)
    tile_hist_islot_kernel<T><<<blocks, kChunk, 0, s>>>(a, min_islot);
  else if (bandmask)
    launch_mask<T, SPLIT, true>(a, mask, blocks, s);
  else
    launch_mask<T, SPLIT, false>(a, mask, blocks, s);
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
// mask: 0 none, 1 species pair {ma, mb}, 2 the periodic keep mask
// (lag_pairs.pbc_keep; pay the shift signs); counts: (K,) int64 on the device,
// zeroed by the caller, to which the kernel adds each pair's first bin
// above its dsq. min_islot != 0 counts only the pairs whose larger slot is
// at or above it (the distributed ownership rule; no lo, no band mask,
// mask 0). Returns cudaGetLastError() after the launch.
int zelll_tile_hist(const void* pos, const void* lo, const void* pay,
                    const void* keys, const void* bounds, const void* bands,
                    const void* edges, int n, int dim, int S, int K, int mask,
                    double ma, double mb, int bandmask, int f64, void* counts,
                    void* stream, int min_islot) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands || K < 1 ||
      K > kMaxBins || mask < kMaskNone || mask > kMaskKeep ||
      (mask != kMaskNone && pay == nullptr) || (f64 != 0 && lo != nullptr) ||
      (min_islot != 0 && (lo != nullptr || bandmask != 0 || mask != kMaskNone)))
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
                          mb, bm, out, min_islot, s);
  else if (l != nullptr)
    launch<float, true>(pos, l, pay, k, b, bd, edges, n, dim, S, K, mask, ma,
                        mb, bm, out, 0, s);
  else
    launch<float, false>(pos, l, pay, k, b, bd, edges, n, dim, S, K, mask, ma,
                         mb, bm, out, min_islot, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
