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
// ops/rdf.py (keep {w_i, w_j} == {a, b}) over one payload plane.
//
// Periodic boxes (ops/rdf.py's rdf) add instances under a new kernel name,
// lag_hist_pbc_kernel, with the periodic arguments as a second kernel
// parameter (Periodic), so the open-boundary instances keep their names
// and code:
//   KEEP (mask ids 2 and 3): the periodic keep mask rdf._pbc_keep over the
//     shift-sign plane (0 real, +/-1 ghost, in the coordinates' type), read
//     into a buffer of its own for survivors of the prune; mask id 3
//     composes it with the species mask over the payload plane
//     (rdf._pbc_species_mask, two planes), each a lane mask of phase A.
//   MI (f32 and split): in-kernel minimum image, as in K4 (mi_axis per
//     axis, the widened key window, ClusterPruneMi's prune); the bins see
//     the folded separations, the image distances.
//
// The distributed ownership rule (min_islot, pallas_pairs.py:1430-1529;
// parallel/domain.py's sharded_pair_hist) adds lag_hist_islot_kernel, open
// coordinates (f32 and f64) without a mask, min_islot a runtime kernel
// parameter beside Args: only pairs whose larger slot, the lane's own i,
// is at or above min_islot count. As in K1, a lane below it pairs with
// nothing, a cluster wholly below it skips its walk, and the boundary
// cluster takes its box and union range from its owned lanes. It is a
// kernel of its own, so the existing kernels keep their code.
//
// What it does not copy: the TPU kernel compares every pair with all K
// edges and adds K int32 planes of a revisited VMEM block. Here each pair
// goes to the first edge above its dsq, found by a binary search over the
// edges in shared memory, and a prefix sum over the bins on the caller's
// side gives the cumulative counts, equal to the K compares for ascending
// edges. The TPU kernel's rolling window, lane rolls and tail padding are
// Mosaic devices; the index bound j >= 0 and the padding-key rule of K1
// (padding rows read as spaced keys above every real key) replace them.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (+ the payload plane with a mask; f64 planes
// are 8 B), 160-280 MB at n = 1e7, 48-84 us at 3.35 TB/s. Operations: K1's
// 7 (13 split) FP32 instructions per lag-window candidate, plus per cutoff
// pair the binary search (log2 K compares) and a shared atomic, so it is
// bound by operations, that is by the instructions issued per evaluated
// lane. A thread that walked its own lags would issue scalar global loads
// that no other lane shares, run its warp to the longest walk and evaluate
// every candidate, and one shared histogram per block would take every
// cutoff pair's atomic. No single PyTorch
// call computes this function (torch.histc and torch.bincount take the
// distances, which the fused pass never stores).
//
// Design: K1's one-sided cluster sweep (lag_reduce.cu) on cluster_sweep.cuh,
// with K9's histogram per hit (tile_hist.cu). Lane i's partners are the
// slots [jlo_i, i - 1], where jlo_i, found by binary search over the keys,
// is the larger of i - L and the first slot with key_j >= key_i - W: keys
// ascend, so that is exactly the set of lags 1..L in the key window. A warp
// owns a cluster of 32 consecutive slots and keeps its own coordinates,
// payload and range in registers; the 4 warps of a block share only the
// edges and the final sum of their bins. Each warp
//   1. reduces its cluster's box over the real slots (< n), and in split
//      mode the largest |lo| per axis (f64: the box and the gap in double;
//      ClusterPrune);
//   2. walks the union of its lanes' ranges, [jlo of its first slot, its
//      last real slot - 1] (jlo ascends with i; the header's
//      one_sided_walk, which K5 gives its payload plane and its sweep
//      through HistSweeper): lane t loads row j0 + t of
//      the (n, dim) array and tests the point against the own box with the
//      threshold edges[K - 1]; a ballot compacts the survivors, in slot
//      order, into the warp's buffer in shared memory (x, y, z and the slot;
//      the low parts in split mode; the payload, read for survivors only,
//      with the species mask);
//   3. sweeps the buffer 32 entries at a time: phase A reads each entry by
//      a broadcast and sets the lane's hit bit where jlo_i <= j < i (one
//      unsigned range test), dsq < edges[K - 1] and the species mask hold;
//      phase B finds the bin of each hit by a binary search over the edges
//      and adds 1 to it in the warp's own 32-bit bins in shared memory.
// The prune drops no pair that counts (cluster_sweep.cuh says why; the
// split threshold is a superset of the strict f32 rule), and
// ops/cluster_prune.py's lag_cluster_entries(half=True) counts these
// entries, as it does K1's (tests/test_torch_prune.py holds it to brute
// force). Every rule of the function stays a lane mask, so the counts are
// the plain version's wherever the lag bound binds. At the end each block
// sums its warps' bins and adds each non-empty bin to the (K,) int64 output
// with one integer atomic; integer sums are exact, so the counts do not
// depend on their order. A warp's bin stays below 2^32: at most 32 lanes x
// min(L, n) partners, and the C interface refuses min(L, n) >= 2^27. The
// K <= 2048 edges and 4 x K bins (32 KB at K = 2048) are dynamic shared
// memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false rounds every product
// and sum on its own, as the plain PyTorch version does, so dsq and hence
// the bins match it bitwise on identical sorted inputs, and the prune's
// bound holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / kWarp;
constexpr int kBuf = 2 * kWarp;  // a warp's buffer: a sweep + a cluster
constexpr int kMaxDim = 3;
constexpr int kMaxBins = 2048;
constexpr int kMaxLag = 1 << 27;  // 32 x min(L, n) partners fit a 32-bit bin
constexpr size_t kDefaultDynShared = 32 << 10;  // launches without an opt-in
// The pair masks (lag_pairs._MASK_*): none, the species pair, the periodic
// keep mask, and both (two planes)
constexpr int kMaskNone = 0;
constexpr int kMaskSpecies = 1;
constexpr int kMaskKeep = 2;
constexpr int kMaskKeepSpecies = 3;

template <typename T>
struct Args {
  const T* pos;           // (n, dim) row-major
  const float* lo;        // (n, dim) f32 low parts, or null
  const T* pay;           // (n,) payload plane, or null without a mask
  const int32_t* keys;    // (n,) ascending, SENTINEL_KEY rows last
  const int32_t* w_key;   // one int32 on the device
  const T* edges;         // (K,) ascending squared edges
  int n;
  int dim;
  int L;
  int spacing;
  int K;
  T ma, mb;               // the species pair of the mask
  unsigned long long* counts;  // (K,) first-bin counts
};

// A lane: its own point, low parts and payload, and the slots it pairs
// with, jlo <= j < jlo + span as unsigned arithmetic tests it (span = 0 for
// a slot at or past n).
template <typename T>
struct HistLane {
  typename Vec4Of<T>::type h;
  float4 l;
  int jlo;
  unsigned span;
  T w;
};

// What a sweep reads besides the buffers.
template <typename T>
struct SweepArgs {
  T csq;  // edges[K - 1]
  const T* edges;  // in shared memory
  int K;
  T ma, mb;
  unsigned* bins;  // the warp's bins in shared memory
};

// Sweeps entries [0, cnt) of the warp's buffers (cnt <= 32, warp-uniform;
// FULL: cnt == 32, unrolled): phase A sets the lane's hit bits (the lag
// range, dsq < edges[K - 1], the species mask, with KEEP the keep mask of
// the lane's and the entry's shift signs pl->pw and bw[q]), phase B bins
// each hit, in ascending q. MI folds each separation to its minimum image
// (pl->mib).
template <typename T, bool SPLIT, bool MASK, bool FULL, bool KEEP = false, bool MI = false,
          typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ void hist_sweep(const HistLane<T>& o, const V* bh,
                                           const float4* bl, const T* bp, int cnt,
                                           const SweepArgs<T>& sa,
                                           const PbcLane<T>* pl = nullptr,
                                           const T* bw = nullptr) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  unsigned hits = 0u;
  auto hit = [&](int q) {
    const V b = bh[q];
    const T dsq = sep_dsq_pbc<SPLIT, MI>(o.h, o.l, b, SPLIT ? bl[q] : zero, pl);
    bool m = static_cast<unsigned>(tag_from(b.w) - o.jlo) < o.span && dsq < sa.csq;
    if constexpr (KEEP) m = m && keep_pair_of(pl->pw, bw[q]);
    if (MASK) m = m && species_pair(o.w, bp[q], sa.ma, sa.mb);
    if (m) hits |= 1u << q;
  };
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kWarp; ++q) hit(q);
  } else {
#pragma unroll 4
    for (int q = 0; q < cnt; ++q) hit(q);
  }
  while (hits != 0u) {
    const int q = __ffs(static_cast<int>(hits)) - 1;
    hits &= hits - 1u;
    const T dsq = sep_dsq_pbc<SPLIT, MI>(o.h, o.l, bh[q], SPLIT ? bl[q] : zero, pl);
    atomicAdd(&sa.bins[first_bin_above(sa.edges, sa.K, dsq)], 1u);
  }
}

// What the one-sided walk of cluster_sweep.cuh asks of K5: the payload
// plane beside the coordinates (species mask) and the keep plane (KEEP),
// read for survivors only, and the sweep.
template <typename T, bool SPLIT, bool MASK, bool KEEP = false, bool MI = false,
          typename V = typename Vec4Of<T>::type>
struct HistSweeper {
  const HistLane<T>& o;
  const V* bh;
  const float4* bl;
  T* bp;
  const T* pay;
  const SweepArgs<T>& sa;
  const PbcLane<T>* pl = nullptr;
  T* bw = nullptr;
  const T* w = nullptr;
  __device__ __forceinline__ void store(int at, int j) {
    if (MASK) bp[at] = pay[j];
    if constexpr (KEEP) bw[at] = w[j];
  }
  template <bool FULL>
  __device__ __forceinline__ void sweep(int at, int cnt) {
    if constexpr (KEEP || MI)
      hist_sweep<T, SPLIT, MASK, FULL, KEEP, MI>(o, bh + at, bl + at, bp + at, cnt, sa, pl,
                                                 KEEP ? bw + at : nullptr);
    else
      hist_sweep<T, SPLIT, MASK, FULL>(o, bh + at, bl + at, bp + at, cnt, sa);
  }
  __device__ __forceinline__ void shift(int done, int cnt, int lane) {
    if (MASK) shift_front<1, false>(bp, bp, done, cnt, lane);
    if constexpr (KEEP) shift_front<1, false>(bw, bw, done, cnt, lane);
  }
};

// The open-boundary instances
template <typename T, bool SPLIT, bool MASK>
__global__ void __launch_bounds__(kBlock) lag_hist_kernel(Args<T> a) {
  using V = typename Vec4Of<T>::type;
  __shared__ V buf_hi[kWarps][kBuf];
  __shared__ float4 buf_lo[kWarps][SPLIT ? kBuf : 1];
  __shared__ T buf_pay[kWarps][MASK ? kBuf : 1];
  // the K edges, then each warp's K bins
  extern __shared__ double dyn[];
  T* sedges = reinterpret_cast<T*>(dyn);
  unsigned* bins = reinterpret_cast<unsigned*>(sedges + a.K);
  for (int k = threadIdx.x; k < a.K; k += kBlock) sedges[k] = a.edges[k];
  for (int k = threadIdx.x; k < kWarps * a.K; k += kBlock) bins[k] = 0u;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = blockIdx.x * kBlock + w * kWarp;  // the cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  V* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  T* bp = buf_pay[w];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  HistLane<T> o;
  o.h = real ? load_row(a.pos, a.dim, i, 0) : vzero;
  o.l = SPLIT && real ? load_row(a.lo, a.dim, i, 0) : zero;
  o.w = MASK && real ? a.pay[i] : T(0);
  // the lane's partners [jlo, i - 1]: the smallest j in [max(i - L, 0), i]
  // with key_j >= key_i - W (j = i holds), by binary search over the keys
  int jlo = i;
  if (real) {
    const int32_t lo_key = load_key(a.keys, i, a.spacing) - *a.w_key;
    int l = i > a.L ? i - a.L : 0, r = i;
    while (l < r) {
      const int m = l + (r - l) / 2;
      if (load_key(a.keys, m, a.spacing) >= lo_key) r = m; else l = m + 1;
    }
    jlo = l;
  }
  o.jlo = jlo;
  o.span = real ? static_cast<unsigned>(i - jlo) : 0u;
  __syncthreads();
  SweepArgs<T> sa{sedges[a.K - 1], sedges, a.K, a.ma, a.mb, bins + w * a.K};
  // a cluster past n holds no particle: its warp only joins the final sum
  if (base < a.n) {
    // the union of the lanes' ranges: jlo ascends with i
    const int first = __shfl_sync(kAll, jlo, 0);
    const int last = min(base + kWarp, a.n) - 2;  // the last real slot - 1
    const ClusterPrune<T, SPLIT> prune(o.h, o.l, real, sa.csq);
    HistSweeper<T, SPLIT, MASK> sw{o, bh, bl, bp, a.pay, sa};
    one_sided_walk<SPLIT>(a.pos, a.lo, a.dim, first, last, lane, prune, bh, bl, sw);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.K; k += kBlock) {
    unsigned long long sum = 0ULL;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) sum += bins[v * a.K + k];
    if (sum != 0ULL) atomicAdd(&a.counts[k], sum);
  }
}

// The periodic instances: the keep mask (alone or with the species mask),
// the minimum image (f32 and split), or both; p beside Args. The kernel
// above's body, with the keep plane's buffer, the lane's shift sign and
// box, and the minimum-image prune: a body shared by both kernels moved the
// open instances' SASS (chip_compare.py sass), so each keeps its own.
// The distributed instances: lag_hist_kernel<T, false, false> with the
// ownership rule, pairs counted only where the lane's i (their larger slot)
// is at or above min_islot
template <typename T>
__global__ void __launch_bounds__(kBlock) lag_hist_islot_kernel(Args<T> a, int min_islot) {
  using V = typename Vec4Of<T>::type;
  __shared__ V buf_hi[kWarps][kBuf];
  __shared__ float4 buf_lo[kWarps][1];
  __shared__ T buf_pay[kWarps][1];
  // the K edges, then each warp's K bins
  extern __shared__ double dyn[];
  T* sedges = reinterpret_cast<T*>(dyn);
  unsigned* bins = reinterpret_cast<unsigned*>(sedges + a.K);
  for (int k = threadIdx.x; k < a.K; k += kBlock) sedges[k] = a.edges[k];
  for (int k = threadIdx.x; k < kWarps * a.K; k += kBlock) bins[k] = 0u;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = blockIdx.x * kBlock + w * kWarp;  // the cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  const bool own = real && i >= min_islot;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  HistLane<T> o;
  o.h = own ? load_row(a.pos, a.dim, i, 0) : vzero;
  o.l = zero;
  o.w = T(0);
  // the lane's partners [jlo, i - 1], as in lag_hist_kernel
  int jlo = i;
  if (own) {
    const int32_t lo_key = load_key(a.keys, i, a.spacing) - *a.w_key;
    int r = i;
    jlo = i > a.L ? i - a.L : 0;
    while (jlo < r) {
      const int m = jlo + (r - jlo) / 2;
      if (load_key(a.keys, m, a.spacing) >= lo_key) r = m; else jlo = m + 1;
    }
  }
  o.jlo = jlo;
  o.span = own ? static_cast<unsigned>(i - jlo) : 0u;
  __syncthreads();
  SweepArgs<T> sa{sedges[a.K - 1], sedges, a.K, a.ma, a.mb, bins + w * a.K};
  // a cluster past n, or wholly below min_islot, only joins the final sum
  if (base < a.n && base + kWarp > min_islot) {
    // the union of the owned lanes' ranges starts at the first owned lane's
    const int first = __shfl_sync(kAll, jlo, max(min_islot - base, 0));
    const int last = min(base + kWarp, a.n) - 2;
    const ClusterPrune<T, false> prune(o.h, o.l, own, sa.csq);
    HistSweeper<T, false, false> sw{o, buf_hi[w], buf_lo[w], buf_pay[w], a.pay, sa};
    one_sided_walk<false>(a.pos, a.lo, a.dim, first, last, lane, prune, buf_hi[w],
                          buf_lo[w], sw);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.K; k += kBlock) {
    unsigned long long sum = 0ULL;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) sum += bins[v * a.K + k];
    if (sum != 0ULL) atomicAdd(&a.counts[k], sum);
  }
}

template <typename T, bool SPLIT, bool MASK, bool KEEP, bool MI>
__global__ void __launch_bounds__(kBlock) lag_hist_pbc_kernel(Args<T> a, Periodic<T> p) {
  using V = typename Vec4Of<T>::type;
  __shared__ V buf_hi[kWarps][kBuf];
  __shared__ float4 buf_lo[kWarps][SPLIT ? kBuf : 1];
  __shared__ T buf_pay[kWarps][MASK ? kBuf : 1];
  __shared__ T buf_w[kWarps][KEEP ? kBuf : 1];
  // the K edges, then each warp's K bins
  extern __shared__ double dyn[];
  T* sedges = reinterpret_cast<T*>(dyn);
  unsigned* bins = reinterpret_cast<unsigned*>(sedges + a.K);
  for (int k = threadIdx.x; k < a.K; k += kBlock) sedges[k] = a.edges[k];
  for (int k = threadIdx.x; k < kWarps * a.K; k += kBlock) bins[k] = 0u;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = blockIdx.x * kBlock + w * kWarp;  // the cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  HistLane<T> o;
  o.h = real ? load_row(a.pos, a.dim, i, 0) : vzero;
  o.l = SPLIT && real ? load_row(a.lo, a.dim, i, 0) : zero;
  o.w = MASK && real ? a.pay[i] : T(0);
  const PbcLane<T> pl{KEEP && real ? p.w[i] : T(0), p.mib, p.mibl};
  // the lane's partners [jlo, i - 1], as above (the window W widened by the
  // caller for the minimum image)
  int jlo = i;
  if (real) {
    const int32_t lo_key = load_key(a.keys, i, a.spacing) - *a.w_key;
    int r = i;
    jlo = i > a.L ? i - a.L : 0;
    while (jlo < r) {
      const int m = jlo + (r - jlo) / 2;
      if (load_key(a.keys, m, a.spacing) >= lo_key) r = m; else jlo = m + 1;
    }
  }
  o.jlo = jlo;
  o.span = real ? static_cast<unsigned>(i - jlo) : 0u;
  __syncthreads();
  SweepArgs<T> sa{sedges[a.K - 1], sedges, a.K, a.ma, a.mb, bins + w * a.K};
  if (base < a.n) {
    const int first = __shfl_sync(kAll, jlo, 0);
    const int last = min(base + kWarp, a.n) - 2;
    HistSweeper<T, SPLIT, MASK, KEEP, MI> sw{o, buf_hi[w], buf_lo[w], buf_pay[w], a.pay, sa,
                                             &pl, buf_w[w], p.w};
    if constexpr (MI) {
      const ClusterPruneMi<SPLIT> prune(o.h, o.l, real, sa.csq, p.mib);
      one_sided_walk<SPLIT>(a.pos, a.lo, a.dim, first, last, lane, prune, buf_hi[w],
                            buf_lo[w], sw);
    } else {
      const ClusterPrune<T, SPLIT> prune(o.h, o.l, real, sa.csq);
      one_sided_walk<SPLIT>(a.pos, a.lo, a.dim, first, last, lane, prune, buf_hi[w],
                            buf_lo[w], sw);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.K; k += kBlock) {
    unsigned long long sum = 0ULL;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) sum += bins[v * a.K + k];
    if (sum != 0ULL) atomicAdd(&a.counts[k], sum);
  }
}

// Launches kernel with the dynamic shared memory of K edges and 4 x K bins.
template <typename T, typename Kernel, typename... P>
int launch_kernel(Kernel kernel, const Args<T>& a, cudaStream_t s, const P&... extra) {
  const int blocks = (a.n + kBlock - 1) / kBlock;
  const size_t shared = static_cast<size_t>(a.K) * (sizeof(T) + kWarps * sizeof(unsigned));
  if (shared > kDefaultDynShared) {
    // past the default 48 KB of a block with the buffers (up to 10 KB)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kBlock, shared, s>>>(a, extra...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SPLIT, bool MASK>
int launch_rule(const Args<T>& a, const Periodic<T>& p, bool keep, bool mi, cudaStream_t s) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (keep && mi) return launch_kernel(lag_hist_pbc_kernel<T, SPLIT, MASK, true, true>, a, s, p);
    if (mi) return launch_kernel(lag_hist_pbc_kernel<T, SPLIT, MASK, false, true>, a, s, p);
  }
  if (keep) return launch_kernel(lag_hist_pbc_kernel<T, SPLIT, MASK, true, false>, a, s, p);
  return launch_kernel(lag_hist_kernel<T, SPLIT, MASK>, a, s);
}

template <typename T, bool SPLIT>
int launch(const void* pos, const float* lo, const void* pay,
           const int32_t* keys, const int32_t* w_key, const void* edges, int n,
           int dim, int L, int spacing, int K, int mask, double ma, double mb,
           unsigned long long* counts, const Periodic<T>& p, bool mi, int min_islot,
           cudaStream_t s) {
  Args<T> a;
  a.pos = static_cast<const T*>(pos);
  a.lo = lo;
  a.pay = static_cast<const T*>(pay);
  a.keys = keys;
  a.w_key = w_key;
  a.edges = static_cast<const T*>(edges);
  a.n = n;
  a.dim = dim;
  a.L = L;
  a.spacing = spacing;
  a.K = K;
  a.ma = static_cast<T>(ma);
  a.mb = static_cast<T>(mb);
  a.counts = counts;
  if constexpr (!SPLIT) {
    if (min_islot != 0) return launch_kernel(lag_hist_islot_kernel<T>, a, s, min_islot);
  }
  const bool keep = mask == kMaskKeep || mask == kMaskKeepSpecies;
  if (mask == kMaskSpecies || mask == kMaskKeepSpecies)
    return launch_rule<T, SPLIT, true>(a, p, keep, mi, s);
  return launch_rule<T, SPLIT, false>(a, p, keep, mi, s);
}

}  // namespace

extern "C" {

// The largest bin count K the kernel takes (its shared-memory histogram).
int zelll_lag_hist_max_bins() { return kMaxBins; }

// pos: (n, dim) row-major f32 (f64 != 0: f64); lo: (n, dim) f32 low parts
// or null (f32 only); pay: (n,) payload plane in the coordinates' type, or
// null without the species mask; keys: (n,) int32 ascending, SENTINEL_KEY
// rows last; w_key: one int32 on the device (the caller's window, widened
// for the minimum image); edges: (K,) ascending squared edges in the
// coordinates' type on the device; mask: 0 none, 1 species pair {ma, mb}
// over pay, 2 the periodic keep mask over keep, 3 both; counts: (K,) int64
// on the device, zeroed by the caller, to which the kernel adds each pair's
// first bin above its dsq; keep: (n,) shift signs in the coordinates' type
// (masks 2 and 3) or null; mi != 0 (f32 only) folds the axes whose box
// length mbx, mby, mbz is > 0 to the minimum image, in split mode less the
// low parts mlx, mly, mlz of the host box lengths. min_islot != 0 counts only
// the pairs whose larger slot is at or above it (the distributed ownership
// rule; no lo, mask 0, mi 0). Returns the CUDA error of the launch (0 on
// success).
int zelll_lag_hist(const void* pos, const void* lo, const void* pay,
                   const void* keys, const void* w_key, const void* edges,
                   int n, int dim, int L, int spacing, int K, int mask,
                   double ma, double mb, int f64, void* counts, void* stream,
                   const void* keep, int mi, float mbx, float mby, float mbz,
                   float mlx, float mly, float mlz, int min_islot) {
  const bool species = mask == kMaskSpecies || mask == kMaskKeepSpecies;
  const bool kp = mask == kMaskKeep || mask == kMaskKeepSpecies;
  if (n <= 0 || n > kSentinelKey - 2 * kWarp || dim < 1 || dim > kMaxDim ||
      L < 1 || (L < n ? L : n) >= kMaxLag || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      K < 1 || K > kMaxBins || mask < kMaskNone || mask > kMaskKeepSpecies ||
      species != (pay != nullptr) || kp != (keep != nullptr) ||
      (f64 != 0 && lo != nullptr) || (f64 != 0 && mi != 0) ||
      (min_islot != 0 && (lo != nullptr || mask != kMaskNone || mi != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* w = static_cast<const int32_t*>(w_key);
  auto* out = static_cast<unsigned long long*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  const float3 mib = mi != 0 ? make_float3(mbx, mby, mbz) : make_float3(0.0f, 0.0f, 0.0f);
  const float3 mibl = mi != 0 ? make_float3(mlx, mly, mlz) : make_float3(0.0f, 0.0f, 0.0f);
  if (f64 != 0)
    return launch<double, false>(pos, l, pay, k, w, edges, n, dim, L, spacing, K, mask,
                                 ma, mb, out,
                                 Periodic<double>{static_cast<const double*>(keep), mib, mibl},
                                 false, min_islot, s);
  const Periodic<float> p{static_cast<const float*>(keep), mib, mibl};
  if (l != nullptr)
    return launch<float, true>(pos, l, pay, k, w, edges, n, dim, L, spacing, K, mask,
                               ma, mb, out, p, mi != 0, min_islot, s);
  return launch<float, false>(pos, l, pay, k, w, edges, n, dim, L, spacing, K, mask, ma,
                              mb, out, p, mi != 0, min_islot, s);
}

}  // extern "C"
