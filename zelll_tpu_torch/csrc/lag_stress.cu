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
// inv = rsqrt(dsq)^2; t = inv^3; or (f32 coordinates, optionally split) any
// factory's force factor of ops/potentials.py through the device term
// table (pair_table.cuh). Coordinates are f32 (optionally with f32 low
// parts) or f64, 1-3 axes (absent axes read 0).
//
// What it does not copy: the TPU kernel's rolling VMEM window, lane rolls,
// per-component Kahan sums and sequential grid. Padding rows (SENTINEL_KEY)
// read as ascending spaced keys above every real key (K1's rule), and the
// index bound j >= 0 replaces the TPU's tail padding.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (f64: 8 B planes), 160-280 MB at n = 1e7,
// 48-84 us at 3.35 TB/s. Operations: K1's 7 (13 split) FP32 instructions
// per half-stencil candidate, plus, per cutoff pair, the force factor (11),
// three g d_a products, six d_a d_b products and six f64 adds (counted
// twice: FP64 runs at half the rate): far above the bytes, so it is bound
// by operations, that is by the instructions issued per evaluated lane. A
// thread that walked its own lags (this kernel's first design) issued
// scalar global loads that no other lane shares, ran its warp to the
// longest walk and evaluated every lag-window candidate. No single PyTorch
// call computes this function.
//
// Design: K5's one-sided cluster sweep (lag_hist.cu) with K8's six products
// per hit (tile_stress.cu), on cluster_sweep.cuh and stress_sweep.cuh. Lane
// i's partners are the slots [jlo_i, i - 1], where jlo_i, found by binary
// search over the keys, is the larger of i - L and the first slot with
// key_j >= key_i - W: keys ascend, so that is exactly the set of lags 1..L
// in the key window, and a short L drops the pairs the plain version drops.
// A warp owns a cluster of 32 consecutive slots and keeps its own
// coordinates and range in registers; the 4 warps of a block share only the
// final fold. Each warp
//   1. reduces its cluster's box over the real slots (< n), and in split
//      mode the largest |lo| per axis (f64: the box and the gap in double;
//      ClusterPrune);
//   2. walks the union of its lanes' ranges, [jlo of its first slot, its
//      last real slot - 1] (jlo ascends with i; the header's
//      one_sided_walk): lane t loads row j0 + t of the (n, dim) array and
//      tests the point against the own box with the threshold csq; a
//      ballot compacts the survivors, in slot order, into the warp's buffer
//      in shared memory (x, y, z and the slot; the low parts in split
//      mode);
//   3. sweeps the buffer 32 entries at a time (stress_sweep): phase A reads
//      each entry by a broadcast and sets the lane's hit bit where
//      jlo_i <= j < i (one unsigned range test) and 0 < dsq < csq hold;
//      phase B computes the force factor of each hit and adds its six
//      products to the lane's f64 sums.
// The prune drops no pair that counts (cluster_sweep.cuh says why; the
// split threshold is a superset of the strict f32 rule), and
// ops/cluster_prune.py's lag_cluster_entries(half=True) counts these
// entries, as it does K1's and K5's (tests/test_torch_prune.py holds it to
// brute force). Every rule of the function stays a lane mask, and masks
// select, never multiply, so the inf of a masked-out dsq = 0 cannot reach a
// sum.
//
// Periodic boxes (ops/virial.py's pbc_stress_fused) add instances under a
// new kernel name, lag_stress_pbc_kernel, with the periodic arguments as a
// second kernel parameter (Periodic), so the open-boundary instances keep
// their names and code:
//   KEEP: the TPU kernel's payload pair mask virial._pbc_keep_mask. One
//     plane w holds each slot's shift sign (0 real, +/-1 ghost) in the
//     coordinates' type; an entry carries its w in a third buffer beside
//     the coordinates, read for survivors of the prune only, the lane its
//     own in a register, and phase A keeps a pair only where (w_i w_j == 0)
//     & (w_i + w_j >= 0) (keep_pair_of). d_a d_b is the same for a pair and
//     its mirror image, so the one image kept carries the whole term.
//   MI (f32 and split): in-kernel minimum image (pallas_pairs.py::
//     _mi_pair_d, mi_box / key_reach): each separation is folded by one box
//     length where |s| > box / 2 (mi_axis; split mode carries the two-diff
//     of the hi difference and the box's own low part into the low term,
//     as K1 and K3 do), the key window W is the caller's widened
//     sum(strides * reach), and the walk's prune takes the gap to the
//     nearest periodic image of each j point (ClusterPruneMi, near_box_mi).
//     The folded d_a d_b is the image pair's outer product.
// Both compose, with each force factor.
//
// The term table (GFN = kGfnTable, f32 and split) adds instances under new
// kernel names, lag_stress_table_kernel and lag_stress_table_pbc_kernel
// (each of the four rules: open, KEEP, MI, KEEP and MI), with the table as a
// further kernel parameter, so the instances above keep their parameters and
// code. stress_sweep evaluates the table's force factor once per hit in
// phase B, off the unrolled phase A.
//
// Accumulation: each lane sums the six upper-triangle products (xx, xy,
// xz, yy, yz, zz; absent axes give 0) in f64 registers; the block folds its
// lanes in a fixed order (block_fold_n) and writes six partials. The caller
// sums the partials (the second pass). No float atomics, so the result is
// deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence the pair masks match
// it bitwise on identical sorted inputs, and the prune's bound holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"
#include "stress_sweep.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / kWarp;
constexpr int kBuf = 2 * kWarp;  // a warp's buffer: a sweep + a cluster
constexpr int kMaxDim = 3;

template <typename T>
struct Args {
  const T* pos;           // (n, dim) row-major
  const float* lo;        // (n, dim) f32 low parts, or null
  const int32_t* keys;    // (n,) ascending, SENTINEL_KEY rows last
  const int32_t* w_key;   // one int32 on the device
  int n;
  int dim;
  int L;
  int spacing;
  T csq;
  double* partial;        // 6 per block
};

// What the one-sided walk of cluster_sweep.cuh asks of K4: the keep
// plane beside the coordinates (KEEP, read for survivors only), and the
// sweep.
template <typename T, bool SPLIT, int GFN, bool KEEP = false, bool MI = false,
          typename V = typename Vec4Of<T>::type>
struct LagStressSweeper {
  StressLane<T>& o;
  const V* bh;
  const float4* bl;
  T csq;
  const PbcLane<T>* pl = nullptr;
  T* bw = nullptr;
  const T* w = nullptr;
  const TermTable* tab = nullptr;
  __device__ __forceinline__ void store(int at, int j) {
    if constexpr (KEEP) bw[at] = w[j];
  }
  template <bool FULL>
  __device__ __forceinline__ void sweep(int at, int cnt) {
    if constexpr (GFN == kGfnTable)
      stress_sweep<T, SPLIT, kGfnTable, false, FULL, KEEP, MI>(
          o, bh + at, bl + at, nullptr, cnt, csq, 0, 0, pl, KEEP ? bw + at : nullptr, tab);
    else if constexpr (KEEP || MI)
      stress_sweep<T, SPLIT, GFN, false, FULL, KEEP, MI>(o, bh + at, bl + at, nullptr, cnt,
                                                         csq, 0, 0, pl, KEEP ? bw + at : nullptr);
    else
      stress_sweep<T, SPLIT, GFN, false, FULL>(o, bh + at, bl + at, nullptr, cnt, csq, 0, 0);
  }
  __device__ __forceinline__ void shift(int done, int cnt, int lane) {
    if constexpr (KEEP) shift_front<1, false>(bw, bw, done, cnt, lane);
  }
};

// The kernel's body; KEEP and MI (the periodic instances) read p, the table
// instances tab.
template <typename T, bool SPLIT, int GFN, bool KEEP, bool MI>
__device__ __forceinline__ void lag_stress_body(const Args<T>& a, const Periodic<T>& p,
                                                const TermTable* tab = nullptr) {
  using V = typename Vec4Of<T>::type;
  __shared__ V buf_hi[kWarps][kBuf];
  __shared__ float4 buf_lo[kWarps][SPLIT ? kBuf : 1];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = blockIdx.x * kBlock + w * kWarp;  // the cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  V* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  T* bw = nullptr;
  if constexpr (KEEP) {
    __shared__ T buf_w[kWarps][kBuf];
    bw = buf_w[w];
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  StressLane<T> o;
  o.h = real ? load_row(a.pos, a.dim, i, 0) : vzero;
  o.l = SPLIT && real ? load_row(a.lo, a.dim, i, 0) : zero;
  o.key = 0;  // no band mask
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
#pragma unroll
  for (int k = 0; k < kComps; ++k) o.acc[k] = 0.0;
  // a cluster past n holds no particle: its warp only joins the fold
  if (base < a.n) {
    // the union of the lanes' ranges: jlo ascends with i
    const int first = __shfl_sync(kAll, jlo, 0);
    const int last = min(base + kWarp, a.n) - 2;  // the last real slot - 1
    if constexpr (KEEP || MI) {
      const PbcLane<T> pl{KEEP && real ? p.w[i] : T(0), p.mib, p.mibl};
      LagStressSweeper<T, SPLIT, GFN, KEEP, MI> sw{o, bh, bl, a.csq, &pl, bw, p.w, tab};
      if constexpr (MI) {
        const ClusterPruneMi<SPLIT> prune(o.h, o.l, real, a.csq, p.mib);
        one_sided_walk<SPLIT>(a.pos, a.lo, a.dim, first, last, lane, prune, bh, bl, sw);
      } else {
        const ClusterPrune<T, SPLIT> prune(o.h, o.l, real, a.csq);
        one_sided_walk<SPLIT>(a.pos, a.lo, a.dim, first, last, lane, prune, bh, bl, sw);
      }
    } else {
      // the open instances as they were built before the periodic ones
      // (their SASS, chip_compare.py sass)
      const ClusterPrune<T, SPLIT> prune(o.h, o.l, real, a.csq);
      LagStressSweeper<T, SPLIT, GFN> sw{o, bh, bl, a.csq, nullptr, nullptr, nullptr, tab};
      one_sided_walk<SPLIT>(a.pos, a.lo, a.dim, first, last, lane, prune, bh, bl, sw);
    }
  }
  block_fold_n<kWarps>(o.acc, a.partial);
}

// The open-boundary instances
template <typename T, bool SPLIT, int GFN>
__global__ void __launch_bounds__(kBlock) lag_stress_kernel(Args<T> a) {
  lag_stress_body<T, SPLIT, GFN, false, false>(a, Periodic<T>{});
}

// The periodic instances: the keep mask, the minimum image (f32 and split),
// or both; p beside Args, so the instances above keep their code
template <typename T, bool SPLIT, int GFN, bool KEEP, bool MI>
__global__ void __launch_bounds__(kBlock) lag_stress_pbc_kernel(Args<T> a, Periodic<T> p) {
  lag_stress_body<T, SPLIT, GFN, KEEP, MI>(a, p);
}

// The term table's instances (f32 and split): the table beside Args (and
// Periodic), so the instances above keep their parameters and code
template <bool SPLIT>
__global__ void __launch_bounds__(kBlock) lag_stress_table_kernel(Args<float> a,
                                                                  TermTable tab) {
  lag_stress_body<float, SPLIT, kGfnTable, false, false>(a, Periodic<float>{}, &tab);
}

template <bool SPLIT, bool KEEP, bool MI>
__global__ void __launch_bounds__(kBlock) lag_stress_table_pbc_kernel(Args<float> a,
                                                                      Periodic<float> p,
                                                                      TermTable tab) {
  lag_stress_body<float, SPLIT, kGfnTable, KEEP, MI>(a, p, &tab);
}

template <bool SPLIT>
void launch_table(const Args<float>& a, const Periodic<float>& p, const TermTable& t,
                  bool keep, bool mi, int blocks, cudaStream_t s) {
  if (keep && mi)
    lag_stress_table_pbc_kernel<SPLIT, true, true><<<blocks, kBlock, 0, s>>>(a, p, t);
  else if (mi)
    lag_stress_table_pbc_kernel<SPLIT, false, true><<<blocks, kBlock, 0, s>>>(a, p, t);
  else if (keep)
    lag_stress_table_pbc_kernel<SPLIT, true, false><<<blocks, kBlock, 0, s>>>(a, p, t);
  else
    lag_stress_table_kernel<SPLIT><<<blocks, kBlock, 0, s>>>(a, t);
}

template <typename T, bool SPLIT, int GFN>
void launch_rule(const Args<T>& a, const Periodic<T>& p, bool keep, bool mi, int blocks,
                 cudaStream_t s) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (keep && mi) {
      lag_stress_pbc_kernel<T, SPLIT, GFN, true, true><<<blocks, kBlock, 0, s>>>(a, p);
      return;
    }
    if (mi) {
      lag_stress_pbc_kernel<T, SPLIT, GFN, false, true><<<blocks, kBlock, 0, s>>>(a, p);
      return;
    }
  }
  if (keep)
    lag_stress_pbc_kernel<T, SPLIT, GFN, true, false><<<blocks, kBlock, 0, s>>>(a, p);
  else
    lag_stress_kernel<T, SPLIT, GFN><<<blocks, kBlock, 0, s>>>(a);
}

template <typename T, bool SPLIT>
void launch(const void* pos, const float* lo, const int32_t* keys,
            const int32_t* w_key, int n, int dim, int L, int spacing,
            double csq, int gfn, double* partial, const Periodic<T>& p, bool keep,
            bool mi, const TermTable& t, cudaStream_t stream) {
  Args<T> a;
  a.pos = static_cast<const T*>(pos);
  a.lo = lo;
  a.keys = keys;
  a.w_key = w_key;
  a.n = n;
  a.dim = dim;
  a.L = L;
  a.spacing = spacing;
  a.csq = static_cast<T>(csq);
  a.partial = partial;
  const int blocks = (n + kBlock - 1) / kBlock;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (gfn == kGfnTable) {
      launch_table<SPLIT>(a, p, t, keep, mi, blocks, stream);
      return;
    }
  }
  if (gfn == kGfnLj)
    launch_rule<T, SPLIT, kGfnLj>(a, p, keep, mi, blocks, stream);
  else
    launch_rule<T, SPLIT, kGfnLjFast>(a, p, keep, mi, blocks, stream);
}

}  // namespace

extern "C" {

// Threads per block: the caller allocates ceil(n / block) x 6 partials.
int zelll_lag_stress_block() { return kBlock; }

// pos: (n, dim) row-major f32 (f64 != 0: f64); lo: (n, dim) f32 low parts
// or null (f32 only); keys: (n,) int32 ascending, SENTINEL_KEY rows last;
// w_key: one int32 on the device (the caller's window, widened for the
// minimum image); spacing: the padding-key spacing; csq: cutoff^2 in the
// coordinates' type; partial: ceil(n / block) x 6 doubles (xx, xy, xz, yy,
// yz, zz per block); keep: (n,) shift signs in the coordinates' type (the
// periodic keep mask, lag_pairs.pbc_keep) or null; mi != 0 (f32 only) folds
// the axes whose box length mbx, mby, mbz is > 0 to the minimum image, in
// split mode less the low parts mlx, mly, mlz of the host box lengths.
// gfn 2 (f32 only) takes the device term table's force factor (tkind,
// tmode and tvals: pair_table.cuh's kind, its gfn mode and 6 floats, its 5
// constants and the shift, in host memory; not the species factor).
// Returns cudaGetLastError() after the launch.
int zelll_lag_stress(const void* pos, const void* lo, const void* keys,
                     const void* w_key, int n, int dim, int L, int spacing,
                     double csq, int gfn, int f64, void* partial,
                     void* stream, const void* keep, int mi, float mbx, float mby,
                     float mbz, float mlx, float mly, float mlz, int tkind, int tmode,
                     const float* tvals) {
  const bool table = gfn == kGfnTable;
  if (n <= 0 || n > kSentinelKey - 2 * kWarp || dim < 1 || dim > kMaxDim || L < 1 ||
      spacing < 1 || static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      (gfn != kGfnLj && gfn != kGfnLjFast && !table) || (f64 != 0 && lo != nullptr) ||
      (f64 != 0 && mi != 0) ||
      (table && (f64 != 0 || tmode != kTableModeGfn ||
                 !term_table_ok(tkind, tmode, false, nullptr, 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  const TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* w = static_cast<const int32_t*>(w_key);
  auto* out = static_cast<double*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  const float3 mib = mi != 0 ? make_float3(mbx, mby, mbz) : make_float3(0.0f, 0.0f, 0.0f);
  const float3 mibl = mi != 0 ? make_float3(mlx, mly, mlz) : make_float3(0.0f, 0.0f, 0.0f);
  const bool kp = keep != nullptr;
  if (f64 != 0)
    launch<double, false>(pos, l, k, w, n, dim, L, spacing, csq, gfn, out,
                          Periodic<double>{static_cast<const double*>(keep), mib, mibl}, kp,
                          false, t, s);
  else if (l != nullptr)
    launch<float, true>(pos, l, k, w, n, dim, L, spacing, csq, gfn, out,
                        Periodic<float>{static_cast<const float*>(keep), mib, mibl}, kp,
                        mi != 0, t, s);
  else
    launch<float, false>(pos, l, k, w, n, dim, L, spacing, csq, gfn, out,
                         Periodic<float>{static_cast<const float*>(keep), mib, mibl}, kp,
                         mi != 0, t, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
