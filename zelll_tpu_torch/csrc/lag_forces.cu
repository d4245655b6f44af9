// K3 on Hopper: per-particle pair forces over key-sorted particles, as a
// pruned cluster-pair sweep.
//
// Replaces the TPU kernel zelll_tpu/ops/pallas_pairs.py::_make_forces_kernel
// (:583, via pair_lag_forces :763; pallas_call :873). It computes the same
// function:
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
// rsqrtf(dsq)^2; t = inv^3. Padding rows (SENTINEL_KEY) read as ascending
// spaced keys above every real key, K1's rule (lag_reduce.cu), and the
// index bounds 0 <= j < n replace the TPU's spread tail coordinates.
//
// What it does not copy: the TPU kernel's Horner shift accumulator, which
// lands the j-side contributions at their window slots because Mosaic has
// no scatter, and its rolling VMEM window and sequential grid.
//
// The partners of slot i form one slot range. Keys ascend, so the slots j
// behind i in its window (key_j >= key_i - W, i - j <= L) are
// [jlo_i, i - 1] and those ahead (key_i >= key_k - W, k - i <= L) are
// [i + 1, jhi_i]; each lane finds jlo_i and jhi_i by binary search over
// the keys once. The lag set is exactly 1..L, so the result is defined
// where the coverage flag is False.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane + 3 force planes) x n, 280 MB at n = 1e7 in f32 mode,
// 84 us at 3.35 TB/s. Operations, counted as FP32 instructions with FMA
// contraction allowed, once per unique pair: 7 for each half-stencil
// candidate (13 in split mode) plus 11 for the force factor and 9 for
// g d on both sides of each cutoff pair. At the benchmark's density (132
// candidates and 21 cutoff pairs per slot) that is about 0.4 ms at
// 33.5 T instructions/s, so it is bound by operations, that is by the
// instructions issued per evaluated lane. A thread that walks each of its
// two partner lists itself issues scalar global loads (the key and 3 or 6
// coordinates per step) that no other lane shares, runs its warp to the
// longest walk, and takes the force branch whenever any lane of the warp
// has a pair.
//
// Design: a cluster-pair sweep (Pall and Hess, Comput. Phys. Commun. 184
// (2013) 2641), as K7's (tile_forces.cu). A warp owns a cluster of 32
// consecutive slots and keeps its own coordinates and range in registers;
// warps run on their own (no block barrier). Each warp
//   1. reduces its cluster's axis-aligned box over the real slots (< n)
//      by shuffles, from the coordinates of this launch (the skin loop
//      moves them between rebuilds), and in split mode the largest |lo|
//      per axis;
//   2. walks the union of its lanes' ranges, [jlo of its first slot, jhi
//      of its last real slot] (jlo and jhi ascend with i, and each range
//      holds its own slot, so the union is one range): a j-cluster outside
//      every lane's lag bound and key window is never loaded. Lane t loads
//      slot j0 + t and tests the point against the own box (below); a
//      ballot compacts the survivors, in slot order, into the warp's buffer
//      in shared memory as float4 (x, y, z, slot), plus the low parts in
//      split mode;
//   3. sweeps the buffer 32 entries at a time: phase A reads each entry by
//      a broadcast, tests jlo_i <= j <= jhi_i and dsq, and sets bit q of the
//      lane's hit mask (in split mode up to the prune threshold, so the tie
//      band goes to phase B); phase B walks each lane's own hits in
//      ascending q, recomputes d and dsq bitwise, applies the exact cutoff
//      rule (split: the f64 tie decision) and adds g d. The force factor
//      and its f64 sums run once per hit and lane. (Sweeps of 64 entries,
//      K7's choice, measured slower here on the card in f32 mode, which
//      the MD loops run most.)
// Every pair is evaluated from both ends, and both evaluations agree
// bitwise: IEEE subtraction is exactly antisymmetric, also in the split
// form, so dsq, g and |d| are the same from both sides and action equals
// reaction per pair. Only the i side is written: no scatter, no float
// atomics, and each lane adds its terms in a fixed order, so the result is
// deterministic. On the thin MD start state (8,617,716 points) the warps
// evaluate 2.71 lanes per half-stencil candidate (chip_smoke.py's
// lag_forces_alone counts them from the same boxes in torch,
// ops/cluster_prune.py), about as many as two per-thread walks do (2.69):
// the thin box is 3 cells across, so the gap test drops little that the
// key window keeps. The gain is in the cost per evaluated lane: a
// broadcast read in place of scalar loads, and the force factor once per
// hit.
//
// The prune drops no pair that counts: cluster_sweep.cuh says why, and
// holds the box, the gap test, the split margin and the compaction that
// K1, K6 and K7 share.
//
// Minimum image (MI, lag_forces_mi_kernel; the TPU kernel's mi_box /
// key_reach): each separation is folded by one box length where |s| >
// box / 2, in split mode with the two-diff of the hi difference carried
// into the low term (mi_axis in cluster_sweep.cuh, pallas_pairs.py::
// _mi_pair_d); the caller's key window is the widened sum(strides *
// reach); the prune takes the gap to each j point's nearest periodic image
// (near_box_mi). The split tie band is decided on the f64 separation less
// the same shift, ((hi_i - hi_j) - shift) + (lo_i - lo_j), so split mode's
// cutoff rule holds across the seam too. The fold is exactly antisymmetric
// (the two-diff error of -s is -e), so both ends of a pair still agree
// bitwise. Newton's +/- g d on the folded separation is the
// minimum-image force.
//
// Accumulation: each lane sums its f32 products g d in f64 and writes
// f32 planes, or f64 planes when asked (the checks compare f64 sums).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence the pair masks match
// it bitwise on identical sorted inputs, and the prune's bound holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / kWarp;
constexpr int kBuf = 2 * kWarp;  // a warp's buffer: one sweep + one cluster
constexpr int kGfnLj = 0;
constexpr int kGfnLjFast = 1;
// Split mode's tie band around the cutoff (_TIE_BAND in lag_pairs.py)
constexpr float kTieBand = 1e-6f;

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
  float3 mib;             // minimum image: box lengths, 0 on open axes
  void* out;              // (3, n) planes of float or double
};

__device__ __forceinline__ float4 load_slot(const float* planes, int64_t n,
                                            int j) {
  return make_float4(planes[j], planes[n + j], planes[2 * n + j],
                     __int_as_float(j));
}

struct Own {
  float4 h;            // x, y, z (w unused)
  float4 l;            // low parts (split mode)
  bool real;           // slot < n
  int jlo;             // first partner slot
  unsigned span;       // jhi - jlo
  double fx, fy, fz;
  float3 mib;          // minimum image: box lengths, 0 on open axes
};

// The separation and dsq of the lane and an entry, folded with MI; sh:
// the minimum image's shifts (zero without MI).
template <bool SPLIT, bool MI>
__device__ __forceinline__ float own_dsq(const Own& o, float4 b, float4 b_lo,
                                         float& dx, float& dy, float& dz, float3& sh) {
  if (MI) return pair_dsq_mi<SPLIT>(o, b, b_lo, o.mib, dx, dy, dz, sh);
  sh = make_float3(0.0f, 0.0f, 0.0f);
  return pair_dsq<SPLIT>(o, b, b_lo, dx, dy, dz);
}

// Phase A of a sweep, entry q: the lane's hit bit.
template <bool SPLIT, bool MI>
__device__ __forceinline__ bool may_count(const Own& o, float4 b, float4 b_lo,
                                          float csq, float thr) {
  float dx, dy, dz;
  float3 sh;
  const float dsq = own_dsq<SPLIT, MI>(o, b, b_lo, dx, dy, dz, sh);
  // the lag bound and key window: jlo_i <= j <= jhi_i
  const bool in_range =
      static_cast<unsigned>(__float_as_int(b.w) - o.jlo) <= o.span;
  // f32 mode: exactly the cutoff rule; split mode: up to the prune
  // threshold, which covers the tie band, decided in phase B
  return in_range && dsq < (SPLIT ? thr : csq) && dsq > 0.0f;
}

// Sweep entries [0, cnt) of the warp's buffer (cnt <= 32, warp-uniform;
// FULL: cnt == 32, unrolled).
template <bool SPLIT, int GFN, bool FULL, bool MI>
__device__ __forceinline__ void sweep(Own& o, const float4* bh,
                                      const float4* bl, int cnt, float csq,
                                      float thr) {
  // phase A: one broadcast read per entry, the lane's hit bits
  unsigned hits = 0u;
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kWarp; ++q)
      if (may_count<SPLIT, MI>(o, bh[q], SPLIT ? bl[q] : make_float4(0, 0, 0, 0), csq, thr))
        hits |= 1u << q;
  } else {
#pragma unroll 4
    for (int q = 0; q < cnt; ++q)
      if (may_count<SPLIT, MI>(o, bh[q], SPLIT ? bl[q] : make_float4(0, 0, 0, 0), csq, thr))
        hits |= 1u << q;
  }
  if (!o.real) hits = 0u;
  // phase B: each lane's own hits, in ascending q
  while (hits != 0u) {
    const int q = __ffs(hits) - 1;
    hits &= hits - 1u;
    const float4 b = bh[q];
    const float4 b_lo = SPLIT ? bl[q] : make_float4(0, 0, 0, 0);
    float dx, dy, dz;
    float3 sh;
    const float dsq = own_dsq<SPLIT, MI>(o, b, b_lo, dx, dy, dz, sh);
    bool inside = true;
    if (SPLIT) {
      inside = dsq < csq;
      if (fabsf(dsq - csq) <= kTieBand * csq) {
        // near the cutoff the f32 dsq may fall on the wrong side: decide on
        // the f64 dsq of the split separations (split_cutoff_test in
        // lag_pairs.py), less the minimum image's shift with MI
        double ex, ey, ez;
        if (MI) {
          ex = ((static_cast<double>(o.h.x) - static_cast<double>(b.x)) -
                static_cast<double>(sh.x)) +
               (static_cast<double>(o.l.x) - static_cast<double>(b_lo.x));
          ey = ((static_cast<double>(o.h.y) - static_cast<double>(b.y)) -
                static_cast<double>(sh.y)) +
               (static_cast<double>(o.l.y) - static_cast<double>(b_lo.y));
          ez = ((static_cast<double>(o.h.z) - static_cast<double>(b.z)) -
                static_cast<double>(sh.z)) +
               (static_cast<double>(o.l.z) - static_cast<double>(b_lo.z));
        } else {
          ex = (static_cast<double>(o.h.x) - static_cast<double>(b.x)) +
               (static_cast<double>(o.l.x) - static_cast<double>(b_lo.x));
          ey = (static_cast<double>(o.h.y) - static_cast<double>(b.y)) +
               (static_cast<double>(o.l.y) - static_cast<double>(b_lo.y));
          ez = (static_cast<double>(o.h.z) - static_cast<double>(b.z)) +
               (static_cast<double>(o.l.z) - static_cast<double>(b_lo.z));
        }
        double dsq64 = ex * ex;
        dsq64 = dsq64 + ey * ey;
        dsq64 = dsq64 + ez * ez;
        inside = dsq64 < static_cast<double>(csq);
      }
    }
    if (inside) {
      const float g = force_factor<GFN>(dsq);
      o.fx += static_cast<double>(g * dx);
      o.fy += static_cast<double>(g * dy);
      o.fz += static_cast<double>(g * dz);
    }
  }
}

template <bool SPLIT, int GFN, typename Out, bool MI>
__device__ __forceinline__ void lag_forces_body(const Args& a) {
  __shared__ float4 buf_hi[kWarps][kBuf];
  __shared__ float4 buf_lo[kWarps][SPLIT ? kBuf : 1];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = blockIdx.x * kBlock + w * kWarp;
  if (base >= a.n) return;  // the whole warp leaves together
  const int i = base + lane;
  const int64_t n = a.n;
  float4* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  Own o;
  o.real = i < a.n;
  o.h = o.real ? load_slot(a.pos, n, i) : make_float4(0, 0, 0, 0);
  o.l = SPLIT && o.real ? load_slot(a.lo, n, i) : make_float4(0, 0, 0, 0);
  o.fx = o.fy = o.fz = 0.0;
  o.mib = a.mib;
  // the lane's partner range [jlo, jhi] by binary search over the keys
  const int32_t w_key = *a.w_key;
  int jlo = 0, jhi = -1;
  if (o.real) {
    const int32_t key_i = load_key(a.keys, i, a.spacing);
    // smallest j in [max(i - L, 0), i] with key_j >= key_i - W (j = i holds)
    const int32_t lo_key = key_i - w_key;
    int l = i > a.L ? i - a.L : 0, r = i;
    while (l < r) {
      const int m = l + (r - l) / 2;
      if (load_key(a.keys, m, a.spacing) >= lo_key) r = m; else l = m + 1;
    }
    jlo = l;
    // largest k in [i, min(i + L, n - 1)] with key_k - W <= key_i (k = i holds)
    l = i;
    r = a.n - 1 - i > a.L ? i + a.L : a.n - 1;
    while (l < r) {
      const int m = r - (r - l) / 2;
      if (load_key(a.keys, m, a.spacing) - w_key <= key_i) l = m; else r = m - 1;
    }
    jhi = l;
  }
  o.jlo = jlo;
  o.span = static_cast<unsigned>(jhi - jlo);
  // the union of the lanes' ranges: jlo and jhi ascend with i
  const int first = __shfl_sync(kAll, jlo, 0);
  const int last = __reduce_max_sync(kAll, o.real ? jhi : -1);
  const Box box = cluster_box<SPLIT>(o.h, o.l, o.real);
  const float thr = prune_threshold<SPLIT>(a.csq);
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;  // entries in the buffer, warp-uniform
  for (int j0 = first; j0 <= last; j0 += kWarp) {
    const int j = j0 + lane;
    const bool valid = j <= last;
    const float4 b = valid ? load_slot(a.pos, n, j) : make_float4(0, 0, 0, 0);
    const float4 b_lo =
        SPLIT && valid ? load_slot(a.lo, n, j) : make_float4(0, 0, 0, 0);
    const bool keep = valid && (MI ? near_box_mi<SPLIT>(box, b, b_lo, thr, a.mib)
                                   : near_box<SPLIT>(box, b, b_lo, thr));
    const unsigned mask = __ballot_sync(kAll, keep);
    if (mask == 0u) continue;
    compact(mask, keep, below, cnt, [&](int at) {
      bh[at] = b;
      if (SPLIT) bl[at] = b_lo;
    });
    if (cnt >= kWarp) {
      __syncwarp();
      sweep<SPLIT, GFN, true, MI>(o, bh, bl, kWarp, a.csq, thr);
      __syncwarp();
      // move the remainder to the front of the buffer
      cnt -= kWarp;
      shift_front<1, SPLIT>(bh, bl, kWarp, cnt, lane);
    }
  }
  if (cnt > 0) {
    __syncwarp();
    sweep<SPLIT, GFN, false, MI>(o, bh, bl, cnt, a.csq, thr);
  }
  if (o.real) {
    Out* out = static_cast<Out*>(a.out);
    out[i] = static_cast<Out>(o.fx);
    out[n + i] = static_cast<Out>(o.fy);
    out[2 * n + i] = static_cast<Out>(o.fz);
  }
}

// The open-boundary instances
template <bool SPLIT, int GFN, typename Out>
__global__ void __launch_bounds__(kBlock) lag_forces_kernel(Args a) {
  lag_forces_body<SPLIT, GFN, Out, false>(a);
}

// The minimum-image instances
template <bool SPLIT, int GFN, typename Out>
__global__ void __launch_bounds__(kBlock) lag_forces_mi_kernel(Args a) {
  lag_forces_body<SPLIT, GFN, Out, true>(a);
}

template <bool SPLIT, int GFN, typename Out>
void launch_mi(const Args& a, bool mi, cudaStream_t s) {
  const int blocks = (a.n + kBlock - 1) / kBlock;
  if (mi)
    lag_forces_mi_kernel<SPLIT, GFN, Out><<<blocks, kBlock, 0, s>>>(a);
  else
    lag_forces_kernel<SPLIT, GFN, Out><<<blocks, kBlock, 0, s>>>(a);
}

template <bool SPLIT, int GFN>
void launch_out(const Args& a, bool f64_out, bool mi, cudaStream_t s) {
  if (f64_out)
    launch_mi<SPLIT, GFN, double>(a, mi, s);
  else
    launch_mi<SPLIT, GFN, float>(a, mi, s);
}

template <bool SPLIT>
void launch_gfn(const Args& a, int gfn, bool f64_out, bool mi, cudaStream_t s) {
  if (gfn == kGfnLj)
    launch_out<SPLIT, kGfnLj>(a, f64_out, mi, s);
  else
    launch_out<SPLIT, kGfnLjFast>(a, f64_out, mi, s);
}

}  // namespace

extern "C" {

// Threads per block.
int zelll_lag_forces_block() { return kBlock; }

// pos, lo: (3, n) f32 planes (lo null unless split); keys: (n,) int32
// ascending, SENTINEL_KEY rows last; w_key: one int32 on the device;
// spacing: the padding-key spacing, (INT32_MAX - INT32_MAX / 2 - 1) / n at
// least 1; gfn: 0 for the LJ force factor, 1 for its rsqrt form; mi != 0
// folds the axes whose box length mbx, mby, mbz is > 0 to the minimum
// image (w_key then the widened window); out: (3, n) planes of float
// (f64_out == 0) or double (f64_out != 0). Returns cudaGetLastError() after
// the launch.
int zelll_lag_forces(const void* pos, const void* lo, const void* keys,
                     const void* w_key, int n, int L, int spacing, float csq,
                     int gfn, int f64_out, int mi, float mbx, float mby, float mbz,
                     void* out, void* stream) {
  if (n <= 0 || n > kSentinelKey - 2 * kWarp || L < 1 || spacing < 1 ||
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
  a.mib = mi != 0 ? make_float3(mbx, mby, mbz) : make_float3(0.0f, 0.0f, 0.0f);
  a.out = out;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.lo != nullptr)
    launch_gfn<true>(a, gfn, f64_out != 0, mi != 0, s);
  else
    launch_gfn<false>(a, gfn, f64_out != 0, mi != 0, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
