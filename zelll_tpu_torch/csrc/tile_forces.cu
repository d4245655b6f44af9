// K7 on Hopper: per-particle pair forces by segment tiles over key-sorted
// particles, any box shape, as a pruned cluster-pair sweep.
//
// Replaces the TPU kernels zelll_tpu/ops/tile_pairs.py::
// _make_tile_forces_kernel_packed (:1025, via _packed_forces_core :1223 and
// tile_pair_forces; pallas_call :1262) and ::_make_tile_forces_kernel
// (:1295, the int32-key form behind tile_pair_forces(packed=False);
// pallas_call :1624). Both compute one function:
//
//   f_i = sum over bands s < S (the full, mirrored stencil: S = 1, 3, 9
//         for dim = 1, 2, 3) and j-chunks jc of the band's window
//         [jlo + toff, jlo + toff + jnum) of own chunk c = i / 128,
//         of g d over slots j of jc where
//     i < n and j < n                  (index bound)
//     lo_s <= key_i - key_j <= hi_s    (only with the band mask)
//     0 < dsq < csq                    (strict cutoff; drops i == j and
//                                       coincident particles)
//     d = pos_i - pos_j, g = gfn(dsq)
//
// with dsq = (dx dx + dy dy) + dz dz, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j); in split mode a pair whose
// f32 dsq lies within 1e-6 csq of the cutoff is decided on the f64 dsq of
// its split separations (as K3 does). The windows and bands come from
// ops/segments.py on the torch side (chunk_bounds with half=False, trimmed
// disjoint in band_order(full=True) for the maskless body). Force factors:
// LJ 24 t (2t - 1) inv with inv = 1/dsq by true division, or inv =
// rsqrtf(dsq)^2; t = inv^3. The windows stay exactly the plain version's,
// so the result is defined where the coverage flag is False.
//
// What it does not copy: the packed 8-row f32 blocks with f32 keys, the
// per-band DMA windows and their semaphores, the lane broadcasts, and the
// deferred (128, 128) g d accumulators that the TPU kernel folds with one
// ones-vector matrix product per chunk. Keys stay int32 here, so one kernel
// serves both TPU layouts.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane + 3 force planes) x n, 280 MB at n = 1e7 in f32 mode, 84 us
// at 3.35 TB/s. Operations, counted once per unique pair: 7 FP32
// instructions per half-stencil candidate (13 split) plus 20 per cutoff
// pair, about 0.4 ms at the benchmark's density: it is bound by operations,
// that is by the instructions issued per evaluated lane. Evaluating all
// 128 x 128 lanes of every j-chunk of the 9 windows costs 19.7 lanes per
// half-stencil candidate on the MD cube (a 128-slot chunk spans about 13
// cells along the key's fastest axis, a particle's partners 3), and a warp
// that runs the force factor inline takes that branch whenever any of its
// lanes has a pair.
//
// Design: a cluster-pair sweep (Pall and Hess, Comput. Phys. Commun. 184
// (2013) 2641). A warp owns a cluster of 32 consecutive slots, i = 128 c +
// 32 w + lane, and keeps its own coordinates in registers; the 4 warps of
// a block share chunk c's windows but otherwise run on their own (no block
// barrier). Each warp
//   1. reduces its cluster's axis-aligned box over the real slots (< n)
//      by shuffles, from the coordinates of this launch (the skin loops
//      move them between rebuilds), and in split mode the largest |lo|
//      per axis;
//   2. walks the j-chunks of every window in order, stopping at n: lane t
//      loads slot t of each of the chunk's 4 clusters (all loads in flight
//      at once) and tests each point against the own box (below). A ballot
//      per cluster compacts the survivors, in slot order, into the warp's
//      buffer in shared memory as float4 (x, y, z, key bits), plus the low
//      parts in split mode;
//   3. sweeps the buffer 64 entries at a time: phase A reads each entry by
//      a broadcast (one shared-memory transaction for the warp), computes
//      dsq and sets bit q of the lane's 64-bit hit mask where dsq is below
//      the cutoff (in split mode below the prune threshold, so that the tie
//      band goes to phase B); phase B walks each lane's own hits in
//      ascending q, recomputes d and dsq bitwise as in phase A, drops
//      dsq == 0 (the own slot, coincident particles), applies the exact
//      cutoff rule (split: the f64 tie decision) and adds g d. The force
//      factor and its f64 sums thus run once per hit and lane, not once per
//      entry for the whole warp. With the band mask the buffer is swept at
//      the end of each band, so the band is uniform in a sweep.
// Every pair is met from both ends (the bands are mirrored) and only the i
// side is written: no scatter, no atomics, and each lane adds its terms in
// a fixed order, so the result is deterministic. Masks select, never
// multiply, so an inf from a masked-out dsq = 0 cannot reach a sum. On the
// cubic MD start state (9,938,375 points) the prune leaves 2.46 lane
// evaluations per half-stencil candidate: each own cluster sweeps about 331
// entries (chip_smoke.py's tile_forces_alone counts them from the same
// boxes in torch, ops/cluster_prune.py). Sweeps of 64 entries measured
// faster than sweeps of 32 (fewer phase B rounds set by the lane with the
// most hits), and loading a j-chunk's 4 clusters at once faster than one
// cluster at a time (variants timed in one call on the card).
//
// The prune drops no pair that counts: cluster_sweep.cuh says why, and
// holds the box, the gap test, the split margin and the compaction that
// K1, K3 and K6 share.
//
// Pair potentials (ops/potentials.py) add instances under a new template
// value, so the existing instances keep their names and code: GFN =
// kGfnTable takes any factory's force factor through the device term table
// (pair_table.cuh, a TermTable in Args), in every instance the LJ factor
// has. K7 takes no species plane (nor does the TPU kernel).
//
// Accumulation: each lane sums its f32 products g d in f64 and writes
// (dim, n) planes of f32, or f64 when asked (the checks compare f64 sums).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence the pair masks match
// it bitwise on identical inputs, and the prune's bound above holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"

namespace {

constexpr int kChunk = 128;   // slots per chunk = threads per block
constexpr int kClusters = kChunk / kWarp;  // per chunk: warps per block
constexpr int kSweep = 64;    // entries per sweep
// a warp's buffer: a remainder (< kSweep) and a j-chunk's survivors
constexpr int kBuf = kSweep + kChunk;
constexpr int kMaxBands = 9;
constexpr int kMaxDim = 3;
constexpr int kGfnLj = 0;
constexpr int kGfnLjFast = 1;
constexpr int kGfnTable = 2;
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
  const float* pos;       // (dim, n) planes
  const float* lo;        // (dim, n) low parts, or null
  const int32_t* keys;    // (nc_pad * 128,) padded keys
  const int32_t* bounds;  // (nc_pad, 3 S): jlo, toff, jnum per band
  const int32_t* bands;   // (S, 2): lo, hi per band
  int n;
  int dim;
  int S;
  float csq;
  void* out;              // (dim, n) planes of float or double
  TermTable tab;          // the table's force factor (kGfnTable)
};

// Coordinates of slot j (< n) from the planes; absent axes read 0, which
// adds exactly 0 to dsq and to the box gap.
__device__ __forceinline__ float4 load_slot(const float* planes, int n,
                                            int dim, int j, int32_t key) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(key));
  if (j < n) {
    v.x = planes[j];
    if (dim > 1) v.y = planes[static_cast<int64_t>(n) + j];
    if (dim > 2) v.z = planes[2 * static_cast<int64_t>(n) + j];
  }
  return v;
}

// A warp's state: its own slot's coordinates and key, the sums, and its
// compaction buffer in shared memory.
struct Own {
  float4 h;    // x, y, z, key bits
  float4 l;    // low parts (split mode)
  bool real;   // slot < n
  double fx, fy, fz;
};

// Phase A of a sweep, entry q: the lane's hit bit.
template <bool SPLIT, bool BANDMASK>
__device__ __forceinline__ bool may_count(const Own& o, float4 b, float4 b_lo,
                                          float csq, float thr, int32_t band_lo,
                                          int32_t band_hi) {
  float dx, dy, dz;
  const float dsq = pair_dsq<SPLIT>(o, b, b_lo, dx, dy, dz);
  // f32 mode: the cutoff; split mode: the prune threshold, which covers
  // the tie band; phase B decides the tie band and drops dsq == 0
  bool hit = dsq < (SPLIT ? thr : csq);
  if (BANDMASK) {
    const long long diff = static_cast<long long>(__float_as_int(o.h.w)) -
                           static_cast<long long>(__float_as_int(b.w));
    hit = hit && diff >= band_lo && diff <= band_hi;
  }
  return hit;
}

// Sweep entries [0, cnt) of the warp's buffer (cnt <= kSweep,
// warp-uniform; FULL: cnt == kSweep, unrolled).
template <bool SPLIT, int GFN, bool BANDMASK, bool FULL>
__device__ __forceinline__ void sweep(Own& o, const float4* bh,
                                      const float4* bl, int cnt, float csq,
                                      float thr, int32_t band_lo,
                                      int32_t band_hi, const TermTable& tab) {
  // phase A: one broadcast read per entry, the lane's hit bits
  unsigned long long hits = 0ull;
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kSweep; ++q)
      if (may_count<SPLIT, BANDMASK>(o, bh[q], SPLIT ? bl[q] : make_float4(0, 0, 0, 0),
                                     csq, thr, band_lo, band_hi))
        hits |= 1ull << q;
  } else {
#pragma unroll 4
    for (int q = 0; q < cnt; ++q)
      if (may_count<SPLIT, BANDMASK>(o, bh[q], SPLIT ? bl[q] : make_float4(0, 0, 0, 0),
                                     csq, thr, band_lo, band_hi))
        hits |= 1ull << q;
  }
  if (!o.real) hits = 0ull;
  // phase B: each lane's own hits, in ascending q
  while (hits != 0ull) {
    const int q = __ffsll(static_cast<long long>(hits)) - 1;
    hits &= hits - 1ull;
    const float4 b = bh[q];
    const float4 b_lo = SPLIT ? bl[q] : make_float4(0, 0, 0, 0);
    float dx, dy, dz;
    const float dsq = pair_dsq<SPLIT>(o, b, b_lo, dx, dy, dz);
    bool inside = dsq > 0.0f;
    if (SPLIT) {
      inside = inside && dsq < csq;
      if (fabsf(dsq - csq) <= kTieBand * csq) {
        // near the cutoff the f32 dsq may fall on the wrong side: decide
        // on the f64 dsq of the split separations (split_cutoff_test in
        // lag_pairs.py); absent axes add 0
        const double ex = (static_cast<double>(o.h.x) - static_cast<double>(b.x)) +
                          (static_cast<double>(o.l.x) - static_cast<double>(b_lo.x));
        const double ey = (static_cast<double>(o.h.y) - static_cast<double>(b.y)) +
                          (static_cast<double>(o.l.y) - static_cast<double>(b_lo.y));
        const double ez = (static_cast<double>(o.h.z) - static_cast<double>(b.z)) +
                          (static_cast<double>(o.l.z) - static_cast<double>(b_lo.z));
        double dsq64 = ex * ex;
        dsq64 = dsq64 + ey * ey;
        dsq64 = dsq64 + ez * ez;
        inside = dsq > 0.0f && dsq64 < static_cast<double>(csq);
      }
    }
    if (inside) {
      const float g = GFN == kGfnTable ? table_gfn(dsq, tab) : force_factor<GFN>(dsq);
      o.fx += static_cast<double>(g * dx);
      o.fy += static_cast<double>(g * dy);
      o.fz += static_cast<double>(g * dz);
    }
  }
}

template <bool SPLIT, int GFN, bool BANDMASK, typename Out>
__global__ void __launch_bounds__(kChunk) tile_forces_kernel(Args a) {
  __shared__ float4 buf_hi[kClusters][kBuf];
  __shared__ float4 buf_lo[kClusters][SPLIT ? kBuf : 1];
  const int c = blockIdx.x;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int i = c * kChunk + threadIdx.x;
  float4* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  Own o;
  o.real = i < a.n;
  o.h = load_slot(a.pos, a.n, a.dim, i, a.keys[i]);  // keys cover the chunk
  o.l = SPLIT ? load_slot(a.lo, a.n, a.dim, i, 0) : make_float4(0, 0, 0, 0);
  o.fx = o.fy = o.fz = 0.0;
  // a cluster past n holds no particle (the whole warp leaves together)
  if (c * kChunk + w * kWarp >= a.n) return;
  const Box box = cluster_box<SPLIT>(o.h, o.l, o.real);
  const float thr = prune_threshold<SPLIT>(a.csq);
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;  // entries in the buffer, warp-uniform
  int32_t band_lo = 0, band_hi = 0;
  for (int s = 0; s < a.S; ++s) {
    const int32_t* win = a.bounds + (static_cast<int64_t>(c) * a.S + s) * 3;
    const int first = win[0] + win[1];
    const int num = win[2];
    band_lo = a.bands[2 * s];
    band_hi = a.bands[2 * s + 1];
    for (int jc = first; jc < first + num; ++jc) {
      if (jc * kChunk >= a.n) break;  // later clusters lie past n too
      // the j-chunk's 4 clusters: all loads in flight at once, then the
      // survivors of each appended in slot order
      float4 b[kClusters], b_lo[kClusters];
      bool keep[kClusters];
#pragma unroll
      for (int k = 0; k < kClusters; ++k) {
        const int j = jc * kChunk + k * kWarp + lane;
        b[k] = load_slot(a.pos, a.n, a.dim, j, BANDMASK && j < a.n ? a.keys[j] : 0);
        b_lo[k] = SPLIT ? load_slot(a.lo, a.n, a.dim, j, 0) : make_float4(0, 0, 0, 0);
        keep[k] = j < a.n;
      }
#pragma unroll
      for (int k = 0; k < kClusters; ++k) {
        keep[k] = keep[k] && near_box<SPLIT>(box, b[k], b_lo[k], thr);
        compact(__ballot_sync(kAll, keep[k]), keep[k], below, cnt, [&](int at) {
          bh[at] = b[k];
          if (SPLIT) bl[at] = b_lo[k];
        });
      }
      if (cnt >= kSweep) {
        __syncwarp();
        int base = 0;
        for (; cnt - base >= kSweep; base += kSweep)
          sweep<SPLIT, GFN, BANDMASK, true>(o, bh + base, bl + base, kSweep, a.csq, thr, band_lo,
                                      band_hi, a.tab);
        __syncwarp();
        // move the remainder to the front of the buffer
        cnt -= base;
        shift_front<kSweep / kWarp, SPLIT>(bh, bl, base, cnt, lane);
      }
    }
    if (BANDMASK && cnt > 0) {
      // the band is uniform within a sweep
      __syncwarp();
      sweep<SPLIT, GFN, BANDMASK, false>(o, bh, bl, cnt, a.csq, thr, band_lo, band_hi, a.tab);
      __syncwarp();
      cnt = 0;
    }
  }
  if (cnt > 0) {
    __syncwarp();
    sweep<SPLIT, GFN, BANDMASK, false>(o, bh, bl, cnt, a.csq, thr, band_lo, band_hi, a.tab);
  }
  if (o.real) {
    Out* out = static_cast<Out*>(a.out);
    const int64_t n = a.n;
    out[i] = static_cast<Out>(o.fx);
    if (a.dim > 1) out[n + i] = static_cast<Out>(o.fy);
    if (a.dim > 2) out[2 * n + i] = static_cast<Out>(o.fz);
  }
}

template <bool SPLIT, int GFN, bool BANDMASK>
void launch_out(const Args& a, bool f64_out, int blocks, cudaStream_t s) {
  if (f64_out)
    tile_forces_kernel<SPLIT, GFN, BANDMASK, double>
        <<<blocks, kChunk, 0, s>>>(a);
  else
    tile_forces_kernel<SPLIT, GFN, BANDMASK, float>
        <<<blocks, kChunk, 0, s>>>(a);
}

template <bool SPLIT, int GFN>
void launch_mask(const Args& a, bool bandmask, bool f64_out, int blocks,
                 cudaStream_t s) {
  if (bandmask)
    launch_out<SPLIT, GFN, true>(a, f64_out, blocks, s);
  else
    launch_out<SPLIT, GFN, false>(a, f64_out, blocks, s);
}

template <bool SPLIT>
void launch_gfn(const Args& a, int gfn, bool bandmask, bool f64_out,
                int blocks, cudaStream_t s) {
  if (gfn == kGfnLj)
    launch_mask<SPLIT, kGfnLj>(a, bandmask, f64_out, blocks, s);
  else if (gfn == kGfnTable)
    launch_mask<SPLIT, kGfnTable>(a, bandmask, f64_out, blocks, s);
  else
    launch_mask<SPLIT, kGfnLjFast>(a, bandmask, f64_out, blocks, s);
}

}  // namespace

extern "C" {

// Slots per chunk (threads per block).
int zelll_tile_forces_chunk() { return kChunk; }

// pos, lo: (dim, n) f32 planes (lo null unless split); keys: the padded
// (nc_pad * 128,) int32 keys; bounds: (nc_pad, 3 S) int32 (jlo, toff, jnum)
// per band; bands: (S, 2) int32 on the device; gfn: 0 for the LJ force
// factor, 1 for its rsqrt form; out: (dim, n) planes of float
// (f64_out == 0) or double (f64_out != 0). Returns cudaGetLastError()
// after the launch. gfn 2 takes the device term table's force factor (tkind,
// tmode and tvals: pair_table.cuh's kind, mode and 6 floats, its 5
// constants and the shift, in host memory).
int zelll_tile_forces(const void* pos, const void* lo, const void* keys,
                      const void* bounds, const void* bands, int n, int dim,
                      int S, float csq, int gfn, int f64_out, int bandmask,
                      void* out, void* stream, int tkind, int tmode,
                      const float* tvals) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands ||
      (gfn != kGfnLj && gfn != kGfnLjFast && gfn != kGfnTable) ||
      (gfn == kGfnTable &&
       (tmode != kTableModeGfn || !term_table_ok(tkind, tmode, false, nullptr, 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.lo = static_cast<const float*>(lo);
  a.keys = static_cast<const int32_t*>(keys);
  a.bounds = static_cast<const int32_t*>(bounds);
  a.bands = static_cast<const int32_t*>(bands);
  a.n = n;
  a.dim = dim;
  a.S = S;
  a.csq = csq;
  a.out = out;
  a.tab = make_term_table(tkind, tmode, tvals, nullptr, 0);
  const int blocks = (n + kChunk - 1) / kChunk;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.lo != nullptr)
    launch_gfn<true>(a, gfn, bandmask != 0, f64_out != 0, blocks, s);
  else
    launch_gfn<false>(a, gfn, bandmask != 0, f64_out != 0, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
