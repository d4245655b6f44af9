// The cluster-pair sweep shared by the pair kernels K1 (lag_reduce.cu), K2
// (lag_per_particle.cu), K3 (lag_forces.cu), K4 (lag_stress.cu), K5
// (lag_hist.cu), K6 (tile_reduce.cu), K7 (tile_forces.cu), K8
// (tile_stress.cu) and K9 (tile_hist.cu), and by the query join K12
// (join_reduce.cu): a warp owns
// a cluster of 32 consecutive sorted slots (K12: queries), reduces the
// cluster's axis-aligned box, keeps a candidate j point only if it lies
// near that box, compacts the survivors by ballot into a buffer in shared
// memory, and sweeps the buffer by broadcast reads (Pall and Hess, Comput.
// Phys. Commun. 184 (2013) 2641). ops/cluster_prune.py repeats the prune
// in torch; tests/test_torch_prune.py holds it to brute force.
//
// The prune, and why it drops no pair. With the own box [mn, mx] per axis
// and a j point b, the gap per axis is g = max(mn - b, b - mx, 0) in f32.
// Rounding to nearest is monotone and |fl(o - b)| = fl(|o - b|), so for
// every own point o, g <= |fl(o - b)| = |d|; dsq is a monotone function of
// |dx|, |dy|, |dz| evaluated in the same order, so gsq <= dsq, and "keep
// iff gsq < csq" drops no pair with dsq < csq. In split mode d = fl(h + l)
// with h = fl(hi_o - hi_b), l = fl(lo_o - lo_b): |d| >= fl(|h| - |l|) >=
// fl(g - L), where L = fl(lomax + |lo_b|) >= |l| (lomax: the own cluster's
// largest |lo| on the axis), so g' = max(fl(g - L), 0) keeps gsq' <= dsq
// whatever the low parts hold. The split threshold fl(csq (1 + 2^-19)) >=
// csq (1 + 1.85e-6) also covers the forces kernels' tie band (pairs whose
// f32 dsq lies within 1e-6 csq of the cutoff, decided on the f64 dsq); for
// the energy kernels, the histograms K5 and K9 and the stress kernels K4
// and K8, which keep the f32 rule dsq < csq, it is a superset. So a j point the prune drops holds no pair that any of the pair
// kernels counts, for any data, in either mode.
//
// The bound needs every product and sum rounded on its own: build with
// --fmad=false (ops/_build.py), as the kernels' bitwise agreement with
// their plain versions does too.
//
// Minimum image (K1, K3, K4 and K5 with mi_box, near_box_mi): on a folded axis of
// box length bx a pair's separation is s - k bx with s = fl(o - b) and k in
// {-1, 0, 1} (mi_axis), so the gap is taken to the nearest of the images
// b, b - bx and b + bx: a j point at x = 29.9 and a cluster at x = 0.1 of a
// 30 box are 0.2 apart through the seam, not 29.8. The images, the fold
// and, in split mode, the two-diff carry of s round once or twice each,
// within 2^-23 (|o| + |b| + bx) together, so the folded gap is lowered by
// kMiSlack (|b| + bx + max(|mn|, |mx|)), 8 times that. On every axis the
// gap is then scaled by 1 - 2^-21, which covers split mode's carry e
// (|e| <= 2^-24 |s|, and g <= |s|), before the low parts' reach is taken
// off as above. Split mode's fold also takes off k bxl, the box's own low
// part (bxl = box - fl(box), |bxl| <= 2^-24 bx), which the slack covers
// too. So the prune still drops no pair that counts.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_table.cuh"

namespace {

constexpr int kWarp = 32;           // slots per cluster
constexpr unsigned kAll = 0xffffffffu;
constexpr int32_t kSentinelKey = 2147483647;  // INT32_MAX
constexpr int32_t kPadKeyBase = kSentinelKey / 2;
// Split mode's prune threshold csq (1 + 2^-19), above the tie band
// (ops/cluster_prune.py's SPLIT_MARGIN)
constexpr float kSplitMargin = 1.0f + 0x1p-19f;

// A padding row's key (SENTINEL_KEY) is replaced by kPadKeyBase + slot *
// spacing, where spacing <= (INT32_MAX - kPadKeyBase - 1) / n keeps it below
// int32 overflow: the rule of lag_pairs._pad_and_desentinel.
__device__ __forceinline__ int32_t load_key(const int32_t* __restrict__ keys,
                                            int slot, int spacing) {
  const int32_t k = keys[slot];
  return k == kSentinelKey ? kPadKeyBase + slot * spacing : k;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = kWarp / 2; o > 0; o /= 2)
    v = fminf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// The own cluster's box, and in split mode its largest |lo| per axis.
struct Box {
  float3 mn, mx, lomax;
};

// The box of the warp's real slots (real: slot < n) from each lane's
// coordinates h and, in split mode, low parts l. Every lane takes part.
template <bool SPLIT>
__device__ __forceinline__ Box cluster_box(float4 h, float4 l, bool real) {
  const float inf = __int_as_float(0x7f800000);
  Box box;
  box.mn = make_float3(warp_min(real ? h.x : inf), warp_min(real ? h.y : inf),
                       warp_min(real ? h.z : inf));
  box.mx = make_float3(warp_max(real ? h.x : -inf), warp_max(real ? h.y : -inf),
                       warp_max(real ? h.z : -inf));
  box.lomax = make_float3(0.0f, 0.0f, 0.0f);
  if (SPLIT)
    box.lomax = make_float3(warp_max(real ? fabsf(l.x) : 0.0f),
                            warp_max(real ? fabsf(l.y) : 0.0f),
                            warp_max(real ? fabsf(l.z) : 0.0f));
  return box;
}

// The f32 threshold a squared gap is compared with.
template <bool SPLIT>
__device__ __forceinline__ float prune_threshold(float csq) {
  return SPLIT ? csq * kSplitMargin : csq;
}

// The gap of one axis between the own box and a j coordinate, less the
// low parts' reach in split mode.
template <bool SPLIT>
__device__ __forceinline__ float axis_gap(float mn, float mx, float lomax,
                                          float b, float bl) {
  float g = fmaxf(fmaxf(mn - b, b - mx), 0.0f);
  if (SPLIT) g = fmaxf(g - (lomax + fabsf(bl)), 0.0f);
  return g;
}

// True where j point (b, bl) may hold a pair with the own cluster. Absent
// axes read 0 on both sides and add exactly 0.
template <bool SPLIT>
__device__ __forceinline__ bool near_box(const Box& box, float4 b, float4 bl,
                                         float thr) {
  const float gx = axis_gap<SPLIT>(box.mn.x, box.mx.x, box.lomax.x, b.x, bl.x);
  const float gy = axis_gap<SPLIT>(box.mn.y, box.mx.y, box.lomax.y, b.y, bl.y);
  const float gz = axis_gap<SPLIT>(box.mn.z, box.mx.z, box.lomax.z, b.z, bl.z);
  float gsq = gx * gx;
  gsq = gsq + gy * gy;
  gsq = gsq + gz * gz;
  return gsq < thr;
}

// Minimum image: the slack of a folded axis and the scale of every axis'
// gap (above).
constexpr float kMiSlack = 0x1p-20f;
constexpr float kMiScale = 1.0f - 0x1p-21f;

// The gap of one axis under minimum image (bx > 0 folds it, bx == 0
// leaves it open).
template <bool SPLIT>
__device__ __forceinline__ float axis_gap_mi(float mn, float mx, float lomax,
                                             float b, float bl, float bx) {
  float g = fmaxf(fmaxf(mn - b, b - mx), 0.0f);
  if (bx > 0.0f) {
    const float up = b + bx;
    const float dn = b - bx;
    g = fminf(g, fmaxf(fmaxf(mn - up, up - mx), 0.0f));
    g = fminf(g, fmaxf(fmaxf(mn - dn, dn - mx), 0.0f));
    g = g - kMiSlack * ((fabsf(b) + bx) + fmaxf(fabsf(mn), fabsf(mx)));
  }
  g = fmaxf(g * kMiScale, 0.0f);
  if (SPLIT) g = fmaxf(g - (lomax + fabsf(bl)), 0.0f);
  return g;
}

// near_box under minimum image on the axes where mib > 0.
template <bool SPLIT>
__device__ __forceinline__ bool near_box_mi(const Box& box, float4 b, float4 bl,
                                            float thr, float3 mib) {
  const float gx = axis_gap_mi<SPLIT>(box.mn.x, box.mx.x, box.lomax.x, b.x, bl.x, mib.x);
  const float gy = axis_gap_mi<SPLIT>(box.mn.y, box.mx.y, box.lomax.y, b.y, bl.y, mib.y);
  const float gz = axis_gap_mi<SPLIT>(box.mn.z, box.mx.z, box.lomax.z, b.z, bl.z, mib.z);
  float gsq = gx * gx;
  gsq = gsq + gy * gy;
  gsq = gsq + gz * gz;
  return gsq < thr;
}

// The separation and dsq of own point o (o.h, and o.l in split mode) and
// entry (b, bl), in the order of the plain versions: dsq = (dx dx + dy dy)
// + dz dz, and in split mode each axis' d = (hi_i - hi_j) + (lo_i - lo_j).
template <bool SPLIT, typename Own>
__device__ __forceinline__ float pair_dsq(const Own& o, float4 b, float4 bl,
                                          float& dx, float& dy, float& dz) {
  dx = o.h.x - b.x;
  dy = o.h.y - b.y;
  dz = o.h.z - b.z;
  if (SPLIT) {
    dx = dx + (o.l.x - bl.x);
    dy = dy + (o.l.y - bl.y);
    dz = dz + (o.l.z - bl.z);
  }
  float dsq = dx * dx;
  dsq = dsq + dy * dy;
  dsq = dsq + dz * dz;
  return dsq;
}

// One axis' separation folded to the minimum image, as lag_pairs.mi_fold
// folds it: s = hi - hj, one box length off where |s| > bx / 2 (bx == 0
// leaves the axis open), and in split mode the exact two-diff error e of s
// carried into the low term, less the box's own low part bxl (the host
// box less fl(box)) with the shift's sign: d = (s - shift) + ((e + (li -
// lj)) - shift_lo). So a split separation across the seam is off by no
// rounding of the box (pallas_pairs.py::_mi_pair_d, and f32 mode, fold by
// fl(box) alone). shift and shift_lo are returned for the forces kernel's
// f64 tie decision.
template <bool SPLIT>
__device__ __forceinline__ float mi_axis(float hi, float hj, float li, float lj,
                                         float bx, float bxl, float& shift,
                                         float& shift_lo) {
  const float s = hi - hj;
  const float half = 0.5f * bx;
  shift = s > half ? bx : (s < -half ? -bx : 0.0f);
  float d = s - shift;
  shift_lo = 0.0f;
  if (SPLIT) {
    const float z = s - hi;
    const float e = (hi - (s - z)) - (hj + z);
    shift_lo = s > half ? bxl : (s < -half ? -bxl : 0.0f);
    d = d + ((e + (li - lj)) - shift_lo);
  }
  return d;
}

// pair_dsq under minimum image (mi_axis per axis; mibl: the boxes' low
// parts); sh, shl: the shifts and their low parts.
template <bool SPLIT, typename Own>
__device__ __forceinline__ float pair_dsq_mi(const Own& o, float4 b, float4 bl,
                                             float3 mib, float3 mibl, float& dx,
                                             float& dy, float& dz, float3& sh,
                                             float3& shl) {
  dx = mi_axis<SPLIT>(o.h.x, b.x, o.l.x, bl.x, mib.x, mibl.x, sh.x, shl.x);
  dy = mi_axis<SPLIT>(o.h.y, b.y, o.l.y, bl.y, mib.y, mibl.y, sh.y, shl.y);
  dz = mi_axis<SPLIT>(o.h.z, b.z, o.l.z, bl.z, mib.z, mibl.z, sh.z, shl.z);
  float dsq = dx * dx;
  dsq = dsq + dy * dy;
  dsq = dsq + dz * dz;
  return dsq;
}

// The periodic keep mask over the shift-sign plane (lag_pairs.pbc_keep):
// real-real pairs, each cross-boundary pair once and no ghost-ghost pair
// (mask id 2 of the energy kernels).
__device__ __forceinline__ bool keep_pair(float wi, float wj) {
  return wi * wj == 0.0f && wi + wj >= 0.0f;
}

// The ballot compaction: mask is the warp's __ballot_sync(kAll, keep); a
// lane with keep set calls put(at) with the next entry of the warp's buffer
// after its cnt entries, in lane order, and cnt grows by the number taken,
// warp-uniform. below: the lanes below this one, (1 << lane) - 1.
template <typename Put>
__device__ __forceinline__ void compact(unsigned mask, bool keep,
                                        unsigned below, int& cnt, Put put) {
  if (keep) put(cnt + __popc(mask & below));
  cnt += __popc(mask);
}

// Moves entries [base, base + cnt) of a warp's buffer a, and of b with
// TWO (split mode's low parts), to their fronts after a sweep of the
// entries before base. cnt <= R * 32, and every lane reads its R entries,
// so the buffers must hold base + R * 32 entries.
template <int R, bool TWO, typename T>
__device__ __forceinline__ void shift_front(T* a, T* b, int base, int cnt,
                                            int lane) {
  T ra[R], rb[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    ra[k] = a[base + k * kWarp + lane];
    if (TWO) rb[k] = b[base + k * kWarp + lane];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k * kWarp + lane < cnt) {
      a[k * kWarp + lane] = ra[k];
      if (TWO) b[k * kWarp + lane] = rb[k];
    }
  }
  __syncwarp();
}

// ---- the energy kernels' sweep (K1, K6) ------------------------------------

// Terms, by template value (K6's C enum; K1 maps its own onto these): LJ
// 4 t3 (t3 - 1) with t = 1/dsq by true division, the same with t =
// rsqrtf(dsq)^2, count (1), the LJ pair virial 24 t3 (2 t3 - 1), the term
// table's form in its mode (pair_table.cuh), or the table's species term
// over the lane's and the entry's plane values (o.pw, bw[q]).
constexpr int kTermLj = 0;
constexpr int kTermLjFast = 1;
constexpr int kTermCount = 2;
constexpr int kTermVirial = 3;
constexpr int kTermTable = 4;
constexpr int kTermSpecies = 5;

template <int TERM>
__device__ __forceinline__ float term_value(float dsq) {
  if (TERM == kTermLj) {
    const float t = 1.0f / dsq;
    const float t3 = t * t * t;
    return 4.0f * t3 * (t3 - 1.0f);
  }
  if (TERM == kTermLjFast) {
    const float r = rsqrtf(dsq);
    const float t = r * r;
    const float t3 = t * t * t;
    return 4.0f * t3 * (t3 - 1.0f);
  }
  if (TERM == kTermVirial) {
    const float t = 1.0f / dsq;
    const float t3 = t * t * t;
    return 24.0f * t3 * (2.0f * t3 - 1.0f);
  }
  return 1.0f;
}

// Term value in the accumulator's type: f64 for float outputs, int64 for
// integer ones (the term is cast to int32 first, as astype(int32) does).
template <typename Acc>
__device__ __forceinline__ Acc to_acc(float v);
template <>
__device__ __forceinline__ double to_acc<double>(float v) {
  return static_cast<double>(v);
}
template <>
__device__ __forceinline__ long long to_acc<long long>(float v) {
  return static_cast<long long>(static_cast<int32_t>(v));
}

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kAll, v, off);
  return v;
}

// Folds the block's per-lane sums in a fixed order (each warp by
// shuffles, then the warp sums in warp 0) and writes one partial. Every
// thread of the block calls it.
template <int WARPS, typename Acc>
__device__ __forceinline__ void block_fold(Acc acc, Acc* partial) {
  __shared__ Acc warp_sums[WARPS];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < WARPS ? warp_sums[lane] : Acc(0);
    acc = warp_sum(acc);
    if (lane == 0) partial[blockIdx.x] = acc;
  }
}

// A lane of an energy kernel: its own point and key, the slots it pairs
// with, and its sum. An entry's w holds a slot (or -1) that pairs with the
// lane iff jlo <= w < jlo + span, as unsigned arithmetic tests it: K1's lag
// range [jlo_i, i - 1]; K6's band-0 triangle w < i with jlo = -1 (entries
// of the other bands carry w = -1). span = 0 for a slot at or past n.
template <typename Acc>
struct Lane {
  float4 h;       // x, y, z (absent axes 0)
  float4 l;       // low parts (split mode)
  int32_t key;    // for the band mask (K6)
  int jlo;
  unsigned span;
  Acc acc;
  float pw;       // the slot's shift sign (the keep mask) or species
  float3 mib;     // minimum image: box lengths, 0 on open axes (K1)
  float3 mibl;    // and their low parts (split mode)
};

// Sweeps entries [0, cnt) of the warp's buffer (cnt <= 32, warp-uniform;
// FULL: cnt == 32, unrolled) into each lane's sum: the entry pairs with the
// lane where its w is in the lane's range, the key band holds (BANDMASK:
// band_lo <= key_i - key_j <= band_hi, the key in bk) and dsq < csq on the
// f32 dsq (split mode too), and with KEEP the keep mask of the lane's and
// the entry's shift signs (o.pw, bw[q]); MI folds each separation to its
// minimum image (o.mib). No dsq > 0 test: coincident particles count,
// as in the plain versions. Masks select, never multiply. TWO_PHASE: phase
// A sets the lane's hit bits and phase B adds the term of each hit (a
// count adds their popcount); otherwise the term is added inline, and the
// warp takes that branch for an entry whenever one of its lanes has a
// pair. K6 runs the two phases, K1 the term inline: each was the faster on
// the card (PERF.md has both times).
template <bool SPLIT, bool MI, typename Acc>
__device__ __forceinline__ float lane_dsq(const Lane<Acc>& o, float4 b, float4 bl) {
  float dx, dy, dz;
  if (MI) {
    float3 sh, shl;
    return pair_dsq_mi<SPLIT>(o, b, bl, o.mib, o.mibl, dx, dy, dz, sh, shl);
  }
  return pair_dsq<SPLIT>(o, b, bl, dx, dy, dz);
}

template <bool SPLIT, int TERM, bool BANDMASK, bool TWO_PHASE, bool FULL,
          bool KEEP = false, bool MI = false, typename Acc>
__device__ __forceinline__ void reduce_sweep(Lane<Acc>& o, const float4* bh,
                                             const float4* bl,
                                             const int32_t* bk, int cnt,
                                             float csq, int32_t band_lo,
                                             int32_t band_hi,
                                             const float* bw = nullptr,
                                             const TermTable* tab = nullptr) {
  unsigned hits = 0u;
  auto visit = [&](int q) {
    const float4 b = bh[q];
    const float dsq = lane_dsq<SPLIT, MI>(o, b, SPLIT ? bl[q] : make_float4(0, 0, 0, 0));
    bool m = static_cast<unsigned>(__float_as_int(b.w) - o.jlo) < o.span &&
             dsq < csq;
    if (KEEP) m = m && keep_pair(o.pw, bw[q]);
    if (BANDMASK) {
      const long long diff = static_cast<long long>(o.key) -
                             static_cast<long long>(bk[q]);
      m = m && diff >= band_lo && diff <= band_hi;
    }
    if (TWO_PHASE) {
      if (m) hits |= 1u << q;
    } else if (m) {
      // the table's forms as discarded branches: the other terms' code is
      // as it was before the table came in
      if constexpr (TERM == kTermTable)
        o.acc += to_acc<Acc>(table_term(dsq, *tab));
      else if constexpr (TERM == kTermSpecies)
        o.acc += to_acc<Acc>(table_species_term(dsq, o.pw, bw[q], *tab));
      else
        o.acc += to_acc<Acc>(term_value<TERM>(dsq));
    }
  };
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kWarp; ++q) visit(q);
  } else {
#pragma unroll 4
    for (int q = 0; q < cnt; ++q) visit(q);
  }
  if (!TWO_PHASE) return;
  if (TERM == kTermCount) {
    o.acc += static_cast<Acc>(__popc(hits));
    return;
  }
  // phase B: each lane's own hits, in ascending q
  while (hits != 0u) {
    const int q = __ffs(static_cast<int>(hits)) - 1;
    hits &= hits - 1u;
    const float dsq = lane_dsq<SPLIT, MI>(o, bh[q], SPLIT ? bl[q] : make_float4(0, 0, 0, 0));
    if constexpr (TERM == kTermTable)
      o.acc += to_acc<Acc>(table_term(dsq, *tab));
    else if constexpr (TERM == kTermSpecies)
      o.acc += to_acc<Acc>(table_species_term(dsq, o.pw, bw[q], *tab));
    else
      o.acc += to_acc<Acc>(term_value<TERM>(dsq));
  }
}

// ---- any IEEE type: K2, K4, K5, K8, K9 and the query join K12 -------------
//
// The prune argument above holds for any IEEE type with rounding to
// nearest, so the f64 instances of K2, K4, K5, K8 and K9 and K12 (f32 and
// f64) take the same box and gap test in their coordinates' type, without
// split mode.
// K12's cutoff is inclusive (dsq <= csq), so its gap test keeps gsq <= csq:
// gsq <= dsq still, and no pair at exactly the cutoff is dropped. K1, K3,
// K6 and K7 do not use this part.

// x, y, z and a tag w in the coordinates' type: float4 for f32, and for
// f64 a 32-byte row (two 16-byte shared-memory reads)
struct __align__(16) Double4 {
  double x, y, z, w;
};
template <typename T>
struct Vec4Of;
template <>
struct Vec4Of<float> {
  using type = float4;
};
template <>
struct Vec4Of<double> {
  using type = Double4;
};

// An int32 tag (a slot, or a key) stored bit for bit in a coordinate's
// type, and read back
__device__ __forceinline__ float tag_to(float, int32_t w) { return __int_as_float(w); }
__device__ __forceinline__ double tag_to(double, int32_t w) {
  return __longlong_as_double(static_cast<long long>(w));
}
__device__ __forceinline__ int32_t tag_from(float v) { return __float_as_int(v); }
__device__ __forceinline__ int32_t tag_from(double v) {
  return static_cast<int32_t>(__double_as_longlong(v));
}

__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float inf_of(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double inf_of(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// The box and gap test in the coordinates' type, and with K12's inclusive
// cutoff. For non-split f32 they test what Box / near_box test; those stay
// as K1, K3, K6 and K7 were built and timed with them (a merged template
// moved their SASS: ROADMAP.md, queue 2 B0). K2, K4, K5, K8 and K9 take
// both forms through ClusterPrune below.
template <typename T>
struct BoxOf {
  T mnx, mny, mnz, mxx, mxy, mxz;
};

// The box of the warp's real lanes (x, y, z) in T. Every lane takes part.
template <typename T>
__device__ __forceinline__ BoxOf<T> cluster_box_of(T x, T y, T z, bool real) {
  const T inf = inf_of(T(0));
  T v[6] = {real ? x : inf, real ? y : inf, real ? z : inf,
            real ? x : -inf, real ? y : -inf, real ? z : -inf};
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = min_of(v[a], __shfl_xor_sync(kAll, v[a], o));
      v[a + 3] = max_of(v[a + 3], __shfl_xor_sync(kAll, v[a + 3], o));
    }
  }
  return BoxOf<T>{v[0], v[1], v[2], v[3], v[4], v[5]};
}

// True where point (x, y, z) may hold a pair with the box: gsq < thr, or
// gsq <= thr with INCLUSIVE, the squares summed in the order of dsq.
template <bool INCLUSIVE, typename T>
__device__ __forceinline__ bool near_box_of(const BoxOf<T>& box, T x, T y, T z,
                                            T thr) {
  const T gx = max_of(max_of(box.mnx - x, x - box.mxx), T(0));
  const T gy = max_of(max_of(box.mny - y, y - box.mxy), T(0));
  const T gz = max_of(max_of(box.mnz - z, z - box.mxz), T(0));
  T gsq = gx * gx;
  gsq = gsq + gy * gy;
  gsq = gsq + gz * gz;
  return INCLUSIVE ? gsq <= thr : gsq < thr;
}

// The own cluster's box and its strict gap test in the coordinates' type
// (K2, K4, K5, K8, K9): Box with the split margin and the low parts' reach
// for f32 and split coordinates, BoxOf in double for f64 ones.
template <typename T, bool SPLIT>
struct ClusterPrune;
template <bool SPLIT>
struct ClusterPrune<float, SPLIT> {
  Box box;
  float thr;
  __device__ __forceinline__ ClusterPrune(float4 h, float4 l, bool real, float csq)
      : box(cluster_box<SPLIT>(h, l, real)), thr(prune_threshold<SPLIT>(csq)) {}
  __device__ __forceinline__ bool near(float4 b, float4 bl) const {
    return near_box<SPLIT>(box, b, bl, thr);
  }
};
template <>
struct ClusterPrune<double, false> {
  BoxOf<double> box;
  double thr;
  __device__ __forceinline__ ClusterPrune(const Double4& h, float4, bool real,
                                          double csq)
      : box(cluster_box_of(h.x, h.y, h.z, real)), thr(csq) {}
  __device__ __forceinline__ bool near(const Double4& b, float4) const {
    return near_box_of<false>(box, b.x, b.y, b.z, thr);
  }
};

// Slot j (< n) of (dim, n) planes in the coordinates' type, tag w in .w;
// absent axes read 0, which adds exactly 0 to dsq and to the box gap.
template <typename T, typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ V load_point(const T* planes, int n, int dim, int j,
                                        int32_t w) {
  V v;
  v.x = planes[j];
  v.y = dim > 1 ? planes[static_cast<int64_t>(n) + j] : T(0);
  v.z = dim > 2 ? planes[2 * static_cast<int64_t>(n) + j] : T(0);
  v.w = tag_to(T(0), w);
  return v;
}

// The separation (dx, dy, dz) and dsq of own point (h, l) and entry (b, bl)
// in any type, in the plain versions' order: (dx dx + dy dy) + dz dz, in
// split mode each axis' d = (hi_i - hi_j) + (lo_i - lo_j).
template <bool SPLIT, typename V, typename T = decltype(V::x)>
__device__ __forceinline__ T sep_dsq(const V& h, float4 l, const V& b, float4 bl,
                                     T& dx, T& dy, T& dz) {
  dx = h.x - b.x;
  dy = h.y - b.y;
  dz = h.z - b.z;
  if constexpr (SPLIT) {
    dx = dx + (l.x - bl.x);
    dy = dy + (l.y - bl.y);
    dz = dz + (l.z - bl.z);
  }
  T dsq = dx * dx;
  dsq = dsq + dy * dy;
  dsq = dsq + dz * dz;
  return dsq;
}

template <bool SPLIT, typename V, typename T = decltype(V::x)>
__device__ __forceinline__ T sep_dsq(const V& h, float4 l, const V& b, float4 bl) {
  T dx, dy, dz;
  return sep_dsq<SPLIT>(h, l, b, bl, dx, dy, dz);
}

// ---- the walks: one slot range (K2, K4, K5) and half-stencil (K8, K9) -----

// Row j of an (n, dim) row-major array in the coordinates' type, tag w in
// .w; absent axes read 0, which adds exactly 0 to dsq and to the box gap.
template <typename T, typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ V load_row(const T* rows, int dim, int j, int32_t w) {
  const T* r = rows + static_cast<int64_t>(j) * dim;
  V v;
  v.x = r[0];
  v.y = dim > 1 ? r[1] : T(0);
  v.z = dim > 2 ? r[2] : T(0);
  v.w = tag_to(T(0), w);
  return v;
}

// Both walks fill the warp's buffers bh (x, y, z and a tag in .w) and, in
// split mode, bl (the low parts) with the points the prune keeps, and leave
// the rest to the kernel's sweeper sw:
//   sw.band(lo, hi)           a band's key bounds (half-stencil only);
//   sw.store(at, j)           entry at's further planes from slot j, read
//                             for survivors only;
//   sw.template sweep<FULL>(at, cnt)
//                             sweeps entries [at, at + cnt) (cnt <= 32,
//                             warp-uniform; FULL: cnt == 32);
//   sw.shift(done, cnt, lane) moves the further planes' entries [done,
//                             done + cnt) to the front, as shift_front.
// Every lane of the warp calls a walk.

// Slot j of (n, dim) rows, or with PLANES of (dim, n) planes (n: the
// slots), as load_row and load_point read them.
template <bool PLANES, typename T, typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ V load_slot_of(const T* p, int n, int dim, int j, int32_t w) {
  if constexpr (PLANES)
    return load_point(p, n, dim, j, w);
  else
    return load_row(p, dim, j, w);
}

// The one-sided walk (K1's form): slots [first, last] of the (n, dim)
// arrays pos and lo (with PLANES, of (dim, n) planes of n slots), 32 at a
// time, the slot in .w. Lane t loads slot j0 + t and tests it with prune; a
// ballot compacts the survivors, in slot order. Each time 32 entries are
// in, they are swept and the remainder (less than one cluster) moves to the
// front; the rest is swept at the end. K4 and K5 walk their lanes' ranges
// behind them with it; K2 walks the union of its two-sided ranges, which is
// one slot range too. K1 keeps its own loop of this form: it reads the keep
// mask's plane before the prune, for every candidate, and its
// minimum-image prune is its own.
template <bool SPLIT, bool PLANES = false, typename T, typename Prune, typename Sweeper,
          typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ void one_sided_walk(const T* pos, const float* lo, int dim,
                                               int first, int last, int lane,
                                               const Prune& prune, V* bh, float4* bl,
                                               Sweeper& sw, int n = 0) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;  // entries in the buffer, warp-uniform
  for (int j0 = first; j0 <= last; j0 += kWarp) {
    const int j = j0 + lane;
    const bool valid = j <= last;
    const V b = valid ? load_slot_of<PLANES>(pos, n, dim, j, j) : vzero;
    const float4 b_lo = SPLIT && valid ? load_slot_of<PLANES>(lo, n, dim, j, 0) : zero;
    const bool keep = valid && prune.near(b, b_lo);
    compact(__ballot_sync(kAll, keep), keep, below, cnt, [&](int at) {
      bh[at] = b;
      if (SPLIT) bl[at] = b_lo;
      sw.store(at, j);
    });
    if (cnt >= kWarp) {
      __syncwarp();
      sw.template sweep<true>(0, kWarp);
      __syncwarp();
      // move the remainder (less than one cluster) to the front
      cnt -= kWarp;
      if constexpr (SPLIT)
        shift_front<1, true>(bh, bl, kWarp, cnt, lane);
      else
        shift_front<1, false>(bh, bh, kWarp, cnt, lane);
      sw.shift(kWarp, cnt, lane);
    }
  }
  if (cnt > 0) {
    __syncwarp();
    sw.template sweep<false>(0, cnt);
  }
}

// The half-stencil walk (K6's form) of the warp's own cluster, slots
// [base, base + 32) of chunk c (CLUSTERS clusters of 32 slots per chunk):
// for each band s < S, sw.band(lo_s, hi_s), then the j-chunks of the
// band's window [jlo + toff, jlo + toff + jnum) (bounds: (jlo, toff, jnum)
// per chunk and band) of the (dim, n) planes pos and lo, stopping at n
// (a: the kernel's arguments, pos, lo, bounds, bands, n, dim and S).
// Lane t loads slot t of each of a j-chunk's clusters, all loads in flight
// at once, and tests it with prune; a ballot per cluster compacts the
// survivors, in slot order. Band 0 stores the slot in .w and the other
// bands -1, so the kernel tests the triangle as one unsigned range; band
// 0's j-clusters after the own cluster hold no j < i for any lane and are
// not loaded. Each time 32 or more entries are in, every 32 are swept and
// the remainder moves to the front; with BANDMASK the rest is swept at the
// end of each band, so a sweep sees one band.
template <int CLUSTERS, bool SPLIT, bool BANDMASK, typename Args, typename T,
          typename Sweeper, typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ void half_stencil_walk(const Args& a, int c, int base, int lane,
                                                  const ClusterPrune<T, SPLIT>& prune,
                                                  V* bh, float4* bl, Sweeper& sw) {
  constexpr int kChunkSlots = CLUSTERS * kWarp;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;  // entries in the buffer, warp-uniform
  for (int s = 0; s < a.S; ++s) {
    const int32_t* win = a.bounds + (static_cast<int64_t>(c) * a.S + s) * 3;
    const int first = win[0] + win[1];
    const int num = win[2];
    sw.band(a.bands[2 * s], a.bands[2 * s + 1]);
    for (int jc = first; jc < first + num; ++jc) {
      if (jc * kChunkSlots >= a.n) break;  // later clusters lie past n too
      // band 0: a j-cluster that starts after the own cluster holds no
      // j < i for any lane, and neither do the later ones
      if (s == 0 && jc * kChunkSlots > base) break;
      // the j-chunk's live clusters: all loads in flight at once, then
      // the survivors of each appended in slot order
      V b[CLUSTERS];
      float4 b_lo[CLUSTERS];
      bool keep[CLUSTERS];
#pragma unroll
      for (int k = 0; k < CLUSTERS; ++k) {
        const int j0 = jc * kChunkSlots + k * kWarp;
        const int j = j0 + lane;
        keep[k] = j < a.n && (s != 0 || j0 <= base);
        b[k] = keep[k] ? load_point(a.pos, a.n, a.dim, j, s == 0 ? j : -1) : vzero;
        b_lo[k] = SPLIT && keep[k] ? load_point(a.lo, a.n, a.dim, j, 0) : zero;
      }
#pragma unroll
      for (int k = 0; k < CLUSTERS; ++k) {
        const int j = jc * kChunkSlots + k * kWarp + lane;
        keep[k] = keep[k] && prune.near(b[k], b_lo[k]);
        compact(__ballot_sync(kAll, keep[k]), keep[k], below, cnt, [&](int at) {
          bh[at] = b[k];
          if (SPLIT) bl[at] = b_lo[k];
          sw.store(at, j);
        });
      }
      if (cnt >= kWarp) {
        __syncwarp();
        int done = 0;
        for (; cnt - done >= kWarp; done += kWarp) sw.template sweep<true>(done, kWarp);
        __syncwarp();
        // move the remainder to the front of the buffers
        cnt -= done;
        if constexpr (SPLIT)
          shift_front<1, true>(bh, bl, done, cnt, lane);
        else
          shift_front<1, false>(bh, bh, done, cnt, lane);
        sw.shift(done, cnt, lane);
      }
    }
    if (BANDMASK && cnt > 0) {
      // the band is uniform within a sweep
      __syncwarp();
      sw.template sweep<false>(0, cnt);
      __syncwarp();
      cnt = 0;
    }
  }
  if (cnt > 0) {
    __syncwarp();
    sw.template sweep<false>(0, cnt);
  }
}

// ---- the histograms K5 and K9 ----------------------------------------------

// The first bin k < K whose edge is above dsq, for dsq < edges[K - 1]: the
// pair counts in bins k .. K - 1 of the cumulative histogram.
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

// The species pair mask of ops/rdf.py: keep {w_i, w_j} == {a, b}.
template <typename T>
__device__ __forceinline__ bool species_pair(T wi, T wj, T a, T b) {
  return (wi == a && wj == b) || (wi == b && wj == a);
}

// ---- the stress kernels K4 and K8 -------------------------------------------

// Folds N per-lane sums of the block in a fixed order (block_fold for each,
// in one pass) and writes partial[N blockIdx.x + k]. Every thread of the
// block calls it.
template <int WARPS, int N, typename Acc>
__device__ __forceinline__ void block_fold_n(const Acc (&acc)[N], Acc* partial) {
  __shared__ Acc warp_sums[N][WARPS];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const Acc v = warp_sum(acc[k]);
    if (lane == 0) warp_sums[k][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const Acc v = warp_sum(lane < WARPS ? warp_sums[k][lane] : Acc(0));
      if (lane == 0) partial[static_cast<int64_t>(N) * blockIdx.x + k] = v;
    }
  }
}

// ---- the periodic instances of K4, K5, K8 and K9 --------------------------
//
// ops/pbc.py's observables add the keep mask (K4, K5, K8, K9) and the minimum
// image (K4, K5) to the stress and histogram kernels, as new kernels beside
// the open-boundary ones, so those keep their names and code.

// The periodic keep mask (keep_pair) over a plane in the coordinates' type.
template <typename T>
__device__ __forceinline__ bool keep_pair_of(T wi, T wj) {
  return wi * wj == T(0) && wi + wj >= T(0);
}

// What a periodic instance takes beside its Args (a second kernel
// parameter): the keep mask's shift-sign plane (or null) and the minimum
// image's box lengths, 0 on open axes, with their f32 low parts (split mode).
template <typename T>
struct Periodic {
  const T* w;
  float3 mib;
  float3 mibl;
};

// A periodic lane's own shift sign and minimum-image box.
template <typename T>
struct PbcLane {
  T pw;
  float3 mib;
  float3 mibl;
};

// The strict gap test of ClusterPrune<float, SPLIT> under minimum image on
// the axes where mib > 0 (near_box_mi; f32 and split coordinates).
template <bool SPLIT>
struct ClusterPruneMi {
  Box box;
  float thr;
  float3 mib;
  __device__ __forceinline__ ClusterPruneMi(float4 h, float4 l, bool real, float csq,
                                            float3 mib_)
      : box(cluster_box<SPLIT>(h, l, real)), thr(prune_threshold<SPLIT>(csq)), mib(mib_) {}
  __device__ __forceinline__ bool near(float4 b, float4 bl) const {
    return near_box_mi<SPLIT>(box, b, bl, thr, mib);
  }
};

// sep_dsq, and with MI each axis folded to its minimum image (mi_axis, in
// the order of lag_pairs.mi_fold; f32 and split coordinates only).
template <bool SPLIT, bool MI, typename V, typename T = decltype(V::x)>
__device__ __forceinline__ T sep_dsq_pbc(const V& h, float4 l, const V& b, float4 bl,
                                         const PbcLane<T>* pl, T& dx, T& dy, T& dz) {
  if constexpr (MI) {
    static_assert(sizeof(T) == sizeof(float), "the minimum image takes f32 coordinates");
    float sh, shl;
    dx = mi_axis<SPLIT>(h.x, b.x, l.x, bl.x, pl->mib.x, pl->mibl.x, sh, shl);
    dy = mi_axis<SPLIT>(h.y, b.y, l.y, bl.y, pl->mib.y, pl->mibl.y, sh, shl);
    dz = mi_axis<SPLIT>(h.z, b.z, l.z, bl.z, pl->mib.z, pl->mibl.z, sh, shl);
    T dsq = dx * dx;
    dsq = dsq + dy * dy;
    dsq = dsq + dz * dz;
    return dsq;
  } else {
    return sep_dsq<SPLIT>(h, l, b, bl, dx, dy, dz);
  }
}

template <bool SPLIT, bool MI, typename V, typename T = decltype(V::x)>
__device__ __forceinline__ T sep_dsq_pbc(const V& h, float4 l, const V& b, float4 bl,
                                         const PbcLane<T>* pl) {
  if constexpr (MI) {
    T dx, dy, dz;
    return sep_dsq_pbc<SPLIT, MI>(h, l, b, bl, pl, dx, dy, dz);
  } else {
    return sep_dsq<SPLIT>(h, l, b, bl);
  }
}

}  // namespace
