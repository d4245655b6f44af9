// The stress sweep shared by the lag stress K4 (lag_stress.cu) and the tile
// stress K8 (tile_stress.cu), on cluster_sweep.cuh: the force factor, a
// lane's own point, range and six sums, and the two-phase sweep of a warp's
// buffer with six products per hit. Include it after cluster_sweep.cuh. K3
// and K7 keep their own f32 force factor (and the names kGfnLj and
// force_factor), so they do not include this header. GFN = kGfnTable takes
// any factory's force factor through the device term table (pair_table.cuh,
// f32 coordinates): the table comes in through a pointer beside the sweep's
// arguments, so the LJ instances keep their code, and it is evaluated once
// per hit in phase B, off the unrolled phase A.

#pragma once

#include "cluster_sweep.cuh"

namespace {

constexpr int kComps = 6;  // xx, xy, xz, yy, yz, zz
constexpr int kGfnLj = 0;
constexpr int kGfnLjFast = 1;
constexpr int kGfnTable = 2;  // lag_pairs._GFN_TABLE, tile_pairs._GFN_TABLE

__device__ __forceinline__ float recip_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double recip_sqrt(double x) { return rsqrt(x); }

// LJ 24 t (2t - 1) inv with inv = 1/dsq by true division (kGfnLj) or
// inv = rsqrt(dsq)^2 (kGfnLjFast); t = inv^3.
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

// A lane: its own point, low parts and key (K8's band mask), the slots it
// pairs with, and its six sums. An entry's tag w pairs with the lane iff
// jlo <= w < jlo + span, as unsigned arithmetic tests it: K4's lag range
// [jlo_i, i - 1]; K8's band-0 triangle w < i with jlo = -1 (entries of the
// other bands carry w = -1). span = 0 for a slot at or past n.
template <typename T>
struct StressLane {
  typename Vec4Of<T>::type h;
  float4 l;
  int32_t key;
  int jlo;
  unsigned span;
  double acc[kComps];
};

// Sweeps entries [0, cnt) of the warp's buffers (cnt <= 32, warp-uniform;
// FULL: cnt == 32, unrolled): phase A sets the lane's hit bits (the range,
// with BANDMASK the band, 0 < dsq < csq), phase B adds the six products of
// each hit, in ascending q. The dsq > 0 test keeps coincident pairs out:
// g(0) = inf, and inf * 0 would poison every component. The periodic
// instances: KEEP adds the keep mask of the lane's and the entry's shift
// signs (pl->pw, bw[q]) to phase A, MI folds each separation to its minimum
// image (pl->mib; the folded d_a d_b is the image's outer product). GFN =
// kGfnTable evaluates the table tab's force factor per hit.
template <typename T, bool SPLIT, int GFN, bool BANDMASK, bool FULL, bool KEEP = false,
          bool MI = false, typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ void stress_sweep(StressLane<T>& o, const V* bh,
                                             const float4* bl, const int32_t* bk,
                                             int cnt, T csq, int32_t band_lo,
                                             int32_t band_hi,
                                             const PbcLane<T>* pl = nullptr,
                                             const T* bw = nullptr,
                                             const TermTable* tab = nullptr) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  unsigned hits = 0u;
  auto hit = [&](int q) {
    const V b = bh[q];
    const T dsq = sep_dsq_pbc<SPLIT, MI>(o.h, o.l, b, SPLIT ? bl[q] : zero, pl);
    bool m = static_cast<unsigned>(tag_from(b.w) - o.jlo) < o.span && dsq < csq &&
             dsq > T(0);
    if constexpr (KEEP) m = m && keep_pair_of(pl->pw, bw[q]);
    if (BANDMASK) {
      const long long diff = static_cast<long long>(o.key) -
                             static_cast<long long>(bk[q]);
      m = m && diff >= band_lo && diff <= band_hi;
    }
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
    T dx, dy, dz;
    const T dsq = sep_dsq_pbc<SPLIT, MI>(o.h, o.l, bh[q], SPLIT ? bl[q] : zero, pl, dx, dy,
                                         dz);
    // the table's form as a discarded branch: the LJ instances' code is as
    // it was before the table came in
    T g;
    if constexpr (GFN == kGfnTable)
      g = table_gfn(dsq, *tab);
    else
      g = force_factor<GFN>(dsq);
    const T g0 = g * dx;
    const T g1 = g * dy;
    const T g2 = g * dz;
    o.acc[0] += static_cast<double>(g0 * dx);
    o.acc[1] += static_cast<double>(g0 * dy);
    o.acc[2] += static_cast<double>(g0 * dz);
    o.acc[3] += static_cast<double>(g1 * dy);
    o.acc[4] += static_cast<double>(g1 * dz);
    o.acc[5] += static_cast<double>(g2 * dz);
  }
}

}  // namespace
