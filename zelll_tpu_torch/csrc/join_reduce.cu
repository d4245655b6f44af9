// K12 on Hopper: the query x particle join reduce.
//
// Replaces the TPU kernel zelll_tpu/ops/join.py::_make_join_kernel (:66,
// launched by join_reduce :289). It computes the same function: for each
// query of a batch sorted by flat cell key,
//
//   out[i, q] = combine over particles j with
//                 lo_s <= key_i - key_j <= hi_s for one of the S = 9
//                 full-stencil bands (segments.segment_bands(full=True)),
//                 dsq <= csq   (inclusive, as the reference's point query,
//                               cellgrid.rs:398; K1-K7 use the strict <)
//               of term_q(dsq, d, payload_j)
//
// with d = q_i - p_j per axis, dsq = (d0 d0 + d1 d1) + d2 d2, and three
// instances of (term, combiner):
//
//   count    sum of 1                                   n_out = 1
//   nearest  min of dsq (+inf when no particle is in)   n_out = 1
//   sdf      the 12 SDF sums of ops/sdf_join.py:        n_out = 12
//            S1 = sum e1, S2 = sum e3 r, S3 = sum e3,
//            A1 = sum e1/(r d) u, A2 = sum e3 r/d u, A3 = sum e3/d u
//            with e1 = exp(-d/r), e3 = exp(-d), u = q - p, and payload
//            planes (r, 1/r); a particle at d == 0 adds (1, r, 1) to
//            (S1, S2, S3) and nothing to the gradient sums (numdual.rs:34-42)
//
// in f32 or f64, accumulated in the coordinates' type.
//
// What it does not copy: the TPU kernel's 128-query chunks against
// 128-particle tiles with per-chunk band windows (join_bounds), its
// VMEM-resident particle array and, above 131072 particles, its windowed DMA
// variant (MAXJ). Those are TPU layout and VMEM limits; here there is no
// particle ceiling.
//
// What bounds it on an H100: bytes are (3 + 1) x nq + (3 + npl + 1) x np
// values in and n_out x nq out, a few MB at the psssh sizes. Operations:
// for every particle in a query's 9 band ranges (~1e3 per query at cutoff
// 10 in a protein) the distance and the cutoff test (7 FP32 instructions),
// and for each particle within the cutoff the term (1 for count and
// nearest, ~23 for sdf, two of them exp); so it is bound by operations
// (FP64 at half the FP32 rate). No single PyTorch call computes this
// function.
//
// Design: a query-cluster sweep on cluster_sweep.cuh. A warp owns a cluster
// of 32 consecutive sorted queries, one per lane, and keeps each query's
// n_out accumulators in registers (the f64 sdf instance of the second form
// below: in the thread's column of a shared array). The warp
//   1. reduces the box of its real queries (a query with the key
//      SENTINEL_KEY, or past nq, takes the identity and stays out of the
//      box) and their smallest and largest keys kf, kl;
//   2. finds, for each band s, the one contiguous particle range that
//      covers every query's own range: particle keys in [kf - hi_s,
//      kl - lo_s], since keys ascend. Lanes 0-17 run the 9 x 2 binary
//      searches at once (key arithmetic in 64 bits, so no band offset can
//      overflow), and shuffles hand the bounds to every lane;
//   3. loads each band's range 32 particles at a time (coalesced), keeps a
//      particle only if its gap to the query box, squared and summed in
//      dsq's order, is <= cutoff^2 (near_box_of: the cutoff is inclusive,
//      and the gap never exceeds a query's distance, by monotone rounding),
//      and compacts the survivors by ballot, in slot order, into the warp's
//      buffer in shared memory: x, y, z and the key, plus (r, 1/r) for sdf;
//   4. sweeps the buffer 32 entries at a time by broadcast reads: phase A
//      sets the lane's hit bit where its own band test lo_s <= key_i -
//      key_j <= hi_s (the union range covers more than its own range) and
//      dsq <= csq hold; phase B adds the term of each hit in ascending
//      slot order (a count adds the hits' popcount, nearest takes the
//      minimum in phase A). The buffer is swept at the end of each band.
// Each lane so visits the particles of its own ranges, band by band, in
// ascending slot order: the pairs and the order of summation of one thread
// per query walking its 9 ranges (the earlier design). Counts and minima are
// the plain version's exactly, sums up to the order of summation.
//
// Two forms, by a fixed rule on the cluster count: from kSplitBelow
// clusters on (the eval protocol's 64^3 grids), each of a block's 4 warps
// owns a cluster. Below it (the samplers' 1024 chains: 32 clusters, which
// would fill 8 blocks), the 4 warps of a block share one cluster: warp p
// takes the 32-particle loads p, p + 4, ... of each band range, and the
// parts fold their per-query sums into part 0 in ascending part order
// through shared memory (deterministic; then the sums differ from one
// walker's in their order).
//
// Queries with the key SENTINEL_KEY (INT32_MAX) take the identity.
// Particle rows with SENTINEL_KEY sort last and lie in no band of a real
// query key.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math: exp and sqrt
// stay IEEE (no __expf), and the division is true. --fmad=false rounds
// every product and sum on its own, as the plain PyTorch version does, so
// dsq and hence the cutoff masks match it bitwise on identical inputs, and
// the prune's bound holds.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "cluster_sweep.cuh"

namespace {

constexpr int kWarps = 4;                // warps per block
constexpr int kBlock = kWarps * kWarp;   // threads per block
// a warp's buffer: a remainder (< one sweep of 32) and one load's survivors
constexpr int kBuf = 2 * kWarp;
constexpr int kMaxBands = 9;
// From this many clusters on, each warp owns a cluster (kWarps per block,
// so the blocks fill the 132 SMs); below it a block's warps share one.
constexpr int kSplitBelow = 132 * kWarps;

constexpr int kCount = 0;
constexpr int kNearest = 1;
constexpr int kSdf = 2;

template <int INST>
struct Inst;
template <>
struct Inst<kCount> {
  static constexpr int kOut = 1;
};
template <>
struct Inst<kNearest> {
  static constexpr int kOut = 1;
};
template <>
struct Inst<kSdf> {
  static constexpr int kOut = 12;
};

__device__ __forceinline__ float ieee_exp(float x) { return expf(x); }
__device__ __forceinline__ double ieee_exp(double x) { return exp(x); }
__device__ __forceinline__ float ieee_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ieee_sqrt(double x) { return sqrt(x); }

// (r, 1/r) of an sdf entry
template <typename T>
struct Pair2 {
  T r, rinv;
};

template <typename T>
struct Args {
  const T* q;             // (3, nq) query planes, sorted by key
  const int32_t* qkeys;   // (nq,) ascending
  const T* p;             // (3 + npl, np) particle planes, sorted by key
  const int32_t* pkeys;   // (np,) ascending, SENTINEL_KEY rows last
  const int32_t* bands;   // (S, 2) [lo, hi] key-difference bands
  const T* csq;           // cutoff^2, one value on the device
  int nq;
  int np;
  int S;
  T* out;                 // (nq, n_out), sorted query order
};

// First index in [lo, hi) whose key is >= v (hi if none).
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ keys,
                                           int lo, int hi, int64_t v) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (static_cast<int64_t>(keys[mid]) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// First index in [lo, hi) whose key is > v (hi if none).
__device__ __forceinline__ int upper_bound(const int32_t* __restrict__ keys,
                                           int lo, int hi, int64_t v) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (static_cast<int64_t>(keys[mid]) <= v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// A lane's n_out sums: in registers, or (ColumnSums) in the thread's own
// column of a shared array, stride kBlock.
template <typename T, int N>
struct RegSums {
  T v[N];
  __device__ __forceinline__ T& operator[](int k) { return v[k]; }
};
template <typename T>
struct ColumnSums {
  T* col;
  __device__ __forceinline__ T& operator[](int k) { return col[k * kBlock]; }
};

// The f64 sdf instance whose warps share a cluster keeps its 12 sums in
// shared memory: in registers they left it 168 registers and a spill. (The
// one-warp form keeps them in registers: 149, no spill, and faster on the
// card than with 118 registers and the sums in shared memory; PERF.md.)
template <typename T, int INST, int WPC>
constexpr bool kColumnSums = INST == kSdf && sizeof(T) == 8 && WPC > 1;

// The SDF term of one particle inside the cutoff, in the order of
// operations of ops/sdf_join.py::sdf_term. A particle at d == 0 takes the
// constant branch, so 1/sqrt(0) is never formed.
template <typename T, typename Sums>
__device__ __forceinline__ void add_sdf(T dsq, T d0, T d1, T d2, T r, T rinv,
                                        Sums& acc) {
  if (dsq > T(0)) {
    const T rs = T(1) / ieee_sqrt(dsq);
    const T dist = dsq * rs;
    const T e1 = ieee_exp(-dist * rinv);
    const T e3 = ieee_exp(-dist);
    const T c1 = e1 * rs * rinv;
    const T c3 = e3 * rs;
    const T c2 = c3 * r;
    acc[0] += e1;
    acc[1] += e3 * r;
    acc[2] += e3;
    acc[3] += c1 * d0;
    acc[4] += c1 * d1;
    acc[5] += c1 * d2;
    acc[6] += c2 * d0;
    acc[7] += c2 * d1;
    acc[8] += c2 * d2;
    acc[9] += c3 * d0;
    acc[10] += c3 * d1;
    acc[11] += c3 * d2;
  } else {
    acc[0] += T(1);
    acc[1] += r;
    acc[2] += T(1);
  }
}

// A lane's query: its point, key (for the band test), whether it is real,
// and its accumulators.
template <typename T, int INST, int WPC>
struct Query {
  T x, y, z;
  int32_t key;
  bool real;
  std::conditional_t<kColumnSums<T, INST, WPC>, ColumnSums<T>,
                     RegSums<T, Inst<INST>::kOut>> acc;
};

// d = q - p per axis and dsq = (d0 d0 + d1 d1) + d2 d2 of the lane's
// query and entry b.
template <typename Q, typename V, typename T>
__device__ __forceinline__ T query_dsq(const Q& o, const V& b, T& d0, T& d1,
                                       T& d2) {
  d0 = o.x - b.x;
  d1 = o.y - b.y;
  d2 = o.z - b.z;
  T dsq = d0 * d0;
  dsq = dsq + d1 * d1;
  dsq = dsq + d2 * d2;
  return dsq;
}

// Phase A of one entry (its w holds the particle key): sets the lane's
// hit bit q where the lane's own band test and dsq <= csq hold; nearest
// takes the minimum here.
template <int INST, typename Q, typename V, typename T>
__device__ __forceinline__ void join_visit(Q& o, const V* bh, int q, T csq,
                                           int32_t band_lo, int32_t band_hi,
                                           unsigned& hits) {
  const V b = bh[q];
  T d0, d1, d2;
  const T dsq = query_dsq(o, b, d0, d1, d2);
  const long long diff = static_cast<long long>(o.key) -
                         static_cast<long long>(tag_from(b.w));
  const bool m = o.real && diff >= band_lo && diff <= band_hi && dsq <= csq;
  if (INST == kNearest) {
    if (m) o.acc[0] = dsq < o.acc[0] ? dsq : o.acc[0];
  } else if (m) {
    hits |= 1u << q;
  }
}

// Sweeps entries [0, cnt) of the warp's buffer (cnt <= 32, warp-uniform;
// FULL: cnt == 32, unrolled) into each lane's accumulators.
template <typename T, int INST, bool FULL, typename Q, typename V>
__device__ __forceinline__ void join_sweep(Q& o, const V* bh,
                                           const Pair2<T>* bp, int cnt, T csq,
                                           int32_t band_lo, int32_t band_hi) {
  unsigned hits = 0u;
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kWarp; ++q)
      join_visit<INST>(o, bh, q, csq, band_lo, band_hi, hits);
  } else {
#pragma unroll 4
    for (int q = 0; q < cnt; ++q)
      join_visit<INST>(o, bh, q, csq, band_lo, band_hi, hits);
  }
  if constexpr (INST == kCount) {
    o.acc[0] += static_cast<T>(__popc(hits));
  } else if constexpr (INST == kSdf) {
    // phase B: the lane's own hits, in ascending slot order
    while (hits != 0u) {
      const int q = __ffs(static_cast<int>(hits)) - 1;
      hits &= hits - 1u;
      T d0, d1, d2;
      const T dsq = query_dsq(o, bh[q], d0, d1, d2);
      add_sdf(dsq, d0, d1, d2, bp[q].r, bp[q].rinv, o.acc);
    }
  }
}

// WPC: warps per cluster, 1 or kWarps.
template <typename T, int INST, int WPC>
__global__ void __launch_bounds__(kBlock) join_kernel(Args<T> a) {
  using V = typename Vec4Of<T>::type;
  constexpr int kOut = Inst<INST>::kOut;
  constexpr bool kPay = INST == kSdf;
  constexpr bool kColumns = kColumnSums<T, INST, WPC>;
  __shared__ V buf_h[kWarps][kBuf];
  __shared__ Pair2<T> buf_p[kWarps][kPay ? kBuf : 1];
  __shared__ T sums[kColumns ? kOut * kBlock : 1];
  __shared__ T fold[WPC > 1 && !kColumns ? kWarp * kOut : 1];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int part = w % WPC;  // the warp's share of its cluster's loads
  const int i = (blockIdx.x * (kWarps / WPC) + w / WPC) * kWarp + lane;
  const int64_t nq = a.nq;
  const int64_t np = a.np;
  V* bh = buf_h[w];
  Pair2<T>* bp = buf_p[w];
  Query<T, INST, WPC> o;
  if constexpr (kColumns) o.acc.col = sums + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kOut; ++k)
    o.acc[k] = INST == kNearest ? T(INFINITY) : T(0);
  o.key = i < a.nq ? a.qkeys[i] : kSentinelKey;
  o.real = o.key != kSentinelKey;
  o.x = o.real ? a.q[i] : T(0);
  o.y = o.real ? a.q[nq + i] : T(0);
  o.z = o.real ? a.q[2 * nq + i] : T(0);
  // a cluster without a real query holds nothing to sum: its warps only
  // join the fold
  if (__ballot_sync(kAll, o.real) != 0u) {
    const BoxOf<T> box = cluster_box_of(o.x, o.y, o.z, o.real);
    const int32_t kf = __reduce_min_sync(kAll, o.real ? o.key : kSentinelKey);
    const int32_t kl = __reduce_max_sync(kAll, o.real ? o.key : INT32_MIN);
    // lane 2 s: the first particle of band s's union range, lane 2 s + 1:
    // its end (partner keys kf - hi_s .. kl - lo_s)
    int end = 0;
    if (lane < 2 * a.S) {
      const int s = lane / 2;
      const int64_t lo_key = static_cast<int64_t>(kf) - a.bands[2 * s + 1];
      const int64_t hi_key = static_cast<int64_t>(kl) - a.bands[2 * s];
      end = lane % 2 == 0 ? lower_bound(a.pkeys, 0, a.np, lo_key)
                          : upper_bound(a.pkeys, 0, a.np, hi_key);
    }
    const T csq = *a.csq;
    const V vzero = V{T(0), T(0), T(0), T(0)};
    const unsigned below = (1u << lane) - 1u;
    int cnt = 0;  // entries in the buffer, warp-uniform
    for (int s = 0; s < a.S; ++s) {
      const int jb = __shfl_sync(kAll, end, 2 * s);
      const int je = __shfl_sync(kAll, end, 2 * s + 1);
      const int32_t band_lo = a.bands[2 * s];
      const int32_t band_hi = a.bands[2 * s + 1];
      for (int j0 = jb + part * kWarp; j0 < je; j0 += WPC * kWarp) {
        const int j = j0 + lane;
        bool keep = j < je;
        V b = vzero;
        Pair2<T> pj{T(0), T(0)};
        if (keep) {
          b.x = a.p[j];
          b.y = a.p[np + j];
          b.z = a.p[2 * np + j];
          b.w = tag_to(T(0), a.pkeys[j]);
          if (kPay) pj = Pair2<T>{a.p[3 * np + j], a.p[4 * np + j]};
        }
        keep = keep && near_box_of<true>(box, b.x, b.y, b.z, csq);
        compact(__ballot_sync(kAll, keep), keep, below, cnt, [&](int at) {
          bh[at] = b;
          if (kPay) bp[at] = pj;
        });
        if (cnt >= kWarp) {
          __syncwarp();
          join_sweep<T, INST, true>(o, bh, bp, kWarp, csq, band_lo, band_hi);
          __syncwarp();
          // move the remainder to the front of the buffer
          cnt -= kWarp;
          shift_front<1, false>(bh, bh, kWarp, cnt, lane);
          if (kPay) shift_front<1, false>(bp, bp, kWarp, cnt, lane);
        }
      }
      // the band is uniform within a sweep
      if (cnt > 0) {
        __syncwarp();
        join_sweep<T, INST, false>(o, bh, bp, cnt, csq, band_lo, band_hi);
        __syncwarp();
        cnt = 0;
      }
    }
  }
  if constexpr (WPC > 1) {
    // the parts' sums into part 0, in ascending part order
    for (int p = 1; p < WPC; ++p) {
      __syncthreads();
      if (!kColumns && part == p) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) fold[lane * kOut + k] = o.acc[k];
      }
      __syncthreads();
      if (part == 0) {
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
          // part p's sums: its column (thread p * 32 + lane), or the fold
          const T v = kColumns ? sums[k * kBlock + p * kWarp + lane]
                               : fold[lane * kOut + k];
          o.acc[k] = INST == kNearest ? (v < o.acc[k] ? v : o.acc[k])
                                      : o.acc[k] + v;
        }
      }
    }
  }
  if (part == 0 && i < a.nq) {
    T* out = a.out + static_cast<int64_t>(i) * kOut;
#pragma unroll
    for (int k = 0; k < kOut; ++k) out[k] = o.acc[k];
  }
}

template <typename T, int INST>
void launch_form(const Args<T>& a, cudaStream_t stream) {
  const int clusters = (a.nq + kWarp - 1) / kWarp;
  if (clusters >= kSplitBelow) {
    const int blocks = (clusters + kWarps - 1) / kWarps;
    join_kernel<T, INST, 1><<<blocks, kBlock, 0, stream>>>(a);
  } else {
    join_kernel<T, INST, kWarps><<<clusters, kBlock, 0, stream>>>(a);
  }
}

template <typename T>
int launch(const void* q, const void* qkeys, const void* p, const void* pkeys,
           const void* bands, const void* csq, int nq, int np, int S, int inst,
           void* out, cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.qkeys = static_cast<const int32_t*>(qkeys);
  a.p = static_cast<const T*>(p);
  a.pkeys = static_cast<const int32_t*>(pkeys);
  a.bands = static_cast<const int32_t*>(bands);
  a.csq = static_cast<const T*>(csq);
  a.nq = nq;
  a.np = np;
  a.S = S;
  a.out = static_cast<T*>(out);
  if (inst == kCount)
    launch_form<T, kCount>(a, stream);
  else if (inst == kNearest)
    launch_form<T, kNearest>(a, stream);
  else
    launch_form<T, kSdf>(a, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (3, nq) query planes and qkeys: (nq,) int32, both sorted by key; p:
// (3 + npl, np) particle planes (npl = 2, (r, 1/r), for the sdf instance,
// else 0) and pkeys: (np,) int32 ascending; bands: (S, 2) int32 on the
// device, S <= 9; csq: cutoff^2 as one value of the coordinates' type on
// the device; inst: 0 count, 1 nearest, 2 sdf; f64: coordinates are double
// (else float); out: (nq, n_out) of the coordinates' type. Returns
// cudaGetLastError() after the launch.
int zelll_join_reduce(const void* q, const void* qkeys, const void* p,
                      const void* pkeys, const void* bands, const void* csq,
                      int nq, int np, int S, int inst, int f64, void* out,
                      void* stream) {
  if (nq <= 0 || np < 0 || S < 1 || S > kMaxBands ||
      (inst != kCount && inst != kNearest && inst != kSdf))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (f64 != 0)
    return launch<double>(q, qkeys, p, pkeys, bands, csq, nq, np, S, inst, out,
                          s);
  return launch<float>(q, qkeys, p, pkeys, bands, csq, nq, np, S, inst, out,
                       s);
}

}  // extern "C"
