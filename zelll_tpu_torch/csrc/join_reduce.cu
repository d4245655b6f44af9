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
// variant (MAXJ). Those are TPU layout and VMEM limits. Here one thread
// owns one sorted query and keeps its n_out accumulators in registers. The
// particles whose key lies in [key_i - hi_s, key_i - lo_s] form one
// contiguous range of the sorted particle array, since keys ascend, so the
// thread finds its 9 ranges by binary search over the particle keys and
// walks them. That visits the same (query, particle) pairs as the TPU
// kernel: counts and minima agree exactly, sums up to the order of
// summation. No atomics, no shared accumulators, and no particle ceiling.
// Queries come sorted, so the threads of a warp mostly share a cell and
// walk the same ranges, and their particle loads coincide.
//
// Queries with the key SENTINEL_KEY (INT32_MAX) take the identity; key
// arithmetic is done in 64 bits, so no band offset can overflow.
// Particle rows with SENTINEL_KEY sort last and lie in no window of a real
// query key.
//
// What bounds it on an H100: bytes are (3 + 1) x nq + (3 + npl + 1) x np
// values in and n_out x nq out, a few MB at the psssh sizes. Operations:
// for every particle in a query's 9 ranges (~1e3 per query at cutoff 10 in
// a protein) the distance and the cutoff test (7 FP32 instructions), and
// for each particle within the cutoff the term (1 for count and nearest,
// ~23 for sdf, two of them exp); so it is bound by operations (FP64 at half
// the FP32 rate). No single PyTorch call computes this function.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math: exp and sqrt
// stay IEEE (no __expf), and the division is true. --fmad=false rounds
// every product and sum on its own, as the plain PyTorch version does, so
// dsq and hence the cutoff masks match it bitwise on identical inputs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxBands = 9;
constexpr int32_t kSentinelKey = 2147483647;  // INT32_MAX

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

// The SDF term of one particle inside the cutoff, in the order of
// operations of ops/sdf_join.py::sdf_term. A particle at d == 0 takes the
// constant branch, so 1/sqrt(0) is never formed.
template <typename T>
__device__ __forceinline__ void add_sdf(T dsq, T d0, T d1, T d2, T r, T rinv,
                                        T* acc) {
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

template <typename T, int INST>
__global__ void __launch_bounds__(kBlock) join_kernel(Args<T> a) {
  constexpr int kOut = Inst<INST>::kOut;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.nq) return;
  const int64_t nq = a.nq;
  const int64_t np = a.np;
  T acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k)
    acc[k] = INST == kNearest ? T(INFINITY) : T(0);

  const int32_t key = a.qkeys[i];
  if (key != kSentinelKey) {
    const T qx = a.q[i];
    const T qy = a.q[nq + i];
    const T qz = a.q[2 * nq + i];
    const T csq = *a.csq;
    for (int s = 0; s < a.S; ++s) {
      // partner keys key - hi_s .. key - lo_s: one contiguous range
      const int64_t lo_key = static_cast<int64_t>(key) - a.bands[2 * s + 1];
      const int64_t hi_key = static_cast<int64_t>(key) - a.bands[2 * s];
      const int jb = lower_bound(a.pkeys, 0, a.np, lo_key);
      const int je = upper_bound(a.pkeys, jb, a.np, hi_key);
      for (int j = jb; j < je; ++j) {
        const T d0 = qx - a.p[j];
        const T d1 = qy - a.p[np + j];
        const T d2 = qz - a.p[2 * np + j];
        T dsq = d0 * d0;
        dsq = dsq + d1 * d1;
        dsq = dsq + d2 * d2;
        if (!(dsq <= csq)) continue;
        if constexpr (INST == kCount) {
          acc[0] += T(1);
        } else if constexpr (INST == kNearest) {
          acc[0] = dsq < acc[0] ? dsq : acc[0];
        } else {
          add_sdf(dsq, d0, d1, d2, a.p[3 * np + j], a.p[4 * np + j], acc);
        }
      }
    }
  }
  T* out = a.out + static_cast<int64_t>(i) * kOut;
#pragma unroll
  for (int k = 0; k < kOut; ++k) out[k] = acc[k];
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
  const int blocks = (nq + kBlock - 1) / kBlock;
  if (inst == kCount)
    join_kernel<T, kCount><<<blocks, kBlock, 0, stream>>>(a);
  else if (inst == kNearest)
    join_kernel<T, kNearest><<<blocks, kBlock, 0, stream>>>(a);
  else
    join_kernel<T, kSdf><<<blocks, kBlock, 0, stream>>>(a);
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
