// K2 on Hopper: per-particle pair sums over key-sorted particles.
//
// Replaces the TPU kernel
// zelll_tpu/ops/pallas_pairs.py::_make_per_particle_kernel (:401, via
// pair_lag_per_particle :515). It computes the same function:
//
//   out_i = sum over unique pairs (p, q = p - lag), lag = 1..L, that hold i,
//           of term(dsq), where
//     key_q >= key_p - W       (candidate key window, W = sum(strides))
//     0 < dsq < csq            (strict cutoff; coincident particles excluded)
//
// with dsq = (d0 d0 + d1 d1) + d2 d2, d = pos_p - pos_q, and term the
// count (1) or LJ 4 t3 (t3 - 1) with t = 1/dsq by true division, t3 = t^3.
// Both ends of a pair receive its term. Coordinates are f32 or f64 and
// the output has their type.
//
// What it does not copy: the TPU kernel's Horner shift accumulator, which
// lands the smaller slot's share of each pair at its window slot because
// Mosaic has no scatter, and its rolling VMEM window and sequential grid.
// K3's design (lag_forces.cu) instead: one thread owns one sorted slot i
// and walks both of its partner lists, backwards over j = i - lag while
// key_j >= key_i - W and forwards over k = i + lag while
// key_i >= key_k - W, each for at most L lags. Keys ascend, so the first
// partner out of window ends a walk, and the per-thread early exit gives
// exactly the TPU kernel's pair set (its block-wide exit only runs more
// lags, all masked); the forward walk stops at lag L too, so an
// undersized L drops the same pairs there. Each out_i is one thread's
// sum: no atomics, and the result is deterministic. The index bounds
// 0 <= j and k < n replace the TPU's spread tail coordinates; padding
// rows (SENTINEL_KEY) read as ascending spaced keys above every real key,
// K1's rule (lag_reduce.cu).
//
// Accumulation: each thread sums its terms in f64, for both coordinate
// types, and writes its sum once in the coordinates' type.
//
// What bounds it on an H100: bytes are (3 coordinate planes + 1 output) x
// n x sizeof(T) + 4 n of keys, 160 MB at n = 1e7 in f32, 48 us at
// 3.35 TB/s. Operations, once per unique pair: 7 FP32 instructions for
// each half-stencil candidate and, per cutoff pair, the term and the two
// f64 adds; at the benchmark's density (~80 candidates and ~13 cutoff
// pairs per slot) that is about 0.2 ms at 33.5 T FP32 instructions/s, so
// it is bound by operations (FP64 runs at half the FP32 rate, and the
// f64 kernel's bound is counted so). This design walks every in-window
// pair from both ends, about 2.7 times the candidate work; a Newton
// half-pair form is left for later, as for K3. No single PyTorch call
// computes this function.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence the pair masks match
// it bitwise on identical sorted inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kTermLj = 0;
constexpr int kTermCount = 1;
constexpr int32_t kSentinelKey = 2147483647;  // INT32_MAX
constexpr int32_t kPadKeyBase = kSentinelKey / 2;

// A padding row's key is replaced by kPadKeyBase + slot * spacing, where
// spacing <= (INT32_MAX - kPadKeyBase - 1) / n keeps it below int32 overflow.
__device__ __forceinline__ int32_t load_key(const int32_t* __restrict__ keys,
                                            int slot, int spacing) {
  const int32_t k = keys[slot];
  return k == kSentinelKey ? kPadKeyBase + slot * spacing : k;
}

template <typename T>
struct Args {
  const T* pos;          // (3, n) planes
  const int32_t* keys;   // (n,) ascending, SENTINEL_KEY rows last
  const int32_t* w_key;  // one int32 on the device
  int n;
  int L;
  int spacing;
  T csq;
  T* out;                // (n,)
};

// The term of the pair (i, j) seen from i, added to i's sum when the pair
// is inside the cutoff and not coincident. The mask selects; nothing
// multiplies by it, so the inf of a masked-out dsq = 0 never reaches a sum.
template <typename T, int TERM>
__device__ __forceinline__ void add_pair(T x, T y, T z, const Args<T>& a,
                                         int64_t j, double& acc) {
  const int64_t n = a.n;
  const T dx = x - a.pos[j];
  const T dy = y - a.pos[n + j];
  const T dz = z - a.pos[2 * n + j];
  T dsq = dx * dx;
  dsq = dsq + dy * dy;
  dsq = dsq + dz * dz;
  if (dsq < a.csq && dsq > T(0)) {
    if (TERM == kTermCount) {
      acc += 1.0;
    } else {
      const T t = T(1) / dsq;
      const T t3 = t * t * t;
      acc += static_cast<double>(T(4) * t3 * (t3 - T(1)));
    }
  }
}

template <typename T, int TERM>
__global__ void __launch_bounds__(kBlock) lag_per_particle_kernel(Args<T> a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const int64_t n = a.n;
  const int32_t w = *a.w_key;
  const int32_t key_i = load_key(a.keys, i, a.spacing);
  const T x = a.pos[i];
  const T y = a.pos[n + i];
  const T z = a.pos[2 * n + i];
  double acc = 0.0;
  // partners behind: pairs (i, j = i - lag), in window iff key_j >= key_i - W
  const int32_t lo_key = key_i - w;
  const int jmin = i > a.L ? i - a.L : 0;
  for (int j = i - 1; j >= jmin; --j) {
    if (load_key(a.keys, j, a.spacing) < lo_key) break;
    add_pair<T, TERM>(x, y, z, a, j, acc);
  }
  // partners ahead: pairs (k = i + lag, i), in window iff key_i >= key_k - W
  const int kmax = a.n - 1 - i > a.L ? i + a.L : a.n - 1;
  for (int k = i + 1; k <= kmax; ++k) {
    if (load_key(a.keys, k, a.spacing) - w > key_i) break;
    add_pair<T, TERM>(x, y, z, a, k, acc);
  }
  a.out[i] = static_cast<T>(acc);
}

template <typename T>
int launch(const void* pos, const void* keys, const void* w_key, int n, int L,
           int spacing, double csq, int term, void* out, cudaStream_t s) {
  Args<T> a;
  a.pos = static_cast<const T*>(pos);
  a.keys = static_cast<const int32_t*>(keys);
  a.w_key = static_cast<const int32_t*>(w_key);
  a.n = n;
  a.L = L;
  a.spacing = spacing;
  a.csq = static_cast<T>(csq);
  a.out = static_cast<T*>(out);
  const int blocks = (n + kBlock - 1) / kBlock;
  if (term == kTermLj)
    lag_per_particle_kernel<T, kTermLj><<<blocks, kBlock, 0, s>>>(a);
  else
    lag_per_particle_kernel<T, kTermCount><<<blocks, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pos: (3, n) planes of float (f64 == 0) or double (f64 != 0); keys: (n,)
// int32 ascending, SENTINEL_KEY rows last; w_key: one int32 on the device;
// spacing: the padding-key spacing, (INT32_MAX - INT32_MAX / 2 - 1) / n at
// least 1; csq: cutoff^2, rounded here to the coordinates' type; term: 0
// for LJ, 1 for the count; out: (n,) of the coordinates' type. Returns
// cudaGetLastError() after the launch.
int zelll_lag_per_particle(const void* pos, const void* keys, const void* w_key,
                           int n, int L, int spacing, double csq, int term,
                           int f64, void* out, void* stream) {
  if (n <= 0 || L < 1 || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      (term != kTermLj && term != kTermCount))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (f64 != 0)
    return launch<double>(pos, keys, w_key, n, L, spacing, csq, term, out, s);
  return launch<float>(pos, keys, w_key, n, L, spacing, csq, term, out, s);
}

}  // extern "C"
