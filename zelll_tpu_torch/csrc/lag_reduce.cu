// K1 on Hopper: the lag-window pair reduction over key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/pallas_pairs.py::_make_kernel (via
// pair_lag_reduce). It computes the same function:
//
//   sum over slots i and lags 1..L, j = i - lag >= 0, of term(dsq(i, j))
//   where key_j >= key_i - W  (candidate key window, W = sum(strides))
//     and dsq < csq           (strict cutoff)
//
// with dsq accumulated from 0 axis by axis, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j). Terms: LJ 4 t3 (t3 - 1),
// t = 1/dsq by true division, or count (1). There is no dsq > 0 exclusion:
// coincident real particles count, as in the reference.
//
// What it does not copy: the TPU kernel's rolling VMEM window, lane rolls and
// sequential grid are Mosaic devices. Here one thread owns one sorted slot i
// and walks its lags downwards; keys ascend, so the first j with
// key_j < key_i - W ends that thread's loop exactly, and the loop also stops
// at lag L even while the window is still open (as the TPU kernel does).
// The index bound j >= 0 replaces the TPU's tail padding. Padding rows
// (SENTINEL_KEY, sorted last) read as ascending spaced keys above every real
// key, the key rule of pallas_pairs.py::_pad_and_desentinel with no tail
// padding, so they end the key window instead of holding it open.
//
// Accumulation: each thread sums its f32 terms in f64 (as good as the TPU's
// per-lane f32 Kahan sum, and simpler); the block folds its threads in f64
// with warp shuffles in a fixed order and writes one partial per block. The
// caller sums the partials (the analogue of the jnp.sum outside the TPU
// kernel). No float atomics, so the result is deterministic. Integer terms
// sum in int64 per block, so counts cannot wrap at n = 1e8.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n, read once: 280 MB at n = 1e7 in split mode, 84 us at
// 3.35 TB/s. Operations, counted as FP32 instructions with FMA contraction
// allowed: 13 for each candidate pair in the key window (7 without split)
// plus 12 for each pair inside the cutoff (the IEEE division, the LJ term
// and the f64 add). The benchmark's thin box has 122.8 candidates and 16
// cutoff pairs per slot (chip_smoke.py counts them on the card), 1.8e10
// instructions at n = 1e7: 0.53 ms at 33.5 T instructions/s (the 67 TFLOP/s
// f32 peak counts an FMA as two). So it is bound by operations, and the
// design keeps every operation in registers; the j-side reads hit L1/L2,
// since neighbouring threads read neighbouring slots. --fmad=false (below)
// gives up the contraction, so the kernel runs more than the bound
// counts. No single PyTorch call computes this function, so there is no
// library time to compare with.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence pair counts match it
// bitwise on identical sorted inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxDim = 3;
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

template <int TERM>
__device__ __forceinline__ float term_value(float dsq) {
  if (TERM == kTermLj) {
    const float t = 1.0f / dsq;
    const float t3 = t * t * t;
    return 4.0f * t3 * (t3 - 1.0f);
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
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool SPLIT, int TERM, typename Acc>
__global__ void __launch_bounds__(kBlock)
lag_reduce_kernel(const float* __restrict__ pos, const float* __restrict__ lo,
                  const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ w_key, int n, int dim, int L,
                  int spacing, float csq, Acc* __restrict__ partial) {
  __shared__ Acc warp_sums[kBlock / 32];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Acc acc = 0;
  if (i < n) {
    const int32_t lo_key = load_key(keys, i, spacing) - *w_key;
    float own[kMaxDim], own_lo[kMaxDim];
#pragma unroll
    for (int a = 0; a < kMaxDim; ++a) {
      if (a < dim) {
        own[a] = pos[static_cast<int64_t>(i) * dim + a];
        if (SPLIT) own_lo[a] = lo[static_cast<int64_t>(i) * dim + a];
      }
    }
    const int jmin = i > L ? i - L : 0;
    for (int j = i - 1; j >= jmin; --j) {
      if (load_key(keys, j, spacing) < lo_key) break;
      const int64_t jo = static_cast<int64_t>(j) * dim;
      float dsq = 0.0f;
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) {
        if (a < dim) {
          float d = own[a] - pos[jo + a];
          if (SPLIT) d = d + (own_lo[a] - lo[jo + a]);
          dsq = dsq + d * d;
        }
      }
      if (dsq < csq) acc += to_acc<Acc>(term_value<TERM>(dsq));
    }
  }
  // fixed-order block fold: warps, then the warp sums in warp 0
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kBlock / 32 ? warp_sums[lane] : Acc(0);
    acc = warp_sum(acc);
    if (lane == 0) partial[blockIdx.x] = acc;
  }
}

template <bool SPLIT, int TERM>
void launch(const float* pos, const float* lo, const int32_t* keys,
            const int32_t* w_key, int n, int dim, int L, int spacing,
            float csq, bool int_out, void* partial, cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  if (int_out) {
    lag_reduce_kernel<SPLIT, TERM, long long><<<blocks, kBlock, 0, stream>>>(
        pos, lo, keys, w_key, n, dim, L, spacing, csq,
        static_cast<long long*>(partial));
  } else {
    lag_reduce_kernel<SPLIT, TERM, double><<<blocks, kBlock, 0, stream>>>(
        pos, lo, keys, w_key, n, dim, L, spacing, csq,
        static_cast<double*>(partial));
  }
}

}  // namespace

extern "C" {

// Threads per block: the caller allocates ceil(n / block) partials.
int zelll_lag_reduce_block() { return kBlock; }

// pos, lo: (n, dim) row-major f32 (lo null unless split); keys: (n,) int32
// ascending, SENTINEL_KEY rows last; w_key: one int32 on the device;
// spacing: the padding-key spacing, (INT32_MAX - INT32_MAX / 2 - 1) / n at
// least 1; partial: ceil(n / block) doubles (int_out == 0) or int64s
// (int_out != 0). Returns cudaGetLastError() after the launch.
int zelll_lag_reduce(const void* pos, const void* lo, const void* keys,
                     const void* w_key, int n, int dim, int L, int spacing,
                     float csq, int term, int int_out, void* partial,
                     void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || L < 1 || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      (term != kTermLj && term != kTermCount))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(pos);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* w = static_cast<const int32_t*>(w_key);
  auto s = static_cast<cudaStream_t>(stream);
  const bool io = int_out != 0;
  if (l != nullptr) {
    if (term == kTermLj)
      launch<true, kTermLj>(p, l, k, w, n, dim, L, spacing, csq, io, partial, s);
    else
      launch<true, kTermCount>(p, l, k, w, n, dim, L, spacing, csq, io, partial,
                               s);
  } else {
    if (term == kTermLj)
      launch<false, kTermLj>(p, l, k, w, n, dim, L, spacing, csq, io, partial,
                            s);
    else
      launch<false, kTermCount>(p, l, k, w, n, dim, L, spacing, csq, io,
                                partial, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
