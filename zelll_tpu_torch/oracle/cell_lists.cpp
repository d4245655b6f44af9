// Host-native cell-lists oracle: exact f64 reference implementation used to
// validate the engine at particle counts where an O(n^2) check is
// infeasible (the port's copy of zelll_tpu/oracle/cell_lists.cpp). Independent C++ implementation of the same algorithm spec as
// the Rust reference (zelll src/cellgrid.rs counting-sort build,
// src/cellgrid/iters.rs half-space pair iteration): grid edge = cutoff,
// strides with +4 padding per axis, lexicographic 3^3-1 stencil with the
// first half used for unique pair enumeration, LJ filter dsq < cutoff^2.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct Grid {
  double origin[3];
  double cutoff;
  int32_t shape[3];
  int64_t strides[3];
  std::unordered_map<int64_t, std::vector<int32_t>> cells;
  std::vector<int64_t> keys;  // per-particle flat key, input order
  int64_t half_stencil[13];
  int64_t full_stencil[26];

  void build(const double* pos, int64_t n, double cut) {
    cutoff = cut;
    double inf[3], sup[3];
    for (int a = 0; a < 3; ++a) inf[a] = sup[a] = n ? pos[a] : 0.0;
    for (int64_t i = 1; i < n; ++i)
      for (int a = 0; a < 3; ++a) {
        double v = pos[3 * i + a];
        if (v < inf[a]) inf[a] = v;
        if (v > sup[a]) sup[a] = v;
      }
    int64_t padded[3];
    for (int a = 0; a < 3; ++a) {
      origin[a] = inf[a];
      shape[a] =
          static_cast<int32_t>(std::floor((sup[a] - inf[a]) / cutoff)) + 1;
      padded[a] = shape[a] + 4;
    }
    strides[0] = 1;
    strides[1] = padded[0];
    strides[2] = padded[0] * padded[1];

    // lexicographic cartesian product of (-1,0,1)^3, axis 0 slowest,
    // center removed; half stencil = first 13
    int s = 0;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          if (dx == 0 && dy == 0 && dz == 0) continue;
          full_stencil[s++] =
              dx * strides[0] + dy * strides[1] + dz * strides[2];
        }
    for (int k = 0; k < 13; ++k) half_stencil[k] = full_stencil[k];

    keys.resize(n);
    cells.clear();
    cells.reserve(static_cast<size_t>(n / 4 + 16));
    for (int64_t i = 0; i < n; ++i) {
      int64_t key = 0;
      for (int a = 0; a < 3; ++a)
        key += static_cast<int64_t>(
                   std::floor((pos[3 * i + a] - origin[a]) / cutoff)) *
               strides[a];
      keys[i] = key;
      cells[key].push_back(static_cast<int32_t>(i));
    }
  }

  int64_t flat_key(const double* q) const {
    int64_t key = 0;
    for (int a = 0; a < 3; ++a)
      key += static_cast<int64_t>(std::floor((q[a] - origin[a]) / cutoff)) *
             strides[a];
    return key;
  }

  bool try_cell_index(const double* q) const {
    for (int a = 0; a < 3; ++a) {
      auto idx =
          static_cast<int64_t>(std::floor((q[a] - origin[a]) / cutoff));
      if (idx < -1 || idx > shape[a]) return false;
    }
    return true;
  }
};

inline double dist_sq(const double* pos, int64_t i, int64_t j) {
  double s = 0.0;
  for (int a = 0; a < 3; ++a) {
    double d = pos[3 * i + a] - pos[3 * j + a];
    s += d * d;
  }
  return s;
}

inline double lj(double dsq) {
  double t = 1.0 / (dsq * dsq * dsq);
  return 4.0 * t * (t - 1.0);
}

template <typename F>
void for_each_half_pair(const Grid& g, F&& fn) {
  for (const auto& [key, members] : g.cells) {
    // intra-cell triangular pairs
    for (size_t a = 0; a < members.size(); ++a)
      for (size_t b = a + 1; b < members.size(); ++b)
        fn(members[a], members[b]);
    // half-space neighbor cells
    for (int s = 0; s < 13; ++s) {
      auto it = g.cells.find(key + g.half_stencil[s]);
      if (it == g.cells.end()) continue;
      for (int32_t i : members)
        for (int32_t j : it->second) fn(i, j);
    }
  }
}

}  // namespace

extern "C" {

// Build + fused LJ reduction over cutoff-filtered unique pairs.
void zelll_oracle_lj(const double* pos, int64_t n, double cutoff,
                     double* energy_out, int64_t* pairs_out) {
  Grid g;
  g.build(pos, n, cutoff);
  double csq = cutoff * cutoff;
  double energy = 0.0;
  int64_t pairs = 0;
  for_each_half_pair(g, [&](int32_t i, int32_t j) {
    double dsq = dist_sq(pos, i, j);
    if (dsq < csq) {
      energy += lj(dsq);
      ++pairs;
    }
  });
  *energy_out = energy;
  *pairs_out = pairs;
}

// Materialize cutoff-filtered unique pairs. Returns the total count (may
// exceed cap; only the first cap pairs are written).
int64_t zelll_oracle_pairs(const double* pos, int64_t n, double cutoff,
                           int32_t* i_out, int32_t* j_out, int64_t cap) {
  Grid g;
  g.build(pos, n, cutoff);
  double csq = cutoff * cutoff;
  int64_t count = 0;
  for_each_half_pair(g, [&](int32_t i, int32_t j) {
    if (dist_sq(pos, i, j) < csq) {
      if (count < cap) {
        i_out[count] = i;
        j_out[count] = j;
      }
      ++count;
    }
  });
  return count;
}

// Full-space neighborhood candidates of a query point against a built grid
// (query_neighbors semantics: own cell + 26 neighbors, no distance filter),
// written to out up to cap. Returns the count, or -1 if the query is too
// far outside the grid (None analogue).
static int64_t query_into(const Grid& g, const double* q, int32_t* out,
                          int64_t cap) {
  if (!g.try_cell_index(q)) return -1;
  int64_t key = g.flat_key(q);
  int64_t count = 0;
  auto emit = [&](int64_t k) {
    auto it = g.cells.find(k);
    if (it == g.cells.end()) return;
    for (int32_t i : it->second) {
      if (count < cap) out[count] = i;
      ++count;
    }
  };
  emit(key);
  for (int s = 0; s < 26; ++s) emit(key + g.full_stencil[s]);
  return count;
}

int64_t zelll_oracle_query(const double* pos, int64_t n, double cutoff,
                           const double* q, int32_t* out, int64_t cap) {
  Grid g;
  g.build(pos, n, cutoff);
  return query_into(g, q, out, cap);
}

// The candidates of nq query points against one grid build: counts[k] is
// query k's count (-1: too far outside), and the ids follow one another
// in out (up to cap in all). Returns the number of ids needed.
int64_t zelll_oracle_query_batch(const double* pos, int64_t n, double cutoff,
                                 const double* qs, int64_t nq, int64_t* counts,
                                 int32_t* out, int64_t cap) {
  Grid g;
  g.build(pos, n, cutoff);
  int64_t total = 0;
  for (int64_t k = 0; k < nq; ++k) {
    const int64_t room = total < cap ? cap - total : 0;
    const int64_t c = query_into(g, qs + 3 * k, out + (room ? total : 0), room);
    counts[k] = c;
    if (c > 0) total += c;
  }
  return total;
}

// ChaCha12 u64 stream (rand 0.8 StdRng layout: 64-bit block counter in
// words 12-13, stream id 0) — the native fast path for benchmark data
// generation (bit-identical to the numpy implementation in
// zelll_tpu/utils/datagen.py, which documents the algorithm spec).
static inline uint32_t rotl32(uint32_t x, int k) {
  return (x << k) | (x >> (32 - k));
}

void zelll_chacha12_u64(const uint32_t* key, uint64_t start_u32, int64_t n,
                        uint64_t* out) {
  // produces n next_u64 outputs starting at u32-stream offset start_u32
  // (must be even, as in the rand BlockRng usage pattern)
  static const uint32_t SIGMA[4] = {0x61707865u, 0x3320646eu, 0x79622d32u,
                                    0x6b206574u};
  int64_t produced = 0;
  uint64_t block = start_u32 / 16;
  int off = static_cast<int>(start_u32 % 16);
  while (produced < n) {
    uint32_t s[16], x[16];
    for (int i = 0; i < 4; ++i) s[i] = SIGMA[i];
    for (int i = 0; i < 8; ++i) s[4 + i] = key[i];
    s[12] = static_cast<uint32_t>(block & 0xffffffffu);
    s[13] = static_cast<uint32_t>(block >> 32);
    s[14] = 0;
    s[15] = 0;
    for (int i = 0; i < 16; ++i) x[i] = s[i];
#define QR(a, b, c, d)                          \
  x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16); \
  x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12); \
  x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);  \
  x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7);
    for (int r = 0; r < 6; ++r) {
      QR(0, 4, 8, 12) QR(1, 5, 9, 13) QR(2, 6, 10, 14) QR(3, 7, 11, 15)
      QR(0, 5, 10, 15) QR(1, 6, 11, 12) QR(2, 7, 8, 13) QR(3, 4, 9, 14)
    }
#undef QR
    for (int i = 0; i < 16; ++i) x[i] += s[i];
    while (off + 1 < 16 && produced < n) {
      out[produced++] =
          static_cast<uint64_t>(x[off]) |
          (static_cast<uint64_t>(x[off + 1]) << 32);
      off += 2;
    }
    if (off >= 15) {
      off = 0;
      ++block;
    }
  }
}

// Per-particle LJ forces over cutoff pairs (Newton's third law).
void zelll_oracle_forces(const double* pos, int64_t n, double cutoff,
                         double* forces_out) {
  Grid g;
  g.build(pos, n, cutoff);
  double csq = cutoff * cutoff;
  for (int64_t i = 0; i < 3 * n; ++i) forces_out[i] = 0.0;
  for_each_half_pair(g, [&](int32_t i, int32_t j) {
    double dsq = dist_sq(pos, i, j);
    if (dsq >= csq) return;
    double inv = 1.0 / dsq;
    double t = inv * inv * inv;
    double f = 24.0 * t * (2.0 * t - 1.0) * inv;
    for (int a = 0; a < 3; ++a) {
      double d = pos[3 * i + a] - pos[3 * j + a];
      forces_out[3 * i + a] += f * d;
      forces_out[3 * j + a] -= f * d;
    }
  });
}
}
