// Exact k-let-preserving sequence shuffling (uShuffle algorithm), native host
// implementation.
//
// Semantics match the reference's shuffler (reference src/ushuffle.c:80-270):
// build the (k-1)-let transition multigraph of the input, draw a uniform
// random arborescence rooted at the terminal vertex (Wilson's loop-erased
// random walks), randomly order each vertex's out-edge multiset with the
// arborescence edge last, and emit the Euler walk starting from the initial
// vertex.  Every k-let count of the output equals that of the input; for k=2
// this is the dinucleotide-preserving null model of the z-score mode
// (reference src/ractip.cpp:1638-1643).
//
// This is the host-side hot loop of z-score batches (thousands of shuffles
// feeding one batched TPU dispatch), hence native C++ with a batched entry
// point.  RNG is deterministic given the seed (splitmix64-seeded
// xoshiro256**), independent of libc.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 expansion of the seed into xoshiro256** state
    uint64_t x = seed;
    for (auto& si : s) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      si = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform integer in [0, n) without modulo bias
  uint64_t below(uint64_t n) {
    if (n <= 1) return 0;
    const uint64_t limit = UINT64_MAX - UINT64_MAX % n;
    uint64_t v;
    do {
      v = next();
    } while (v >= limit);
    return v % n;
  }
};

// One shuffle of seq[0..n) with k-let preservation into out[0..n).
void shuffle_one(const char* seq, int n, int k, Rng& rng, char* out) {
  if (k >= n) {  // k-let == whole sequence: identity
    std::memcpy(out, seq, static_cast<size_t>(n));
    return;
  }
  if (k <= 1) {  // plain Fisher-Yates permutation
    std::memcpy(out, seq, static_cast<size_t>(n));
    for (int i = n - 1; i > 0; --i) {
      int j = static_cast<int>(rng.below(static_cast<uint64_t>(i) + 1));
      std::swap(out[i], out[j]);
    }
    return;
  }

  const int klm1 = k - 1;
  const int nwalk = n - k + 2;  // number of (k-1)-let occurrences

  // vertex ids for distinct (k-1)-lets, in order of first appearance
  std::unordered_map<std::string, int> vid;
  std::vector<std::string> verts;
  std::vector<int> path(nwalk);
  vid.reserve(static_cast<size_t>(nwalk) * 2);
  for (int i = 0; i < nwalk; ++i) {
    std::string key(seq + i, static_cast<size_t>(klm1));
    auto it = vid.find(key);
    if (it == vid.end()) {
      it = vid.emplace(std::move(key), static_cast<int>(verts.size())).first;
      verts.push_back(std::string(seq + i, static_cast<size_t>(klm1)));
    }
    path[i] = it->second;
  }
  const int nv = static_cast<int>(verts.size());
  const int root = path[nwalk - 1];

  std::vector<std::vector<int>> out_edges(static_cast<size_t>(nv));
  for (int i = 0; i + 1 < nwalk; ++i)
    out_edges[static_cast<size_t>(path[i])].push_back(path[i + 1]);

  // Wilson: uniform random arborescence toward root.  Picking a uniform
  // out-EDGE gives successor probability proportional to edge multiplicity.
  std::vector<int> next_v(static_cast<size_t>(nv), -1);
  std::vector<char> in_tree(static_cast<size_t>(nv), 0);
  in_tree[static_cast<size_t>(root)] = 1;
  for (int v0 = 0; v0 < nv; ++v0) {
    int v = v0;
    while (!in_tree[static_cast<size_t>(v)]) {  // loop-erased random walk
      const auto& e = out_edges[static_cast<size_t>(v)];
      next_v[static_cast<size_t>(v)] =
          e[rng.below(static_cast<uint64_t>(e.size()))];
      v = next_v[static_cast<size_t>(v)];
    }
    v = v0;
    while (!in_tree[static_cast<size_t>(v)]) {
      in_tree[static_cast<size_t>(v)] = 1;
      v = next_v[static_cast<size_t>(v)];
    }
  }

  // Random out-edge order per vertex; the arborescence edge goes last so the
  // walk from path[0] is a valid Euler path consuming every edge.
  for (int v = 0; v < nv; ++v) {
    auto& e = out_edges[static_cast<size_t>(v)];
    for (int i = static_cast<int>(e.size()) - 1; i > 0; --i) {
      int j = static_cast<int>(rng.below(static_cast<uint64_t>(i) + 1));
      std::swap(e[static_cast<size_t>(i)], e[static_cast<size_t>(j)]);
    }
    if (v != root && !e.empty()) {
      const int t = next_v[static_cast<size_t>(v)];
      for (int i = static_cast<int>(e.size()) - 1; i >= 0; --i) {
        if (e[static_cast<size_t>(i)] == t) {
          std::swap(e[static_cast<size_t>(i)], e.back());
          break;
        }
      }
    }
  }

  // Euler walk; rebuild the sequence from the vertex labels.
  std::vector<int> pos(static_cast<size_t>(nv), 0);
  int v = path[0];
  std::memcpy(out, verts[static_cast<size_t>(v)].data(),
              static_cast<size_t>(klm1));
  int written = klm1;
  for (int step = 0; step + 1 < nwalk; ++step) {
    const int u = out_edges[static_cast<size_t>(v)]
                           [static_cast<size_t>(pos[static_cast<size_t>(v)]++)];
    out[written++] = verts[static_cast<size_t>(u)].back();
    v = u;
  }
  // written == klm1 + nwalk - 1 == n
}

}  // namespace

extern "C" {

// Shuffle `count` independent replicates of seq[0..n).  out must hold
// count*n bytes (replicate r at out + r*n).  Deterministic in (seed, r).
// Returns 0 on success, -1 on bad arguments.
int rt_ushuffle_batch(const char* seq, int n, int k, uint64_t seed, int count,
                      char* out) {
  if (!seq || !out || n <= 0 || count <= 0) return -1;
  for (int r = 0; r < count; ++r) {
    // decorrelate replicates: distinct stream per (seed, r)
    Rng rng(seed ^ (0x9e3779b97f4a7c15ULL * static_cast<uint64_t>(r + 1)));
    shuffle_one(seq, n, k, rng, out + static_cast<size_t>(r) * n);
  }
  return 0;
}

int rt_ushuffle(const char* seq, int n, int k, uint64_t seed, char* out) {
  return rt_ushuffle_batch(seq, n, k, seed, 1, out);
}

}  // extern "C"
