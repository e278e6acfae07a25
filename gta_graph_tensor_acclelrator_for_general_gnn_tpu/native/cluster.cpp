// Asynchronous label-propagation community detection over a symmetrized
// CSR adjacency.  This is the label-free clustering pass that gives REAL
// graphs community locality (a relabelled node order keeps a community's
// gathered rows close together in cache and shrinks partition halos), and
// on real data nobody hands us the subreddit labels — the reference's
// pipeline likewise assumes a pre-clustered node order for its per-tile
// nnz statistics (reference: FinalVersion For Paper/preprocessing.py,
// vTCAD/code/compiler.py:504 maxlist).
//
// Deterministic by construction: single-threaded, node visit order is a
// seeded Fisher-Yates shuffle per sweep, ties break toward the smaller
// label id.  O(E) per sweep via a label-count scratch array with a
// touched-list reset (labels are node ids, so the scratch is n_node wide).
#include <cstdint>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t &s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// row_ptr[n+1] / nbrs[row_ptr[n]]: symmetrized CSR (both edge directions).
// labels[n] (out): community id per node (a representative node id, not
// compacted — the caller compacts).  Returns the number of sweeps run.
int32_t gta_label_prop(const int64_t *row_ptr, const int32_t *nbrs,
                       int64_t n_node, int32_t max_iter, uint64_t seed,
                       int32_t *labels) {
  if (n_node <= 0) return 0;
  for (int64_t i = 0; i < n_node; ++i) labels[i] = static_cast<int32_t>(i);

  std::vector<int64_t> count(n_node, 0);
  std::vector<int32_t> touched;
  touched.reserve(256);
  std::vector<int32_t> order(n_node);
  for (int64_t i = 0; i < n_node; ++i) order[i] = static_cast<int32_t>(i);

  int32_t sweep = 0;
  for (; sweep < max_iter; ++sweep) {
    // seeded Fisher-Yates: a fresh visit order each sweep decorrelates the
    // propagation wavefront from the node numbering
    uint64_t s = seed + 0x51ed2701u * static_cast<uint64_t>(sweep + 1);
    for (int64_t i = n_node - 1; i > 0; --i) {
      int64_t j = static_cast<int64_t>(splitmix64(s) % (i + 1));
      int32_t t = order[i];
      order[i] = order[j];
      order[j] = t;
    }
    int64_t changed = 0;
    for (int64_t k = 0; k < n_node; ++k) {
      const int32_t v = order[k];
      const int64_t lo = row_ptr[v], hi = row_ptr[v + 1];
      if (lo == hi) continue;
      touched.clear();
      for (int64_t e = lo; e < hi; ++e) {
        const int32_t l = labels[nbrs[e]];
        if (count[l] == 0) touched.push_back(l);
        ++count[l];
      }
      // keep the current label in the running so isolated preferences are
      // sticky (standard LPA damping against oscillation)
      int32_t best = labels[v];
      int64_t best_c = count[best];  // 0 when no neighbour shares it
      for (int32_t l : touched) {
        const int64_t c = count[l];
        if (c > best_c || (c == best_c && l < best)) {
          best = l;
          best_c = c;
        }
      }
      for (int32_t l : touched) count[l] = 0;
      if (best != labels[v]) {
        labels[v] = best;
        ++changed;
      }
    }
    if (changed * 1000 < n_node) break;  // <0.1% moved: converged
  }
  return sweep + 1;
}

}  // extern "C"
