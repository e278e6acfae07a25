// Native graph preprocessing: receiver sort and degree counts.
//
// The reference framework is pure Python (SURVEY §2: no native code exists
// in it).  This framework builds receiver-sorted edge lists at Reddit scale
// (114M edges), where numpy's argsort costs tens of seconds; the counting
// sort here is two O(E) passes and stable, so both paths produce identical
// graphs.
//
// Build: make -C gta_graph_tensor_acclelrator_for_general_gnn_tpu/native
// Loaded via ctypes (native/__init__.py); every entry point is plain C ABI.

#include <cstdint>

extern "C" {

// Counting sort of edges by receiver (the GraphTensor invariant).  counts
// must be zeroed, length n_node+1; order_out gets the stable permutation.
void gta_sort_by_receiver(const int32_t* receivers, int64_t ne,
                          int32_t n_node, int64_t* counts,
                          int64_t* order_out) {
  for (int64_t e = 0; e < ne; ++e) counts[receivers[e]]++;
  int64_t run = 0;
  for (int32_t v = 0; v <= n_node; ++v) {
    int64_t c = counts[v];
    counts[v] = run;
    run += c;
  }
  for (int64_t e = 0; e < ne; ++e) order_out[counts[receivers[e]]++] = e;
}

// In/out degree accumulation (for symmetric normalisation).
void gta_degrees(const int32_t* senders, const int32_t* receivers, int64_t ne,
                 double* out_deg, double* in_deg) {
  for (int64_t e = 0; e < ne; ++e) {
    out_deg[senders[e]] += 1.0;
    in_deg[receivers[e]] += 1.0;
  }
}

}  // extern "C"
