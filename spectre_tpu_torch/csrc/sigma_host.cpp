// The copy permutation's cycle merge on the host (keygen's sigma).
//
// halo2's next-pointer merge: for each copy pair (a, b) whose cells lie in
// distinct cycles, the successors of a and b are swapped, which joins the
// two cycles into one; the smaller cycle's cells are relabelled to the
// larger one's representative (ties keep a's). It is the loop of
// plonk/constraint_system.py sigma_targets (its plain version) and of the
// reference's build_sigma, pair for pair, so it yields the same successors.
//
// Cells are numbered 0..k-1; each cycle's members are a singly linked list
// (head, tail, link) so a merge relabels the smaller list and splices it.
// Built with the host compiler at first use (ops/kernel_lib.py) and loaded
// with ctypes.

#include <cstdint>
#include <vector>

extern "C" int spt_sigma_merge(const int64_t* a, const int64_t* b, int64_t pairs,
                               int64_t k, int64_t* nxt) {
  if (k < 0 || k >= (int64_t(1) << 31)) return 1;
  std::vector<int32_t> cyc(k), size(k, 1), head(k), tail(k), link(k, -1);
  for (int64_t i = 0; i < k; ++i) {
    cyc[i] = head[i] = tail[i] = int32_t(i);
    nxt[i] = i;
  }
  for (int64_t p = 0; p < pairs; ++p) {
    const int64_t ca = a[p], cb = b[p];
    if (ca < 0 || ca >= k || cb < 0 || cb >= k) return 2;
    int32_t ia = cyc[ca], ib = cyc[cb];
    if (ia == ib) continue;
    if (size[ia] < size[ib]) { const int32_t t = ia; ia = ib; ib = t; }
    for (int32_t c = head[ib]; c != -1; c = link[c]) cyc[c] = ia;
    link[tail[ia]] = head[ib];
    tail[ia] = tail[ib];
    size[ia] += size[ib];
    const int64_t t = nxt[ca];
    nxt[ca] = nxt[cb];
    nxt[cb] = t;
  }
  return 0;
}
