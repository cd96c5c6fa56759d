// One hop of the neighbourhood sampler's uniform fanout draw, on the host.
//
// Replaces the per-vertex Python loop of
// repro_torch/graphs/sampler.py NeighborSampler._sample_neighbors, which
// calls numpy's Generator.choice(nbrs, size=fanout, replace=False) once a
// vertex.  The blocks must stay byte-identical to that loop (and to the
// JAX sampler it copies), so this pass draws from the caller's own numpy
// bit generator, through its next_uint32, exactly as numpy 2's choice
// does for a population of at most 10000 or a fanout of at most a
// fiftieth of it:
//
//   Floyd's algorithm: for j in [pop - fanout, pop), v = bounded(j); if v
//   was picked before, pick j instead;
//   then a Fisher-Yates shuffle of the picks: for i from fanout - 1 down
//   to 1, swap pick i with pick bounded(i);
//
// where bounded(r), a value in [0, r], is numpy's
// buffered_bounded_lemire_uint32 (bounded(0) draws nothing).  The
// generator is left in the state the loop would leave, half-used 64-bit
// word included, since the next epoch's shuffle draws from it.
//
// numpy's other branch (a tail shuffle of the whole population, taken
// when pop > 10000 and fanout > pop / 50) is not replayed: the pass stops
// before such a vertex and reports its frontier position; the caller
// draws it with rng.choice and resumes after it.
//
// Plain C interface, one argument struct, no PyTorch headers; built with
// the host C++ compiler by repro_torch/kernels/_host.py.

#include <cstdint>
#include <vector>

namespace {

typedef uint32_t (*NextUint32)(void*);

// Field order and types follow _DrawArgs in repro_torch/graphs/sampler.py.
struct DrawArgs {
  const int64_t* frontier;  // shard-local ids of the hop's frontier
  int64_t n_frontier;
  int64_t start;            // first frontier position to draw
  const int64_t* indptr;    // (num_local + 1,) in-edges of local vertices
  const int32_t* indices;   // neighbours, shard-local ids
  int64_t num_local;
  int64_t fanout;
  int64_t local_only;       // keep only local neighbours (the last hop)
  int64_t* out_src;         // (n_frontier * fanout,) neighbour ids
  int64_t* out_dst;         // (n_frontier * fanout,) frontier ids
  int64_t n_written;        // edges already in out_src / out_dst
  int64_t n_drawn;          // out: vertices whose picks were drawn
  int64_t stop;             // out: position stopped at, n_frontier if none
  void* state;              // the numpy bit generator's state
  NextUint32 next_uint32;   // and its next_uint32
};

// numpy's random_bounded_uint64(state, 0, rng, 0, false) for rng below
// 2^32 - 1: buffered_bounded_lemire_uint32 without a buffer.
inline uint32_t bounded(const DrawArgs& a, uint32_t rng) {
  if (rng == 0) return 0;
  const uint32_t rng_excl = rng + 1;
  uint64_t m = static_cast<uint64_t>(a.next_uint32(a.state)) * rng_excl;
  uint32_t leftover = static_cast<uint32_t>(m);
  if (leftover < rng_excl) {
    const uint32_t threshold = (UINT32_MAX - rng) % rng_excl;
    while (leftover < threshold) {
      m = static_cast<uint64_t>(a.next_uint32(a.state)) * rng_excl;
      leftover = static_cast<uint32_t>(m);
    }
  }
  return static_cast<uint32_t>(m >> 32);
}

}  // namespace

// Draws the frontier from position `start` on, in frontier order, and
// returns the count of edges in out_src / out_dst.
extern "C" int64_t neighbor_draw(DrawArgs* a) {
  const int64_t fanout = a->fanout;
  std::vector<int32_t> kept;      // the local neighbours when local_only
  std::vector<uint32_t> stamp;    // stamp[v] == mark: position v picked
  std::vector<int64_t> picks(fanout > 0 ? fanout : 0);
  uint32_t mark = 0;
  int64_t n = a->n_written;
  int64_t drawn = 0;
  int64_t q = a->start;
  for (; q < a->n_frontier; ++q) {
    const int64_t u = a->frontier[q];
    if (u >= a->num_local) continue;  // remote: its path terminates
    const int32_t* nbrs = a->indices + a->indptr[u];
    int64_t pop = a->indptr[u + 1] - a->indptr[u];
    if (a->local_only) {            // without a branch: locals are mixed
      if (static_cast<int64_t>(kept.size()) < pop) kept.resize(pop);
      int64_t k = 0;
      for (int64_t i = 0; i < pop; ++i) {
        kept[k] = nbrs[i];
        k += nbrs[i] < a->num_local;
      }
      nbrs = kept.data();
      pop = k;
    }
    if (pop <= fanout) {            // all of them, in order, no draw
      for (int64_t i = 0; i < pop; ++i) {
        a->out_src[n] = nbrs[i];
        a->out_dst[n++] = u;
      }
      continue;
    }
    if (pop > 10000 && fanout > pop / 50) break;  // numpy's tail shuffle
    if (static_cast<int64_t>(stamp.size()) < pop) stamp.resize(pop, 0);
    ++mark;                         // under 2^32 vertices a call
    for (int64_t j = pop - fanout; j < pop; ++j) {
      int64_t v = bounded(*a, static_cast<uint32_t>(j));
      if (stamp[v] == mark) v = j;
      stamp[v] = mark;
      picks[j - (pop - fanout)] = v;
    }
    for (int64_t i = fanout - 1; i > 0; --i) {
      const int64_t k = bounded(*a, static_cast<uint32_t>(i));
      const int64_t t = picks[k];
      picks[k] = picks[i];
      picks[i] = t;
    }
    for (int64_t i = 0; i < fanout; ++i) {
      a->out_src[n] = nbrs[picks[i]];
      a->out_dst[n++] = u;
    }
    ++drawn;
  }
  a->n_drawn = drawn;
  a->stop = q;
  return n;
}
