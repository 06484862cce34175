// m2h_native: host-side graph walker for the AAViSS grid-graph simulator.
//
// The habitat-sim C++ layer the reference depends on is reduced, at train
// time, to (a) grid-graph walking with the Move2Hear movement semantics
// (simulator_train.py:267-353) and (b) geodesic distances over the graph
// (simulator_train.py:488-499). This library provides both, plus a batched
// geodesic lookup that fills the device env's all-pairs table in one call.
//
// Host C++, not a GPU kernel: native/binding.py compiles it with the host
// compiler ($CXX, else g++; -O3 -std=c++17 -shared -fPIC) into _build/ at
// first use and loads it with ctypes.
//
// Movement semantics (the same as env/scene.py's Python rule and the
// reference):
//   direction(a,b) = round(deg(atan2(z_b - z_a, x_b - x_a))) mod 360
//   forward: first neighbor (adjacency order) with direction == orientation,
//            or |direction - orientation| == 45 exactly for non-cardinal
//            directions; stay put if none.
//   orientation = (270 - rotation) mod 360, turns are +/-90 on rotation.
// lround rounds half away from zero where the Python rule's np.around rounds
// half to even: the two part only on a direction of exactly x.5 degrees.
//
// Not thread-safe: the BFS rows are cached lazily in the graph. The binding
// holds the interpreter lock through every call.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Graph {
  int32_t num_nodes;
  std::vector<double> pos;            // (n, 3)
  std::vector<int32_t> adj;           // flattened adjacency
  std::vector<int32_t> adj_off;       // offsets (n + 1)
  // BFS distance cache: one row per source, lazily computed
  std::vector<std::vector<int32_t>> dist_cache;
  std::vector<uint8_t> dist_ready;
};

int32_t edge_direction(const Graph& g, int32_t a, int32_t b) {
  double dx = g.pos[3 * b + 0] - g.pos[3 * a + 0];
  double dz = g.pos[3 * b + 2] - g.pos[3 * a + 2];
  double deg = std::atan2(dz, dx) * 180.0 / M_PI;
  long r = std::lround(deg);
  return static_cast<int32_t>(((r % 360) + 360) % 360);
}

const std::vector<int32_t>& bfs_row(Graph& g, int32_t src) {
  if (!g.dist_ready[src]) {
    std::vector<int32_t>& dist = g.dist_cache[src];
    dist.assign(g.num_nodes, -1);
    dist[src] = 0;
    std::queue<int32_t> q;
    q.push(src);
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      for (int32_t i = g.adj_off[u]; i < g.adj_off[u + 1]; ++i) {
        int32_t v = g.adj[i];
        if (dist[v] < 0) {
          dist[v] = dist[u] + 1;
          q.push(v);
        }
      }
    }
    g.dist_ready[src] = 1;
  }
  return g.dist_cache[src];
}

}  // namespace

extern "C" {

// Create a graph from positions (n x 3 doubles) and CSR adjacency.
void* m2h_graph_create(int32_t num_nodes, const double* positions,
                       const int32_t* adj, const int32_t* adj_off) {
  Graph* g = new Graph();
  g->num_nodes = num_nodes;
  g->pos.assign(positions, positions + 3 * num_nodes);
  g->adj_off.assign(adj_off, adj_off + num_nodes + 1);
  g->adj.assign(adj, adj + adj_off[num_nodes]);
  g->dist_cache.resize(num_nodes);
  g->dist_ready.assign(num_nodes, 0);
  return g;
}

void m2h_graph_destroy(void* handle) { delete static_cast<Graph*>(handle); }

int32_t m2h_shortest_path_steps(void* handle, int32_t a, int32_t b) {
  Graph& g = *static_cast<Graph*>(handle);
  if (a < 0 || b < 0 || a >= g.num_nodes || b >= g.num_nodes) return -1;
  return bfs_row(g, a)[b];
}

int32_t m2h_forward_neighbor(void* handle, int32_t node, int32_t orientation) {
  Graph& g = *static_cast<Graph*>(handle);
  for (int32_t i = g.adj_off[node]; i < g.adj_off[node + 1]; ++i) {
    int32_t nb = g.adj[i];
    int32_t dir = edge_direction(g, node, nb);
    bool cardinal = (dir == 0 || dir == 90 || dir == 180 || dir == 270);
    if (!cardinal) {
      if (std::abs(dir - orientation) == 45) return nb;
    } else if (dir == orientation) {
      return nb;
    }
  }
  return node;
}

// Batched geodesic distances for (a_i, b_i) pairs.
void m2h_geodesic_batch(void* handle, int32_t n, const int32_t* a,
                        const int32_t* b, int32_t* out_steps) {
  Graph& g = *static_cast<Graph*>(handle);
  for (int32_t i = 0; i < n; ++i) {
    out_steps[i] = bfs_row(g, a[i])[b[i]];
  }
}

}  // extern "C"
