// Host-side segment-tree builder for the non-local cost aggregation path.
//
// TPU-native split of the reference's CSegmentTree::BuildSegmentTree
// (STMatching/SegmentTree.cpp:38-139) + Felzenszwalb-Huttenlocher
// segmentation (STMatching/segment-graph.h): the spanning-tree construction
// is irreducibly sequential (sorted-edge union-find scans), so it runs here
// in C++ on the host; it emits flat arrays (BFS order, parents, quantized
// edge distances, per-depth level offsets, DFS intervals) that drive the
// massively parallel tree-scan aggregation kernels on the TPU.
//
// Semantics intentionally matched to the reference:
//  * 4-connected grid edges, enumerated right then up per pixel
//    (SegmentTree.cpp:44-62), with caller-provided weights;
//  * edges sorted ascending by (w, b, a) (SegmentTree.h edge::operator<);
//  * FH criterion: join when w <= min(threshold[a], threshold[b]), with
//    threshold update w + tau/size (segment-graph.h:62-79);
//  * a second scan joins the remaining components into a single spanning
//    tree, adding `penalty` to the weight of cross-segment edges whose
//    smaller side exceeds `min_size` (segment-graph.h:82-96);
//  * per-edge distance quantization min(int(w*scale+0.5), 255)
//    (SegmentTree.cpp:80);
//  * BFS from node 0 defines the node ordering (SegmentTree.cpp:97-132).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsegtree.so segment_tree.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Edge {
  float w;
  int32_t a;
  int32_t b;
};

inline bool edge_less(const Edge& x, const Edge& y) {
  if (x.w != y.w) return x.w < y.w;
  if (x.b != y.b) return x.b < y.b;
  return x.a < y.a;
}

class DisjointSet {
 public:
  explicit DisjointSet(int n) : parent_(n), rank_(n, 0), size_(n, 1) {
    for (int i = 0; i < n; ++i) parent_[i] = i;
  }
  int find(int x) {
    int root = x;
    while (root != parent_[root]) root = parent_[root];
    while (x != root) {
      int next = parent_[x];
      parent_[x] = root;
      x = next;
    }
    return root;
  }
  // Union by rank; returns the new root.
  int join(int x, int y) {
    x = find(x);
    y = find(y);
    if (x == y) return x;
    if (rank_[x] > rank_[y]) std::swap(x, y);
    parent_[x] = y;
    size_[y] += size_[x];
    if (rank_[x] == rank_[y]) ++rank_[y];
    return y;
  }
  int size(int x) { return size_[find(x)]; }

 private:
  std::vector<int> parent_;
  std::vector<int> rank_;
  std::vector<int> size_;
};

}  // namespace

extern "C" {

// Number of grid edges for an H x W image (right + up neighbors).
int32_t gsm_num_edges(int32_t height, int32_t width) {
  return 2 * height * width - height - width;
}

// Fill (a, b) endpoints for the canonical edge enumeration. Buffers of
// length gsm_num_edges().
void gsm_grid_edges(int32_t height, int32_t width, int32_t* ea, int32_t* eb) {
  int32_t n = 0;
  for (int32_t y = 0; y < height; ++y) {
    for (int32_t x = 0; x < width; ++x) {
      if (x < width - 1) {
        ea[n] = y * width + x;
        eb[n] = y * width + x + 1;
        ++n;
      }
      if (y >= 1) {
        ea[n] = y * width + x;
        eb[n] = (y - 1) * width + x;
        ++n;
      }
    }
  }
}

// Build the segment tree.
//
// Inputs:
//   height, width      image size; N = height*width nodes
//   weights            edge weights in canonical enumeration order
//   tau                FH threshold constant
//   min_size           segments larger than this pay `penalty` when joined
//   penalty            cross-segment joining penalty added to the weight
//   weight_scale       distance quantization scale (1.0 color / 255.0 ST-2)
//
// Outputs (caller-allocated, length N unless noted):
//   bfs_order          node ids in BFS order from root 0
//   parent             parent node id per node (root maps to itself)
//   parent_dist        quantized uchar distance to parent (root: 0), int32
//   level_of           BFS depth per node
//   dfs_order          node ids in DFS preorder (for Euler-interval scans)
//   subtree_size       subtree size per node
//   level_start        per-depth offsets into bfs_order, length >= depth+1
//
// Returns the number of BFS levels (depth of tree + 1), or -1 on error.
int32_t gsm_build_segment_tree(
    int32_t height, int32_t width, const float* weights, float tau,
    int32_t min_size, float penalty, float weight_scale,
    int32_t* bfs_order, int32_t* parent, int32_t* parent_dist,
    int32_t* level_of, int32_t* dfs_order, int32_t* subtree_size,
    int32_t* level_start, int32_t level_start_capacity) {
  const int32_t n_nodes = height * width;
  const int32_t n_edges = gsm_num_edges(height, width);

  // Edges sorted ascending by (w, b, a) — the reference's edge::operator<.
  // Instead of a comparison sort, enumerate edges directly in (b, a) order
  // (for endpoint b the only canonical edges are a = b-1, then a = b+width),
  // then a stable distribution by weight: one counting pass for integral
  // weights in [0, 255] (the color provider), a 4-pass LSD radix over the
  // float bits otherwise (non-negative floats compare like their bits).
  std::vector<Edge> edges(n_edges);
  {
    // Canonical edge index base per pixel (right edge first, then up).
    std::vector<int32_t> off(n_nodes + 1);
    off[0] = 0;
    for (int32_t p = 0; p < n_nodes; ++p) {
      int32_t x = p % width, y = p / width;
      off[p + 1] = off[p] + (x < width - 1 ? 1 : 0) + (y >= 1 ? 1 : 0);
    }
    std::vector<Edge> by_ba;
    by_ba.reserve(n_edges);
    for (int32_t b = 0; b < n_nodes; ++b) {
      if (b % width != 0) {
        int32_t a = b - 1;  // a's right edge
        by_ba.push_back({weights[off[a]], a, b});
      }
      if (b + width < n_nodes) {
        int32_t a = b + width;  // a's up edge (after its right edge, if any)
        by_ba.push_back({weights[off[a] + (a % width < width - 1 ? 1 : 0)], a, b});
      }
    }
    bool integral = true;
    for (int32_t i = 0; i < n_edges; ++i) {
      float w = by_ba[i].w;
      if (!(w >= 0.0f && w <= 255.0f && w == (float)(int32_t)w)) {
        integral = false;
        break;
      }
    }
    if (integral) {
      int32_t count[257] = {0};
      for (const Edge& e : by_ba) ++count[(int32_t)e.w + 1];
      for (int32_t i = 0; i < 256; ++i) count[i + 1] += count[i];
      for (const Edge& e : by_ba) edges[count[(int32_t)e.w]++] = e;
    } else {
      bool nonneg = true;
      for (const Edge& e : by_ba)
        if (e.w < 0.0f) { nonneg = false; break; }
      if (!nonneg) {
        edges = std::move(by_ba);
        std::stable_sort(edges.begin(), edges.end(), edge_less);
      } else {
        std::vector<Edge> tmp(n_edges);
        Edge* src = by_ba.data();
        Edge* dst = tmp.data();
        for (int shift = 0; shift < 32; shift += 8) {
          int32_t count[257] = {0};
          for (int32_t i = 0; i < n_edges; ++i) {
            uint32_t bits;
            std::memcpy(&bits, &src[i].w, 4);
            ++count[((bits >> shift) & 0xFF) + 1];
          }
          for (int32_t i = 0; i < 256; ++i) count[i + 1] += count[i];
          for (int32_t i = 0; i < n_edges; ++i) {
            uint32_t bits;
            std::memcpy(&bits, &src[i].w, 4);
            dst[count[(bits >> shift) & 0xFF]++] = src[i];
          }
          std::swap(src, dst);
        }
        // 4 passes (even count): result is back in by_ba's buffer.
        edges.assign(src, src + n_edges);
      }
    }
  }

  DisjointSet ds(n_nodes);
  std::vector<uint8_t> selected(n_edges, 0);
  std::vector<float> threshold(n_nodes, tau);  // THRESHOLD(1, tau) = tau

  // Pass 1: FH segmentation.
  for (int32_t i = 0; i < n_edges; ++i) {
    int a = ds.find(edges[i].a);
    int b = ds.find(edges[i].b);
    if (a == b) continue;
    if (edges[i].w <= threshold[a] && edges[i].w <= threshold[b]) {
      selected[i] = 1;
      int root = ds.join(a, b);
      threshold[root] = edges[i].w + tau / ds.size(root);
    }
  }

  // Pass 2: join remaining components into one spanning tree.
  for (int32_t i = 0; i < n_edges; ++i) {
    int a = ds.find(edges[i].a);
    int b = ds.find(edges[i].b);
    if (a == b) continue;
    int size_min = std::min(ds.size(a), ds.size(b));
    ds.join(a, b);
    selected[i] = 1;
    if (size_min > min_size) edges[i].w += penalty;
  }

  // Adjacency over selected edges (grid nodes have degree <= 4).
  std::vector<int32_t> adj_head(n_nodes, -1);
  struct AdjEntry {
    int32_t to;
    int32_t dist;
    int32_t next;
  };
  std::vector<AdjEntry> adj;
  adj.reserve(2 * (size_t)n_nodes);
  auto add_adj = [&](int32_t u, int32_t v, int32_t dist) {
    adj.push_back({v, dist, adj_head[u]});
    adj_head[u] = (int32_t)adj.size() - 1;
  };
  for (int32_t i = 0; i < n_edges; ++i) {
    if (!selected[i]) continue;
    int32_t dist = std::min((int32_t)(edges[i].w * weight_scale + 0.5f), 255);
    add_adj(edges[i].a, edges[i].b, dist);
    add_adj(edges[i].b, edges[i].a, dist);
  }

  // BFS from node 0.
  std::vector<uint8_t> visited(n_nodes, 0);
  bfs_order[0] = 0;
  parent[0] = 0;
  parent_dist[0] = 0;
  level_of[0] = 0;
  visited[0] = 1;
  int32_t head = 0, tail = 1;
  int32_t max_level = 0;
  while (head < tail) {
    int32_t u = bfs_order[head++];
    for (int32_t e = adj_head[u]; e != -1; e = adj[e].next) {
      int32_t v = adj[e].to;
      if (visited[v]) continue;
      visited[v] = 1;
      parent[v] = u;
      parent_dist[v] = adj[e].dist;
      level_of[v] = level_of[u] + 1;
      if (level_of[v] > max_level) max_level = level_of[v];
      bfs_order[tail++] = v;
    }
  }
  if (tail != n_nodes) return -1;  // graph was not connected

  const int32_t n_levels = max_level + 1;
  if (n_levels + 1 > level_start_capacity) return -2;
  // BFS order is monotone in level; compute level offsets by counting.
  for (int32_t l = 0; l <= n_levels; ++l) level_start[l] = 0;
  for (int32_t i = 0; i < n_nodes; ++i) ++level_start[level_of[i] + 1];
  for (int32_t l = 0; l < n_levels; ++l) level_start[l + 1] += level_start[l];

  // Iterative DFS preorder + subtree sizes (children discovered via a
  // second adjacency walk, skipping the parent).
  {
    std::vector<int32_t> stack;
    stack.reserve(n_nodes);
    stack.push_back(0);
    int32_t idx = 0;
    std::vector<int32_t> dfs_pos(n_nodes);
    while (!stack.empty()) {
      int32_t u = stack.back();
      stack.pop_back();
      dfs_pos[u] = idx;
      dfs_order[idx++] = u;
      for (int32_t e = adj_head[u]; e != -1; e = adj[e].next) {
        int32_t v = adj[e].to;
        if (v != parent[u] || u == 0) {
          if (parent[v] == u && v != u) stack.push_back(v);
        }
      }
    }
    // subtree sizes: accumulate bottom-up over BFS order reversed.
    for (int32_t i = 0; i < n_nodes; ++i) subtree_size[i] = 1;
    for (int32_t i = n_nodes - 1; i >= 1; --i) {
      int32_t v = bfs_order[i];
      subtree_size[parent[v]] += subtree_size[v];
    }
  }

  return n_levels;
}

// ---------------------------------------------------------------------------
// Edge-weight providers (host hot path; semantics match tree/builder.py's
// NumPy twins, which remain as test oracles).
// ---------------------------------------------------------------------------

namespace {

inline void mm(uint8_t& a, uint8_t& b) {  // compare-exchange
  uint8_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Median of 9 via Paeth's 19-comparator network.
inline uint8_t median9(uint8_t p0, uint8_t p1, uint8_t p2, uint8_t p3,
                       uint8_t p4, uint8_t p5, uint8_t p6, uint8_t p7,
                       uint8_t p8) {
  mm(p1, p2); mm(p4, p5); mm(p7, p8);
  mm(p0, p1); mm(p3, p4); mm(p6, p7);
  mm(p1, p2); mm(p4, p5); mm(p7, p8);
  mm(p0, p3); mm(p5, p8); mm(p4, p7);
  mm(p3, p6); mm(p1, p4); mm(p2, p5);
  mm(p4, p7); mm(p4, p2); mm(p6, p4);
  mm(p4, p2);
  return p4;
}

// Clipped-window 3x3 median of one channel plane, rank n/2 (0-based) of the
// sorted window — the same median ops/postprocess.median_filter_u8 selects.
// Interior pixels go through the median-of-9 network; border pixels use a
// small insertion sort.
void median3x3_channel(const uint8_t* src, int32_t h, int32_t w, int32_t stride,
                       uint8_t* dst) {
  auto slow = [&](int32_t y, int32_t x) {
    uint8_t v[9];
    int n = 0;
    for (int32_t dy = -1; dy <= 1; ++dy) {
      int32_t yy = y + dy;
      if (yy < 0 || yy >= h) continue;
      for (int32_t dx = -1; dx <= 1; ++dx) {
        int32_t xx = x + dx;
        if (xx < 0 || xx >= w) continue;
        v[n++] = src[(yy * (int64_t)w + xx) * stride];
      }
    }
    for (int i = 1; i < n; ++i) {
      uint8_t key = v[i];
      int j = i - 1;
      while (j >= 0 && v[j] > key) {
        v[j + 1] = v[j];
        --j;
      }
      v[j + 1] = key;
    }
    dst[(y * (int64_t)w + x) * stride] = v[n / 2];
  };
  for (int32_t y = 0; y < h; ++y) {
    if (y == 0 || y == h - 1 || w < 3 || h < 3) {
      for (int32_t x = 0; x < w; ++x) slow(y, x);
      continue;
    }
    slow(y, 0);
    const uint8_t* r0 = src + ((y - 1) * (int64_t)w) * stride;
    const uint8_t* r1 = src + (y * (int64_t)w) * stride;
    const uint8_t* r2 = src + ((y + 1) * (int64_t)w) * stride;
    uint8_t* drow = dst + (y * (int64_t)w) * stride;
    for (int32_t x = 1; x < w - 1; ++x) {
      int64_t xl = (int64_t)(x - 1) * stride;
      int64_t xc = (int64_t)x * stride;
      int64_t xr = (int64_t)(x + 1) * stride;
      drow[xc] = median9(r0[xl], r0[xc], r0[xr], r1[xl], r1[xc], r1[xr],
                         r2[xl], r2[xc], r2[xr]);
    }
    slow(y, w - 1);
  }
}

}  // namespace

// 3x3 clipped-window median per channel of an interleaved (H, W, C) u8
// image (the reference's MeanFilter(img, img, 1) presmooth).
void gsm_median3x3(const uint8_t* img, int32_t h, int32_t w, int32_t channels,
                   uint8_t* out) {
  for (int32_t c = 0; c < channels; ++c)
    median3x3_channel(img + c, h, w, channels, out + c);
}

// Canonical-order color edge weights: max-channel abs difference of the
// (optionally presmoothed) BGR image (SegmentTree.cpp:183-194).
void gsm_color_weights(const uint8_t* img_bgr, int32_t h, int32_t w,
                       int32_t presmooth, float* out) {
  const uint8_t* img = img_bgr;
  std::vector<uint8_t> sm;
  if (presmooth) {
    sm.resize((size_t)h * w * 3);
    gsm_median3x3(img_bgr, h, w, 3, sm.data());
    img = sm.data();
  }
  auto maxdiff = [&](int64_t a, int64_t b) -> float {
    int d0 = std::abs((int)img[a * 3 + 0] - (int)img[b * 3 + 0]);
    int d1 = std::abs((int)img[a * 3 + 1] - (int)img[b * 3 + 1]);
    int d2 = std::abs((int)img[a * 3 + 2] - (int)img[b * 3 + 2]);
    return (float)std::max(d0, std::max(d1, d2));
  };
  int32_t n = 0;
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      int64_t p = y * (int64_t)w + x;
      if (x < w - 1) out[n++] = maxdiff(p, p + 1);
      if (y >= 1) out[n++] = maxdiff(p, p - w);
    }
  }
}

// ST-2 re-segmentation weights (CColorDepthWeight, SegmentTree.cpp:196-219):
// where both endpoints are stable, alpha*|dd|/max_level + (1-alpha)*color/255;
// otherwise color/255.
void gsm_color_depth_weights(const uint8_t* img_bgr, const float* disparity,
                             const uint8_t* stable, int32_t h, int32_t w,
                             int32_t max_level, float alpha, int32_t presmooth,
                             float* out) {
  const uint8_t* img = img_bgr;
  std::vector<uint8_t> sm;
  if (presmooth) {
    sm.resize((size_t)h * w * 3);
    gsm_median3x3(img_bgr, h, w, 3, sm.data());
    img = sm.data();
  }
  auto weight = [&](int64_t a, int64_t b) -> float {
    int d0 = std::abs((int)img[a * 3 + 0] - (int)img[b * 3 + 0]);
    int d1 = std::abs((int)img[a * 3 + 1] - (int)img[b * 3 + 1]);
    int d2 = std::abs((int)img[a * 3 + 2] - (int)img[b * 3 + 2]);
    float color = (float)std::max(d0, std::max(d1, d2)) / 255.0f;
    if (stable[a] && stable[b]) {
      float dval = std::abs(disparity[a] - disparity[b]) / (float)max_level;
      return alpha * dval + (1.0f - alpha) * color;
    }
    return color;
  };
  int32_t n = 0;
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      int64_t p = y * (int64_t)w + x;
      if (x < w - 1) out[n++] = weight(p, p + 1);
      if (y >= 1) out[n++] = weight(p, p - w);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Heavy-path-decomposition plan core (host hot path; mirrors the NumPy
// implementation in tree/hpd.py, which remains as the test oracle). Split
// into a context object so Python can merge the per-round sizes into its
// persisted layout registry between the size and fill phases.
// ---------------------------------------------------------------------------

struct GsmHpdPlan {
  int32_t n = 0;
  int32_t n_rounds = 0;
  std::vector<int32_t> parent;
  std::vector<float> weights;      // parent edge weight per node
  std::vector<int32_t> heavy;      // heavy child per node (-1 none)
  std::vector<int32_t> light_depth;
  std::vector<int32_t> head_of;
  std::vector<int32_t> sorted_nodes;   // by (round, head, depth)
  std::vector<int32_t> round_starts;   // length n_rounds + 1
  std::vector<int32_t> pos_of;         // position within round block
  std::vector<int32_t> lights_sorted;  // light nodes by parent round
  std::vector<int32_t> light_starts;   // length n_rounds + 1
};

extern "C" GsmHpdPlan* gsm_hpd_plan_new(int32_t n, const int32_t* parent,
                                        const int32_t* level_of,
                                        const int32_t* subtree_size,
                                        const int32_t* bfs_order,
                                        const float* parent_weights);
extern "C" void gsm_hpd_plan_free(GsmHpdPlan* p);

GsmHpdPlan* gsm_hpd_plan_new(int32_t n, const int32_t* parent,
                             const int32_t* level_of,
                             const int32_t* subtree_size,
                             const int32_t* bfs_order,
                             const float* parent_weights) {
  auto* p = new GsmHpdPlan();
  p->n = n;
  p->parent.assign(parent, parent + n);
  p->weights.assign(parent_weights, parent_weights + n);

  // Heavy child per parent: max subtree size, ties to the lowest child id.
  p->heavy.assign(n, -1);
  std::vector<int32_t> best_size(n, -1);
  for (int32_t v = 1; v < n; ++v) {
    int32_t par = parent[v];
    if (subtree_size[v] > best_size[par] ||
        (subtree_size[v] == best_size[par] && v < p->heavy[par])) {
      best_size[par] = subtree_size[v];
      p->heavy[par] = v;
    }
  }

  // Light depth + path head: one sequential pass in BFS (topological)
  // order — parents precede children.
  p->light_depth.assign(n, 0);
  p->head_of.assign(n, 0);
  p->head_of[0] = 0;
  for (int32_t i = 1; i < n; ++i) {
    int32_t v = bfs_order[i];
    int32_t par = parent[v];
    bool is_heavy = p->heavy[par] == v;
    p->light_depth[v] = p->light_depth[par] + (is_heavy ? 0 : 1);
    p->head_of[v] = is_heavy ? p->head_of[par] : v;
  }

  int32_t n_rounds = 0;
  for (int32_t v = 0; v < n; ++v)
    n_rounds = std::max(n_rounds, p->light_depth[v] + 1);
  p->n_rounds = n_rounds;

  // Sort nodes by (round, head, depth) via a u64 key. head < 2^26 and
  // depth < 2^26 hold for any image this library accepts (n < 6.7e7).
  std::vector<uint64_t> keys(n);
  for (int32_t v = 0; v < n; ++v)
    keys[v] = ((uint64_t)p->light_depth[v] << 52) |
              ((uint64_t)p->head_of[v] << 26) | (uint64_t)level_of[v];
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return keys[a] < keys[b]; });
  p->sorted_nodes = std::move(order);

  p->round_starts.assign(n_rounds + 1, 0);
  for (int32_t v = 0; v < n; ++v) ++p->round_starts[p->light_depth[v] + 1];
  for (int32_t t = 0; t < n_rounds; ++t)
    p->round_starts[t + 1] += p->round_starts[t];

  p->pos_of.assign(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    int32_t v = p->sorted_nodes[i];
    p->pos_of[v] = i - p->round_starts[p->light_depth[v]];
  }

  // Light nodes bucketed by their parent's round (stable in node order).
  p->light_starts.assign(n_rounds + 1, 0);
  std::vector<int32_t> lights;
  lights.reserve(n);
  for (int32_t v = 1; v < n; ++v)
    if (p->heavy[parent[v]] != v) {
      lights.push_back(v);
      ++p->light_starts[p->light_depth[parent[v]] + 1];
    }
  for (int32_t t = 0; t < n_rounds; ++t)
    p->light_starts[t + 1] += p->light_starts[t];
  p->lights_sorted.assign(lights.size(), 0);
  std::vector<int32_t> cursor(p->light_starts.begin(),
                              p->light_starts.end() - 1);
  for (int32_t v : lights)
    p->lights_sorted[cursor[p->light_depth[parent[v]]]++] = v;

  return p;
}

void gsm_hpd_plan_free(GsmHpdPlan* p) { delete p; }

extern "C" {

// Phase 1: per-round unpadded sizes. Arrays of length n_rounds (caller
// allocates >= gsm_hpd_plan_rounds entries).
int32_t gsm_hpd_plan_rounds(GsmHpdPlan* p) { return p->n_rounds; }

void gsm_hpd_plan_sizes(GsmHpdPlan* p, int32_t* path_len, int32_t* num_heads,
                        int32_t* num_lights) {
  for (int32_t t = 0; t < p->n_rounds; ++t) {
    int32_t s = p->round_starts[t], e = p->round_starts[t + 1];
    path_len[t] = e - s;
    int32_t heads = 0;
    for (int32_t i = s; i < e; ++i)
      if (p->head_of[p->sorted_nodes[i]] == p->sorted_nodes[i]) ++heads;
    num_heads[t] = heads;
    num_lights[t] = p->light_starts[t + 1] - p->light_starts[t];
  }
}

// Phase 2: fill the flat padded plan buffers. caps_* give the padded
// (power-of-two, registry-merged) sizes per padded round; rounds beyond
// p->n_rounds are all-dummy. Layout per round, matching hpd.py:
//   ints:   concat(L) head_pos(H) head_parent(H) lc(M) light_parent_pos(M)
//   floats: heavy_a(L) parent_a(L) light_w(M)
void gsm_hpd_plan_fill(GsmHpdPlan* p, int32_t padded_rounds,
                       const int32_t* caps_l, const int32_t* caps_h,
                       const int32_t* caps_m, int32_t* ints, float* floats) {
  const int32_t n = p->n;
  int64_t ip = 0, fp = 0;
  for (int32_t t = 0; t < padded_rounds; ++t) {
    const int32_t l_pad = caps_l[t], h_pad = caps_h[t], m_pad = caps_m[t];
    const int32_t dummy_pos = l_pad - 1;
    int32_t s = 0, e = 0, ls = 0, le = 0;
    if (t < p->n_rounds) {
      s = p->round_starts[t];
      e = p->round_starts[t + 1];
      ls = p->light_starts[t];
      le = p->light_starts[t + 1];
    }
    const int32_t len = e - s, m_len = le - ls;

    int32_t* concat = ints + ip;
    int32_t* head_pos = concat + l_pad;
    int32_t* head_parent = head_pos + h_pad;
    int32_t* lc = head_parent + h_pad;
    int32_t* light_parent_pos = lc + m_pad;
    float* heavy_a = floats + fp;
    float* parent_a = heavy_a + l_pad;
    float* light_w = parent_a + l_pad;
    ip += (int64_t)l_pad + 2 * h_pad + 2 * m_pad;
    fp += (int64_t)2 * l_pad + m_pad;

    int32_t heads = 0;
    for (int32_t i = 0; i < len; ++i) {
      int32_t v = p->sorted_nodes[s + i];
      concat[i] = v;
      int32_t hv = p->heavy[v];
      heavy_a[i] = hv >= 0 ? p->weights[hv] : 0.0f;
      parent_a[i] = v == 0 ? 0.0f : p->weights[v];
      if (p->head_of[v] == v) {
        head_pos[heads] = i;
        head_parent[heads] = v == 0 ? n : p->parent[v];
        ++heads;
      }
    }
    for (int32_t i = len; i < l_pad; ++i) {
      concat[i] = n;
      heavy_a[i] = 0.0f;
      parent_a[i] = 0.0f;
    }
    for (int32_t i = heads; i < h_pad; ++i) {
      head_pos[i] = dummy_pos;
      head_parent[i] = n;
    }
    for (int32_t i = 0; i < m_len; ++i) {
      int32_t v = p->lights_sorted[ls + i];
      lc[i] = v;
      light_parent_pos[i] = p->pos_of[p->parent[v]];
      light_w[i] = p->weights[v];
    }
    for (int32_t i = m_len; i < m_pad; ++i) {
      lc[i] = n;
      light_parent_pos[i] = dummy_pos;
      light_w[i] = 0.0f;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Plan-order (scatter-free) plan emitter. Mirrors hpd.py's
// _plan_order_from_packed (which remains the test oracle) but emits the
// plan-order buffers directly from the GsmHpdPlan context — the Python
// conversion was the streaming host hot spot (~200-400 ms/frame of NumPy
// loop work vs ~10 ms here).
// ---------------------------------------------------------------------------

extern "C" {

// Per-round needed light-slot counts K (unpadded rounds only): the max,
// over path positions, of light children attached to that position.
void gsm_po_plan_k(GsmHpdPlan* p, int32_t* needed_k) {
  std::vector<int32_t> count;
  for (int32_t t = 0; t < p->n_rounds; ++t) {
    int32_t s = p->round_starts[t], e = p->round_starts[t + 1];
    int32_t ls = p->light_starts[t], le = p->light_starts[t + 1];
    count.assign(e - s, 0);
    int32_t k_need = 0;
    for (int32_t i = ls; i < le; ++i) {
      int32_t v = p->lights_sorted[i];
      int32_t pos = p->pos_of[p->parent[v]];
      k_need = std::max(k_need, ++count[pos]);
    }
    needed_k[t] = k_need;
  }
}

// Fill the plan-order buffers. caps_l: padded path length per padded
// round (registry-merged); k_caps: padded light slots per round. Layout
// (must match hpd.py _unpack_po):
//   ints:   per round [head_src(L), light_src(K*L)], then perm(total),
//           then inv_perm(n)
//   floats: per round [heavy_a(L), down_a(L), omw2(L), head_w(L),
//           light_w(K*L)]
// All cross-position references are plan positions; dummy = total.
void gsm_po_plan_fill(GsmHpdPlan* p, int32_t padded_rounds,
                      const int32_t* caps_l, const int32_t* k_caps,
                      int32_t* ints, float* floats) {
  const int32_t n = p->n;
  int64_t total = 0;
  for (int32_t t = 0; t < padded_rounds; ++t) total += caps_l[t];

  // Node id -> plan position (dummy/absent -> total).
  std::vector<int32_t> pos_all(n + 1, (int32_t)total);
  {
    int64_t off = 0;
    for (int32_t t = 0; t < padded_rounds && t < p->n_rounds; ++t) {
      int32_t s = p->round_starts[t], e = p->round_starts[t + 1];
      for (int32_t i = s; i < e; ++i)
        pos_all[p->sorted_nodes[i]] = (int32_t)(off + (i - s));
      off += caps_l[t];
    }
    // rounds beyond n_rounds contribute only dummy positions
  }

  int64_t ip = 0, fp = 0, off = 0;
  std::vector<int32_t> slot_count;
  for (int32_t t = 0; t < padded_rounds; ++t) {
    const int32_t l_pad = caps_l[t], kk = k_caps[t];
    int32_t s = 0, e = 0, ls = 0, le = 0;
    if (t < p->n_rounds) {
      s = p->round_starts[t];
      e = p->round_starts[t + 1];
      ls = p->light_starts[t];
      le = p->light_starts[t + 1];
    }
    const int32_t len = e - s;

    int32_t* head_src = ints + ip;
    int32_t* light_src = head_src + l_pad;
    float* heavy_a = floats + fp;
    float* down_a = heavy_a + l_pad;
    float* omw2 = down_a + l_pad;
    float* head_w = omw2 + l_pad;
    float* light_w = head_w + l_pad;
    ip += (int64_t)l_pad + (int64_t)kk * l_pad;
    fp += (int64_t)4 * l_pad + (int64_t)kk * l_pad;

    for (int32_t i = 0; i < l_pad; ++i) {
      head_src[i] = (int32_t)total;
      head_w[i] = 0.0f;
    }
    for (int64_t i = 0; i < (int64_t)kk * l_pad; ++i) {
      light_src[i] = (int32_t)total;
      light_w[i] = 0.0f;
    }
    for (int32_t i = 0; i < len; ++i) {
      int32_t v = p->sorted_nodes[s + i];
      int32_t hv = p->heavy[v];
      heavy_a[i] = hv >= 0 ? p->weights[hv] : 0.0f;
      float pa = v == 0 ? 0.0f : p->weights[v];
      bool is_head = p->head_of[v] == v;
      down_a[i] = is_head ? 0.0f : pa;
      omw2[i] = 1.0f - pa * pa;
      if (is_head) {
        head_src[i] = v == 0 ? (int32_t)total : pos_all[p->parent[v]];
        head_w[i] = pa;
      }
    }
    for (int32_t i = len; i < l_pad; ++i) {
      heavy_a[i] = 0.0f;
      down_a[i] = 0.0f;
      omw2[i] = 1.0f;  // parent_a == 0 on padding -> 1 - 0
    }

    // Light slots: iterate lights in node order (= NumPy's stable sort by
    // parent position); the occurrence rank within a position is the slot.
    slot_count.assign(l_pad, 0);
    for (int32_t i = ls; i < le; ++i) {
      int32_t v = p->lights_sorted[i];
      int32_t pos = p->pos_of[p->parent[v]];
      int32_t slot = slot_count[pos]++;
      light_src[(int64_t)slot * l_pad + pos] = pos_all[v];
      light_w[(int64_t)slot * l_pad + pos] = p->weights[v];
    }
    off += l_pad;
  }

  // perm(total): plan position -> node id (dummy = n).
  int32_t* perm = ints + ip;
  {
    int64_t o = 0;
    for (int32_t t = 0; t < padded_rounds; ++t) {
      int32_t s = 0, e = 0;
      if (t < p->n_rounds) {
        s = p->round_starts[t];
        e = p->round_starts[t + 1];
      }
      int32_t len = e - s;
      for (int32_t i = 0; i < len; ++i) perm[o + i] = p->sorted_nodes[s + i];
      for (int32_t i = len; i < caps_l[t]; ++i) perm[o + i] = n;
      o += caps_l[t];
    }
  }
  // inv_perm(n): node id -> plan position.
  int32_t* inv_perm = perm + total;
  for (int32_t v = 0; v < n; ++v) inv_perm[v] = pos_all[v];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Stride-bucket plan emitter (tree/stride.py; the NumPy twin there is the
// bit-exact oracle). Within each light-round, heavy paths are grouped into
// power-of-two-length buckets and stored transposed (path p's j-th node at
// local offset j*P + p) so path heads occupy static row-0 slices. See the
// stride.py module docstring for the full layout contract.
// ---------------------------------------------------------------------------

namespace {

inline int32_t ceil_log2_i32(int32_t x) {
  if (x <= 1) return 0;
  int32_t e = 0;
  while ((1 << e) < x) ++e;
  return e;
}

}  // namespace

extern "C" {

// Phase 1: per-path info for the registry-merged layout. Heads are
// enumerated in ascending node id (matching the NumPy emitter's
// lexsort tie-break); the caller sizes arrays with gsm_sb_num_heads.
int32_t gsm_sb_num_heads(GsmHpdPlan* p) {
  int32_t c = 0;
  for (int32_t v = 0; v < p->n; ++v)
    if (p->head_of[v] == v) ++c;
  return c;
}

void gsm_sb_head_info(GsmHpdPlan* p, int32_t* head_node, int32_t* head_round,
                      int32_t* path_len) {
  std::vector<int32_t> len(p->n, 0);
  for (int32_t v = 0; v < p->n; ++v) ++len[p->head_of[v]];
  int32_t j = 0;
  for (int32_t v = 0; v < p->n; ++v)
    if (p->head_of[v] == v) {
      head_node[j] = v;
      head_round[j] = p->light_depth[v];
      path_len[j] = len[v];
      ++j;
    }
}

// Phase 2: fill the plan given the registry-merged static layout.
// caps: (rounds_padded, n_exp) row-major path-slot caps per stride
// exponent. Output layout (must match stride.py _unpack_sb_ints):
//   ints:  perm(total) | inv_perm(n) | per round with heads
//          [parent_pos(H_t) | head_perm(H_t)]
//   codes: (2, total) row-major [parent-distance, flags]; flags bit0 =
//          zero-weight (padding and the root), bits1-2 = light count.
// Returns 0, or -1 if any position has > 3 light children (impossible on
// a 4-connected grid tree; guards corrupt input).
int32_t gsm_sb_plan_fill(GsmHpdPlan* p, int32_t rounds_padded, int32_t n_exp,
                         const int32_t* caps, const int32_t* parent_dist,
                         int32_t* ints, uint8_t* codes) {
  const int32_t n = p->n;
  std::vector<int64_t> b_off((size_t)rounds_padded * n_exp, 0);
  std::vector<int32_t> h_off((size_t)rounds_padded * n_exp, 0);
  std::vector<int32_t> hp(rounds_padded, 0);
  int64_t total = 0;
  for (int32_t t = 0; t < rounds_padded; ++t) {
    int32_t hacc = 0;
    for (int32_t e = 0; e < n_exp; ++e) {
      const int32_t pc = caps[(size_t)t * n_exp + e];
      b_off[(size_t)t * n_exp + e] = total;
      h_off[(size_t)t * n_exp + e] = hacc;
      total += (int64_t)(1 << e) * pc;
      hacc += pc;
    }
    hp[t] = hacc;
  }

  // Place every node: walk each head's heavy chain (ascending head id,
  // bucket slot = running counter per (round, exp)).
  std::vector<int32_t> len(n, 0);
  for (int32_t v = 0; v < n; ++v) ++len[p->head_of[v]];
  std::vector<int32_t> pos_of(n, 0);
  std::vector<int32_t> head_raw(n, -1);  // head id -> raw in-round index
  std::vector<int32_t> counter((size_t)rounds_padded * n_exp, 0);
  int32_t* perm = ints;
  for (int64_t i = 0; i < total; ++i) perm[i] = n;
  for (int32_t v = 0; v < n; ++v) {
    if (p->head_of[v] != v) continue;
    const int32_t r = p->light_depth[v];
    const int32_t e = ceil_log2_i32(len[v]);
    const size_t key = (size_t)r * n_exp + e;
    const int32_t slot = counter[key]++;
    const int32_t pc = caps[key];
    const int64_t base = b_off[key];
    head_raw[v] = h_off[key] + slot;
    int32_t u = v;
    for (int32_t j = 0; j < len[v]; ++j) {
      const int64_t pos = base + (int64_t)j * pc + slot;
      pos_of[u] = (int32_t)pos;
      perm[pos] = u;
      u = p->heavy[u];
    }
  }
  int32_t* inv_perm = ints + total;
  for (int32_t v = 0; v < n; ++v) inv_perm[v] = pos_of[v];

  // Codes: distance row + flags row with per-position light counts.
  uint8_t* dist_row = codes;
  uint8_t* flag_row = codes + total;
  std::vector<uint8_t> cnt(total, 0);
  for (int32_t v = 1; v < n; ++v) {
    if (p->head_of[v] != v) continue;
    uint8_t& c = cnt[pos_of[p->parent[v]]];
    if (++c > 3) return -1;
  }
  for (int64_t i = 0; i < total; ++i) {
    const int32_t v = perm[i];
    dist_row[i] = v == n ? 0 : (uint8_t)parent_dist[v];
    const uint8_t zero_w = (v == n || v == 0) ? 1 : 0;
    flag_row[i] = (uint8_t)(zero_w | (cnt[i] << 1));
  }

  // Per-round head streams: parent positions (raw bucket order) and the
  // (parent position, raw index)-sorted permutation, dummies at the tail.
  int32_t* sp = inv_perm + n;
  std::vector<int32_t> raws;
  std::vector<int32_t> ppos;
  for (int32_t t = 0; t < rounds_padded; ++t) {
    if (hp[t] == 0) continue;
    int32_t* parent_pos = sp;
    int32_t* head_perm = sp + hp[t];
    sp += 2 * (int64_t)hp[t];
    for (int32_t i = 0; i < hp[t]; ++i) parent_pos[i] = (int32_t)total;
    raws.clear();
    ppos.assign(hp[t], 0);
    for (int32_t v = 0; v < n; ++v) {
      if (p->head_of[v] != v || p->light_depth[v] != t) continue;
      const int32_t raw = head_raw[v];
      parent_pos[raw] = v == 0 ? (int32_t)total : pos_of[p->parent[v]];
      ppos[raw] = parent_pos[raw];
      raws.push_back(raw);
    }
    std::sort(raws.begin(), raws.end());  // raw ascending (stable base)
    std::stable_sort(raws.begin(), raws.end(),
                     [&](int32_t a, int32_t b) { return ppos[a] < ppos[b]; });
    int32_t i = 0;
    for (int32_t raw : raws) head_perm[i++] = raw;
    for (; i < hp[t]; ++i) head_perm[i] = hp[t];
  }
  return 0;
}

}  // extern "C"

extern "C" {

// Lean context for the stride-bucket emitter: only heavy / light_depth /
// head_of (one O(N) BFS pass) — gsm_hpd_plan_new's full node sort and
// per-round tables are plan-order machinery the sb layout never reads.
GsmHpdPlan* gsm_sb_ctx_new(int32_t n, const int32_t* parent,
                           const int32_t* subtree_size,
                           const int32_t* bfs_order) {
  auto* p = new GsmHpdPlan();
  p->n = n;
  p->parent.assign(parent, parent + n);
  p->heavy.assign(n, -1);
  std::vector<int32_t> best_size(n, -1);
  for (int32_t v = 1; v < n; ++v) {
    int32_t par = parent[v];
    if (subtree_size[v] > best_size[par] ||
        (subtree_size[v] == best_size[par] && v < p->heavy[par])) {
      best_size[par] = subtree_size[v];
      p->heavy[par] = v;
    }
  }
  p->light_depth.assign(n, 0);
  p->head_of.assign(n, 0);
  for (int32_t i = 1; i < n; ++i) {
    int32_t v = bfs_order[i];
    int32_t par = parent[v];
    bool is_heavy = p->heavy[par] == v;
    p->light_depth[v] = p->light_depth[par] + (is_heavy ? 0 : 1);
    p->head_of[v] = is_heavy ? p->head_of[par] : v;
  }
  int32_t n_rounds = 0;
  for (int32_t v = 0; v < n; ++v)
    n_rounds = std::max(n_rounds, p->light_depth[v] + 1);
  p->n_rounds = n_rounds;
  return p;
}

// 24-bit little-endian planar packing: dst is (3, len) u8 — row 0 the low
// bytes — matching tree/hpd.py pack_ints24. Returns -1 if any value is
// negative or >= 2^24 (would wrap silently).
int32_t gsm_pack24(const int32_t* src, int64_t len, uint8_t* dst) {
  for (int64_t i = 0; i < len; ++i) {
    const int32_t v = src[i];
    if (v < 0 || v >= (1 << 24)) return -1;
    dst[i] = (uint8_t)(v & 0xFF);
    dst[len + i] = (uint8_t)((v >> 8) & 0xFF);
    dst[2 * len + i] = (uint8_t)((v >> 16) & 0xFF);
  }
  return 0;
}

}  // extern "C"
