// Sequential Felzenszwalb-Huttenlocher segmentation, C++ core.
//
// Native rebuild of the reference CPU baseline (branch felzenswlab_baseline,
// reference README.md:33; algorithm of ref [23]): Gaussian smoothing,
// 8-connected grid graph with L2 RGB edge weights, Kruskal sweep with the
// adaptive threshold Int(C) + k/|C|, and a min-size post pass. Written from
// the published algorithm (not copied); semantics match
// gseg_tpu/models/felzenszwalb_cpu.py exactly (same tap widths, replicate
// padding, stable weight sort with canonical-edge-id tie-break) so the two
// can be differentially tested. Used as the fast host-side quality baseline
// for BSDS-scale benchmarking where the NumPy oracle is too slow.
//
// C ABI only (loaded via ctypes — no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int32_t> rank_;
  std::vector<int64_t> size;

  explicit UnionFind(int64_t n) : parent(n), rank_(n, 0), size(n, 1) {
    std::iota(parent.begin(), parent.end(), 0);
  }

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  int64_t unite(int64_t a, int64_t b) {
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    if (rank_[a] == rank_[b]) rank_[a]++;
    return a;
  }
};

// Separable Gaussian, radius ceil(4*sigma), replicate padding — matches
// ops/filters.py gaussian_smooth.
void gaussian_smooth(const uint8_t* img, int h, int w, float sigma,
                     std::vector<float>* out) {
  sigma = std::max(sigma, 0.01f);
  int radius = std::max(1, (int)std::ceil(4.0f * sigma));
  std::vector<float> taps(2 * radius + 1);
  float sum = 0.f;
  for (int i = -radius; i <= radius; ++i) {
    float t = std::exp(-0.5f * (i / sigma) * (i / sigma));
    taps[i + radius] = t;
    sum += t;
  }
  for (float& t : taps) t /= sum;

  std::vector<float> tmp((size_t)h * w * 3);
  out->assign((size_t)h * w * 3, 0.f);
  // vertical pass
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < 3; ++c) {
        float acc = 0.f;
        for (int i = -radius; i <= radius; ++i) {
          int yy = std::min(std::max(y + i, 0), h - 1);
          acc += taps[i + radius] * img[((size_t)yy * w + x) * 3 + c];
        }
        tmp[((size_t)y * w + x) * 3 + c] = acc;
      }
  // horizontal pass
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < 3; ++c) {
        float acc = 0.f;
        for (int i = -radius; i <= radius; ++i) {
          int xx = std::min(std::max(x + i, 0), w - 1);
          acc += taps[i + radius] * tmp[((size_t)y * w + xx) * 3 + c];
        }
        (*out)[((size_t)y * w + x) * 3 + c] = acc;
      }
}

struct Edge {
  float w;
  int64_t eid;  // canonical: anchor*4 + dir, the global tie-break key
  int32_t a, b;
};

}  // namespace

extern "C" {

// img: (h, w, 3) uint8 row-major. labels_out: (h*w,) int32 root vertex ids.
// Returns 0 on success.
int felz_segment(const uint8_t* img, int h, int w, float sigma, float k,
                 int min_size, int32_t* labels_out) {
  const int64_t v = (int64_t)h * w;
  if (v <= 0) return 1;
  std::vector<float> sm;
  gaussian_smooth(img, h, w, sigma, &sm);

  // canonical dirs: E, S, SE, NE  (grid_graph.DIRS4)
  const int dy[4] = {0, 1, 1, 1};
  const int dx[4] = {1, 0, 1, -1};
  std::vector<Edge> edges;
  edges.reserve((size_t)v * 4);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int d = 0; d < 4; ++d) {
        int yy = y + dy[d], xx = x + dx[d];
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
        int64_t a = (int64_t)y * w + x;
        int64_t b = (int64_t)yy * w + xx;
        float dist = 0.f;
        for (int c = 0; c < 3; ++c) {
          float diff = sm[a * 3 + c] - sm[b * 3 + c];
          dist += diff * diff;
        }
        edges.push_back(Edge{std::sqrt(dist), a * 4 + d, (int32_t)a,
                             (int32_t)b});
      }

  std::sort(edges.begin(), edges.end(), [](const Edge& x, const Edge& y) {
    if (x.w != y.w) return x.w < y.w;
    return x.eid < y.eid;
  });

  UnionFind uf(v);
  std::vector<float> intdiff(v, 0.f);
  for (const Edge& e : edges) {
    int64_t a = uf.find(e.a);
    int64_t b = uf.find(e.b);
    if (a == b) continue;
    float ta = intdiff[a] + k / (float)uf.size[a];
    float tb = intdiff[b] + k / (float)uf.size[b];
    if (e.w <= ta && e.w <= tb) {
      int64_t r = uf.unite(a, b);
      intdiff[r] = e.w;
    }
  }
  if (min_size > 1) {
    for (const Edge& e : edges) {
      int64_t a = uf.find(e.a);
      int64_t b = uf.find(e.b);
      if (a != b && (uf.size[a] < min_size || uf.size[b] < min_size))
        uf.unite(a, b);
    }
  }
  for (int64_t i = 0; i < v; ++i) labels_out[i] = (int32_t)uf.find(i);
  return 0;
}

// ASA / UE scores of one segmentation vs one ground truth (comparetool
// rebuild; Report.pdf p.5-6 §4.2 Eqs. 1-2). labels arbitrary int32.
// Returns 0 on success; writes {asa, ue} to out2.
int compare_asa_ue(const int32_t* seg, const int32_t* gt, int64_t n,
                   double* out2) {
  if (n <= 0) return 1;
  // compact both label spaces via sort-based ranking
  std::vector<int64_t> order((size_t)n);
  auto compact = [&](const int32_t* lab, std::vector<int32_t>* out,
                     int64_t* count) {
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](int64_t i, int64_t j) { return lab[i] < lab[j]; });
    out->resize((size_t)n);
    int32_t cur = 0;
    (*out)[order[0]] = 0;
    for (int64_t i = 1; i < n; ++i) {
      if (lab[order[i]] != lab[order[i - 1]]) cur++;
      (*out)[order[i]] = cur;
    }
    *count = cur + 1;
  };
  std::vector<int32_t> sc, gc;
  int64_t ns = 0, ng = 0;
  compact(seg, &sc, &ns);
  compact(gt, &gc, &ng);

  // sparse overlap histogram via sort of paired codes
  std::vector<int64_t> codes((size_t)n);
  for (int64_t i = 0; i < n; ++i) codes[i] = (int64_t)sc[i] * ng + gc[i];
  std::sort(codes.begin(), codes.end());

  std::vector<int64_t> seg_sizes((size_t)ns, 0);
  for (int64_t i = 0; i < n; ++i) seg_sizes[sc[i]]++;

  std::vector<int64_t> best((size_t)ns, 0);
  double ue_sum = 0.0;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && codes[j] == codes[i]) j++;
    int64_t cnt = j - i;
    int64_t sk = codes[i] / ng;
    best[sk] = std::max(best[sk], cnt);
    ue_sum += (double)std::min(cnt, seg_sizes[sk] - cnt);
    i = j;
  }
  double asa = 0.0;
  for (int64_t s = 0; s < ns; ++s) asa += (double)best[s];
  out2[0] = asa / (double)n;
  out2[1] = ue_sum / (double)n;
  return 0;
}

}  // extern "C"
