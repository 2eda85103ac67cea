// TreeSHAP over the port's forest arrays (h2o_tpu_torch, host side).
//
// The algorithm is the exact-SHAP path-permutation recursion of Lundberg
// et al. as used by the reference scorer
// (h2o-genmodel hex/genmodel/algos/tree/TreeSHAP.java, itself the
// XGBoost tree_model.cc port).  The tree layout is the tree engines'
// (models/tree/engine.py): (T, N) arrays of split_col (-1 = leaf),
// per-node go-left bin bitsets, node values, per-node training cover
// (node_w), an optional left-child pointer array (sparse-frontier pool;
// absent = dense heap with children at 2n+1/2n+2) and, for adaptive
// numeric splits, a fine-bin threshold with its NA direction.  Descent
// happens on BINNED rows, the same bin space scoring uses.
//
// Host-native on purpose: contributions are a scoring-time explain
// feature dominated by irregular per-row recursion (branchy,
// data-dependent control flow); the reference keeps it on the CPU for
// the same reason.  Parallelism is across rows.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct PathElem {
  int feature_index;
  double zero_fraction;
  double one_fraction;
  double pweight;
};

struct Tree {
  const int32_t *sc;    // (N,) split column, -1 = leaf
  const uint8_t *bset;  // (N, B1) go-left per bin
  const double *val;    // (N,)
  const double *w;      // (N,) training cover
  const int32_t *child; // (N,) left-child pool ids, or null (dense heap)
  const int32_t *thr;   // (N,) adaptive numeric fine-bin thr, or null
  const uint8_t *nal;   // (N,) NA-left for thr splits, or null
  int64_t N;
  int64_t B1;
  int64_t fine_na;      // NA sentinel of the fine grid

  bool is_leaf(int n) const {
    if (sc[n] < 0) return true;
    if (child != nullptr && child[n] < 0) return true;
    return false;
  }
  int left(int n) const { return child ? child[n] : 2 * n + 1; }
  int right(int n) const { return child ? child[n] + 1 : 2 * n + 2; }
  bool go_left(int n, int b) const {
    if (thr != nullptr && thr[n] >= 0) {   // adaptive numeric split
      if (b == (int)fine_na) return nal[n] != 0;
      return b < thr[n];
    }
    const int nb = b < (int)(B1 - 1) ? b : (int)(B1 - 1);
    return bset[(int64_t)n * B1 + nb] != 0;
  }
};

void extend_path(PathElem *p, int unique_depth, double pz, double po,
                 int pi) {
  p[unique_depth].feature_index = pi;
  p[unique_depth].zero_fraction = pz;
  p[unique_depth].one_fraction = po;
  p[unique_depth].pweight = unique_depth == 0 ? 1.0 : 0.0;
  for (int i = unique_depth - 1; i >= 0; --i) {
    p[i + 1].pweight += po * p[i].pweight * (i + 1) /
                        (double)(unique_depth + 1);
    p[i].pweight = pz * p[i].pweight * (unique_depth - i) /
                   (double)(unique_depth + 1);
  }
}

void unwind_path(PathElem *p, int unique_depth, int path_index) {
  const double po = p[path_index].one_fraction;
  const double pz = p[path_index].zero_fraction;
  double next_one = p[unique_depth].pweight;
  for (int i = unique_depth - 1; i >= 0; --i) {
    if (po != 0) {
      const double tmp = p[i].pweight;
      p[i].pweight = next_one * (unique_depth + 1) / ((i + 1) * po);
      next_one = tmp - p[i].pweight * pz * (unique_depth - i) /
                 (double)(unique_depth + 1);
    } else if (pz != 0) {
      p[i].pweight = (p[i].pweight * (unique_depth + 1)) /
                     (pz * (unique_depth - i));
    } else {
      p[i].pweight = 0;
    }
  }
  for (int i = path_index; i < unique_depth; ++i) {
    p[i].feature_index = p[i + 1].feature_index;
    p[i].zero_fraction = p[i + 1].zero_fraction;
    p[i].one_fraction = p[i + 1].one_fraction;
  }
}

double unwound_path_sum(const PathElem *p, int unique_depth,
                        int path_index) {
  const double po = p[path_index].one_fraction;
  const double pz = p[path_index].zero_fraction;
  double next_one = p[unique_depth].pweight;
  double total = 0;
  for (int i = unique_depth - 1; i >= 0; --i) {
    if (po != 0) {
      const double tmp = next_one * (unique_depth + 1) / ((i + 1) * po);
      total += tmp;
      next_one = p[i].pweight - tmp * pz * ((unique_depth - i) /
                                            (double)(unique_depth + 1));
    } else if (pz != 0) {
      total += (p[i].pweight / pz) /
               ((unique_depth - i) / (double)(unique_depth + 1));
    }
  }
  return total;
}

// recursion; parent path copied forward in the triangular workspace
// (PathPointer.move in the reference)
void tree_shap(const Tree &t, const int32_t *row, double *phi, int node,
               int unique_depth, PathElem *parent_path, double pz,
               double po, int pi) {
  // PathPointer.move(unique_depth): the child window starts
  // unique_depth elements further and begins as a copy of the parent's
  PathElem *up = parent_path + unique_depth;
  for (int i = 0; i < unique_depth; ++i) up[i] = parent_path[i];
  extend_path(up, unique_depth, pz, po, pi);

  if (t.is_leaf(node)) {
    for (int i = 1; i <= unique_depth; ++i) {
      const double ws = unwound_path_sum(up, unique_depth, i);
      const PathElem &el = up[i];
      phi[el.feature_index] +=
          ws * (el.one_fraction - el.zero_fraction) * t.val[node];
    }
    return;
  }

  const int col = t.sc[node];
  const int b = row[col];
  const bool go_left = t.go_left(node, b);
  const int l = t.left(node), r = t.right(node);
  const int hot = go_left ? l : r;
  const int cold = go_left ? r : l;
  const double wn = t.w[node];
  const double hot_zero = wn != 0 ? t.w[hot] / wn : 0.5;
  const double cold_zero = wn != 0 ? t.w[cold] / wn : 0.5;
  double iz = 1.0, io = 1.0;

  int path_index = 0;
  for (; path_index <= unique_depth; ++path_index)
    if (up[path_index].feature_index == col) break;
  if (path_index != unique_depth + 1) {
    iz = up[path_index].zero_fraction;
    io = up[path_index].one_fraction;
    unwind_path(up, unique_depth, path_index);
    unique_depth -= 1;
  }

  tree_shap(t, row, phi, hot, unique_depth + 1, up, hot_zero * iz, io,
            col);
  tree_shap(t, row, phi, cold, unique_depth + 1, up, cold_zero * iz, 0.0,
            col);
}

// weighted mean prediction of the tree = the SHAP bias term
double tree_mean(const Tree &t, int node) {
  if (t.is_leaf(node)) return t.val[node];
  const double wn = t.w[node];
  if (wn == 0) return t.val[node];
  return (t.w[t.left(node)] * tree_mean(t, t.left(node)) +
          t.w[t.right(node)] * tree_mean(t, t.right(node))) / wn;
}

int tree_depth(const Tree &t, int node) {
  if (t.is_leaf(node)) return 1;
  const int dl = tree_depth(t, t.left(node));
  const int dr = tree_depth(t, t.right(node));
  return 1 + (dl > dr ? dl : dr);
}

} // namespace

extern "C" {

// phi (R, C+1) must be zero-initialized by the caller; the bias column
// phi[:, C] receives the sum of per-tree expected values.
int treeshap_contribs(const int32_t *bins, int64_t R, int64_t C,
                      const int32_t *split_col, const uint8_t *bitset,
                      const double *value, const double *node_w,
                      const int32_t *child, const int32_t *thr,
                      const uint8_t *nal, int64_t fine_na, int64_t T,
                      int64_t N, int64_t B1, double *phi, int nthreads) {
  std::vector<Tree> trees((size_t)T);
  double bias = 0.0;
  int maxd = 1;
  for (int64_t t = 0; t < T; ++t) {
    trees[t] = Tree{split_col + t * N, bitset + t * N * B1,
                    value + t * N,     node_w + t * N,
                    child ? child + t * N : nullptr,
                    thr ? thr + t * N : nullptr,
                    nal ? nal + t * N : nullptr, N, B1, fine_na};
    bias += tree_mean(trees[t], 0);
    const int d = tree_depth(trees[t], 0);
    if (d > maxd) maxd = d;
  }
  const int wd = maxd + 2;
  const size_t ws_size = (size_t)wd * (wd + 1) / 2 + wd;

  auto worker = [&](int64_t r0, int64_t r1) {
    std::vector<PathElem> workspace(ws_size);
    for (int64_t r = r0; r < r1; ++r) {
      double *ph = phi + r * (C + 1);
      ph[C] += bias;
      for (int64_t t = 0; t < T; ++t) {
        std::memset(workspace.data(), 0,
                    workspace.size() * sizeof(PathElem));
        tree_shap(trees[t], bins + r * C, ph, 0, 0, workspace.data(),
                  1.0, 1.0, -1);
      }
    }
  };

  if (nthreads <= 1 || R < 2 * nthreads) {
    worker(0, R);
    return 0;
  }
  std::vector<std::thread> pool;
  const int64_t step = (R + nthreads - 1) / nthreads;
  for (int i = 0; i < nthreads; ++i) {
    const int64_t a = i * step;
    const int64_t b = a + step < R ? a + step : R;
    if (a >= b) break;
    pool.emplace_back(worker, a, b);
  }
  for (auto &th : pool) th.join();
  return 0;
}

// leaf-node assignment: per row per tree, the terminal node's pool/heap
// id and the root-to-leaf path as L/R characters (max 64 levels).
int tree_leaf_assign(const int32_t *bins, int64_t R, int64_t C,
                     const int32_t *split_col, const uint8_t *bitset,
                     const int32_t *child, const int32_t *thr,
                     const uint8_t *nal, int64_t fine_na, int64_t T,
                     int64_t N, int64_t B1, int32_t *node_ids,
                     char *paths, int64_t path_stride) {
  for (int64_t t = 0; t < T; ++t) {
    Tree tr{split_col + t * N, bitset + t * N * B1, nullptr, nullptr,
            child ? child + t * N : nullptr,
            thr ? thr + t * N : nullptr,
            nal ? nal + t * N : nullptr, N, B1, fine_na};
    for (int64_t r = 0; r < R; ++r) {
      int node = 0;
      char *out = paths + (r * T + t) * path_stride;
      int pos = 0;
      while (!tr.is_leaf(node) && pos < path_stride - 1) {
        const int col = tr.sc[node];
        const int b = bins[r * C + col];
        const bool go_left = tr.go_left(node, b);
        out[pos++] = go_left ? 'L' : 'R';
        node = go_left ? tr.left(node) : tr.right(node);
      }
      out[pos] = '\0';
      node_ids[r * T + t] = node;
    }
  }
  return 0;
}

} // extern "C"
