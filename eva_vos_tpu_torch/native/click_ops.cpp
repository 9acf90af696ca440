// Native kernels for the click-robot host path.
//
// The interactive loop calls connected-component labeling on error masks
// for every simulated click (reference: skimage.measure.label in
// robots/click_robot.py). One fused C++ pass — 8-connectivity union-find
// with per-root pixel counts and coordinate sums — replaces
// label + bincount + argmax + where + mean, and a second helper finds the
// nearest in-mask pixel for gt snapping.
//
// Built as a shared library (g++ -O3 -shared -fPIC) and bound via ctypes
// (eva_vos_tpu_torch/native/__init__.py); the robots of
// eva_vos_tpu_torch/annotator/robots.py take it unless EVAVOS_NATIVE=0.

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }
    int32_t find(int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];  // path halving
            x = parent[x];
        }
        return x;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a != b) parent[b] = a;
    }
};

}  // namespace

extern "C" {

// Largest 8-connected component of a binary mask.
// Writes (center_x, center_y, size) of the largest component;
// size == 0 when the mask is empty. Center = floor of the coordinate means,
// matching int(np.mean(indices)) in the reference robot.
void largest_component_center(const uint8_t* mask, int h, int w,
                              int* out_x, int* out_y, long long* out_size) {
    const size_t n = static_cast<size_t>(h) * w;
    UnionFind uf(n);

    // union with already-visited 8-neighbors (left, up-left, up, up-right)
    for (int y = 0; y < h; ++y) {
        const int row = y * w;
        for (int x = 0; x < w; ++x) {
            const int i = row + x;
            if (!mask[i]) continue;
            if (x > 0 && mask[i - 1]) uf.unite(i, i - 1);
            if (y > 0) {
                const int up = i - w;
                if (mask[up]) uf.unite(i, up);
                if (x > 0 && mask[up - 1]) uf.unite(i, up - 1);
                if (x + 1 < w && mask[up + 1]) uf.unite(i, up + 1);
            }
        }
    }

    // accumulate per-root counts and coordinate sums; remember each root's
    // first pixel (raster order) so ties can resolve like ndimage.label +
    // argmax: labels are assigned in first-encounter order and argmax
    // returns the lowest label id on equal counts
    std::vector<long long> count(n, 0);
    std::vector<long long> sum_x(n, 0), sum_y(n, 0);
    std::vector<int32_t> first_seen;
    first_seen.reserve(64);
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int i = y * w + x;
            if (!mask[i]) continue;
            const int32_t r = uf.find(i);
            if (count[r] == 0) first_seen.push_back(r);
            count[r] += 1;
            sum_x[r] += x;
            sum_y[r] += y;
        }
    }

    // pick the largest component; iterating roots in first-encounter order
    // with a strict '>' gives the earliest-first-pixel winner on ties
    long long best = 0;
    int32_t best_root = -1;
    for (const int32_t r : first_seen) {
        if (count[r] > best) {
            best = count[r];
            best_root = r;
        }
    }

    if (best_root < 0) {
        *out_x = -1;
        *out_y = -1;
        *out_size = 0;
        return;
    }
    *out_x = static_cast<int>(sum_x[best_root] / count[best_root]);
    *out_y = static_cast<int>(sum_y[best_root] / count[best_root]);
    *out_size = best;
}

// Nearest true pixel to (x, y) by squared euclidean distance, scanning in
// row-major order so ties resolve to the lowest (y, x) — the same winner
// as np.argmin over np.where's row-major outputs.
void nearest_true(const uint8_t* mask, int h, int w, int x, int y,
                  int* out_x, int* out_y) {
    long long best = -1;
    int bx = -1, by = -1;
    for (int yy = 0; yy < h; ++yy) {
        const int row = yy * w;
        const long long dy = static_cast<long long>(yy - y) * (yy - y);
        if (best >= 0 && dy > best) continue;
        for (int xx = 0; xx < w; ++xx) {
            if (!mask[row + xx]) continue;
            const long long d =
                dy + static_cast<long long>(xx - x) * (xx - x);
            if (best < 0 || d < best) {
                best = d;
                bx = xx;
                by = yy;
            }
        }
    }
    *out_x = bx;
    *out_y = by;
}

}  // extern "C"
