// Native runtime kernels for the irregular host-side image logic.
//
// The reference implements its seam-finder component analysis with OpenCV
// floodFill loops (ref 动态规划....cpp findComponents :196-310,
// updateLabelsUsingSeam :960-1093) — inherently sequential, pointer-chasing
// work that has no good XLA mapping. This is the framework's native (C++)
// equivalent: union-find connected-component labeling and seeded flood fill
// over uint8 masks, exposed through a C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC ccl.cpp -o libccl.so
// (driven by imagestitch_tpu/native/build.py, cached next to the source).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }
    int32_t find(int32_t a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a != b) parent[b] = a;
    }
};

}  // namespace

extern "C" {

// 4-connected components of mask (H x W uint8, nonzero = foreground).
// labels: int32 H x W output, 0 = background, components numbered from 1 in
// raster order of their first pixel. Returns the number of components.
int32_t ccl_label(const uint8_t* mask, int32_t* labels, int64_t h, int64_t w) {
    const int64_t n = h * w;
    UnionFind uf(static_cast<size_t>(n));
    // first pass: union with left/up neighbors
    for (int64_t y = 0; y < h; ++y) {
        const int64_t row = y * w;
        for (int64_t x = 0; x < w; ++x) {
            const int64_t i = row + x;
            if (!mask[i]) continue;
            if (x > 0 && mask[i - 1]) uf.unite(static_cast<int32_t>(i - 1),
                                               static_cast<int32_t>(i));
            if (y > 0 && mask[i - w]) uf.unite(static_cast<int32_t>(i - w),
                                               static_cast<int32_t>(i));
        }
    }
    // second pass: assign compact labels by root, raster order
    std::vector<int32_t> root_label(static_cast<size_t>(n), 0);
    int32_t next = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (!mask[i]) {
            labels[i] = 0;
            continue;
        }
        const int32_t r = uf.find(static_cast<int32_t>(i));
        if (root_label[r] == 0) root_label[r] = ++next;
        labels[i] = root_label[r];
    }
    return next;
}

// Seeded 4-connected flood fill: set out=new_val over the connected region
// of `value` containing (sy, sx). Returns the filled pixel count.
int64_t flood_fill(uint8_t* img, int64_t h, int64_t w, int64_t sy, int64_t sx,
                   uint8_t value, uint8_t new_val) {
    if (sy < 0 || sy >= h || sx < 0 || sx >= w) return 0;
    if (img[sy * w + sx] != value || value == new_val) return 0;
    std::vector<int64_t> stack;
    stack.push_back(sy * w + sx);
    img[sy * w + sx] = new_val;
    int64_t count = 1;
    while (!stack.empty()) {
        const int64_t i = stack.back();
        stack.pop_back();
        const int64_t y = i / w, x = i % w;
        const int64_t nb[4] = {i - 1, i + 1, i - w, i + w};
        const bool ok[4] = {x > 0, x < w - 1, y > 0, y < h - 1};
        for (int k = 0; k < 4; ++k) {
            if (ok[k] && img[nb[k]] == value) {
                img[nb[k]] = new_val;
                stack.push_back(nb[k]);
                ++count;
            }
        }
    }
    return count;
}

// Component statistics: for each label in [1, n_labels], its pixel count and
// bounding box (x0, y0, x1, y1 inclusive). Arrays sized n_labels.
void ccl_stats(const int32_t* labels, int64_t h, int64_t w, int32_t n_labels,
               int64_t* counts, int32_t* boxes /* n_labels x 4 */) {
    for (int32_t l = 0; l < n_labels; ++l) {
        counts[l] = 0;
        boxes[l * 4 + 0] = static_cast<int32_t>(w);
        boxes[l * 4 + 1] = static_cast<int32_t>(h);
        boxes[l * 4 + 2] = -1;
        boxes[l * 4 + 3] = -1;
    }
    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int32_t l = labels[y * w + x];
            if (l <= 0) continue;
            const int32_t k = l - 1;
            ++counts[k];
            if (x < boxes[k * 4 + 0]) boxes[k * 4 + 0] = static_cast<int32_t>(x);
            if (y < boxes[k * 4 + 1]) boxes[k * 4 + 1] = static_cast<int32_t>(y);
            if (x > boxes[k * 4 + 2]) boxes[k * 4 + 2] = static_cast<int32_t>(x);
            if (y > boxes[k * 4 + 3]) boxes[k * 4 + 3] = static_cast<int32_t>(y);
        }
    }
}

}  // extern "C"
