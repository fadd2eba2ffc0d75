// Host-side connected components: union-find with path compression.
//
// The port's copy of the JAX package's csrc/connected_components.cpp (the
// same code): the host twin of the label-propagation connected components
// (freepose_tpu_torch/ops/connected_components.py) and a functional
// equivalent of the reference's CUDA connected-components kernel (SAM2's
// Block-Union-Find over [N,1,H,W] masks with per-label areas). Used for host
// mask postprocessing (models/sam2/transforms.py, use_native=True).
//
// Built with g++ at first use by freepose_tpu_torch/ops/cc_native.py and
// loaded with ctypes.

#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
    std::vector<int32_t> parent;

    explicit UnionFind(int32_t n) : parent(n) {
        for (int32_t i = 0; i < n; ++i) parent[i] = i;
    }

    int32_t find(int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {  // path compression
            int32_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }

    void unite(int32_t a, int32_t b) {
        int32_t ra = find(a), rb = find(b);
        if (ra == rb) return;
        if (ra < rb) parent[rb] = ra;  // min-root convention: labels are the
        else parent[ra] = rb;          // smallest linear index (matches the
    }                                  // device version's min-propagation)
};

}  // namespace

extern "C" {

// masks: [n, h, w] uint8 (nonzero = foreground).
// labels_out: [n, h, w] int32 (min linear index per component; -1 background).
// areas_out: [n, h, w] int32 (component pixel count at each pixel; 0 bg).
// 4-connectivity, matching scipy.ndimage.label(structure=plus) and the
// device kernel.
void connected_components_batch(const uint8_t* masks, int32_t n, int32_t h,
                                int32_t w, int32_t* labels_out,
                                int32_t* areas_out) {
    const int64_t hw = static_cast<int64_t>(h) * w;
    std::vector<int32_t> areas(hw);
    for (int32_t img = 0; img < n; ++img) {
        const uint8_t* m = masks + img * hw;
        int32_t* lab = labels_out + img * hw;
        int32_t* area = areas_out + img * hw;

        UnionFind uf(static_cast<int32_t>(hw));
        for (int32_t y = 0; y < h; ++y) {
            for (int32_t x = 0; x < w; ++x) {
                const int32_t i = y * w + x;
                if (!m[i]) continue;
                if (x > 0 && m[i - 1]) uf.unite(i, i - 1);
                if (y > 0 && m[i - w]) uf.unite(i, i - w);
            }
        }
        std::fill(areas.begin(), areas.end(), 0);
        for (int32_t i = 0; i < hw; ++i) {
            if (m[i]) ++areas[uf.find(i)];
        }
        for (int32_t i = 0; i < hw; ++i) {
            if (m[i]) {
                const int32_t root = uf.find(i);
                lab[i] = root;
                area[i] = areas[root];
            } else {
                lab[i] = -1;
                area[i] = 0;
            }
        }
    }
}

// In-place hole filling + speckle removal (the two SAM2 postprocess uses):
// background components with area <= max_area become foreground, then
// foreground components with area <= max_area become background.
void remove_small_components(uint8_t* masks, int32_t n, int32_t h, int32_t w,
                             int32_t max_area, int32_t fill_holes) {
    const int64_t hw = static_cast<int64_t>(h) * w;
    std::vector<uint8_t> inv(hw);
    std::vector<int32_t> lab(hw), area(hw);
    for (int32_t img = 0; img < n; ++img) {
        uint8_t* m = masks + img * hw;
        if (fill_holes) {
            for (int64_t i = 0; i < hw; ++i) inv[i] = m[i] ? 0 : 1;
            connected_components_batch(inv.data(), 1, h, w, lab.data(), area.data());
            for (int64_t i = 0; i < hw; ++i) {
                if (!m[i] && area[i] > 0 && area[i] <= max_area) m[i] = 1;
            }
        }
        connected_components_batch(m, 1, h, w, lab.data(), area.data());
        for (int64_t i = 0; i < hw; ++i) {
            if (m[i] && area[i] <= max_area) m[i] = 0;
        }
    }
}

}  // extern "C"
