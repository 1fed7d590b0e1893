// Host-side BFS clustering of PointGroup's proposals (counterpart of
// `bfs_cluster` in native/clustering.cpp of the JAX package; the reference's
// `libs/pointgroup_ops/src/bfs_cluster.cpp` with `ballquery_batch_p`, which
// also runs on the CPU).
//
// A fixed-radius neighbour graph over the shifted coordinates through a grid
// hash (16 bits an axis, the batch id above bit 48), then depth-first
// connected components restricted to one label and one batch id. Each point
// takes at most `max_neighbors` new neighbours, found cell by cell in the
// order dx, dy, dz = -1..1; components under `min_points` are rejected. Seeds
// run in index order, so the cluster ids are the order of each component's
// first point.
//
// Built by pointcept_tpu_torch/ops/kernels/build.py with
// g++ -std=c++17 -O3 -shared -fPIC (ISO mode: no contraction into FMA, so
// the distances are the same bits on every host) and loaded through ctypes
// (pointcept_tpu_torch/ops/clustering.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
    int64_t v;
    bool operator==(const CellKey& o) const { return v == o.v; }
};

struct CellHash {
    size_t operator()(const CellKey& k) const { return std::hash<int64_t>()(k.v * 0x9E3779B97F4A7C15ULL); }
};

inline int64_t cell_of(float x, float y, float z, int b, float inv_r) {
    int64_t cx = (int64_t)std::floor(x * inv_r) & 0xFFFF;
    int64_t cy = (int64_t)std::floor(y * inv_r) & 0xFFFF;
    int64_t cz = (int64_t)std::floor(z * inv_r) & 0xFFFF;
    return ((int64_t)b << 48) | (cx << 32) | (cy << 16) | cz;
}

}  // namespace

extern "C" {

// coords [n*3] (shifted by the predicted offsets, voxel units), batch [n],
// labels [n] (predicted class); cluster_out [n] <- cluster id, -1 for none.
// Returns the number of clusters.
int bfs_cluster(const float* coords, const int32_t* batch, const int32_t* labels, int64_t n, float radius,
                int32_t min_points, int32_t max_neighbors, int32_t* cluster_out) {
    const float r2 = radius * radius;
    const float inv_r = 1.0f / radius;

    std::unordered_map<CellKey, std::vector<int32_t>, CellHash> grid;
    grid.reserve(n * 2);
    for (int64_t i = 0; i < n; ++i) {
        CellKey k{cell_of(coords[i * 3], coords[i * 3 + 1], coords[i * 3 + 2], batch[i], inv_r)};
        grid[k].push_back((int32_t)i);
    }

    std::fill(cluster_out, cluster_out + n, -1);
    std::vector<int32_t> component;
    component.reserve(1024);
    std::vector<int32_t> stack;
    int32_t num_clusters = 0;
    for (int64_t seed = 0; seed < n; ++seed) {
        if (cluster_out[seed] != -1) continue;
        component.clear();
        stack.clear();
        stack.push_back((int32_t)seed);
        cluster_out[seed] = -2;  // visiting
        const int32_t lbl = labels[seed];
        const int32_t bat = batch[seed];
        while (!stack.empty()) {
            int32_t i = stack.back();
            stack.pop_back();
            component.push_back(i);
            const float xi = coords[i * 3], yi = coords[i * 3 + 1], zi = coords[i * 3 + 2];
            int found = 0;
            int64_t cx = (int64_t)std::floor(xi * inv_r);
            int64_t cy = (int64_t)std::floor(yi * inv_r);
            int64_t cz = (int64_t)std::floor(zi * inv_r);
            for (int dx = -1; dx <= 1 && found < max_neighbors; ++dx)
                for (int dy = -1; dy <= 1 && found < max_neighbors; ++dy)
                    for (int dz = -1; dz <= 1 && found < max_neighbors; ++dz) {
                        CellKey k{((int64_t)bat << 48) | (((cx + dx) & 0xFFFF) << 32) | (((cy + dy) & 0xFFFF) << 16) |
                                  ((cz + dz) & 0xFFFF)};
                        auto it = grid.find(k);
                        if (it == grid.end()) continue;
                        for (int32_t j : it->second) {
                            if (cluster_out[j] != -1 || labels[j] != lbl || batch[j] != bat) continue;
                            const float ex = coords[j * 3] - xi;
                            const float ey = coords[j * 3 + 1] - yi;
                            const float ez = coords[j * 3 + 2] - zi;
                            if (ex * ex + ey * ey + ez * ez <= r2) {
                                cluster_out[j] = -2;
                                stack.push_back(j);
                                if (++found >= max_neighbors) break;
                            }
                        }
                    }
        }
        if ((int32_t)component.size() >= min_points) {
            for (int32_t i : component) cluster_out[i] = num_clusters;
            ++num_clusters;
        } else {
            for (int32_t i : component) cluster_out[i] = -1 - 1000000;  // rejected: not a seed again
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (cluster_out[i] < -1) cluster_out[i] = -1;
    return num_clusters;
}

}  // extern "C"
