// Host builders of particle-group connectivity for box2d_tpu_torch: the
// spring / barrier pairs and the elastic triads of a particle group, built
// once at group creation (and at a join) on the host.
//
// A copy of build_pairs and build_triads of native/scene_core.cpp
// (lines 141-307), the JAX package's native scene core, so that both
// packages make the same pairs and the same Voronoi triads for the same
// points. Plain C interface, loaded through ctypes by
// box2d_tpu_torch/native.py, which builds it with g++.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <deque>
#include <set>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// particle group connectivity: spring pairs + elastic triads
// (behavioral counterpart of ref: ParticleSystem.cs:801-861 via a grid hash
//  instead of the Voronoi diagram — triads triangulate the stride grid)
// ---------------------------------------------------------------------------

struct CellKey {
    int64_t k;
    bool operator==(const CellKey& o) const { return k == o.k; }
};
struct CellHash {
    size_t operator()(const CellKey& c) const {
        return std::hash<int64_t>()(c.k);
    }
};

// positions: n*2 f32. Emits pairs (a, b, dist) for all pairs closer than
// max_dist. Returns count (caps at max_pairs).
int build_pairs(const float* pos, int n, float max_dist,
                int32_t* pair_a, int32_t* pair_b, float* pair_dist,
                int max_pairs) {
    std::unordered_map<CellKey, std::vector<int>, CellHash> grid;
    double inv = 1.0 / max_dist;
    auto cell_of = [&](int i) -> std::pair<int64_t, int64_t> {
        return { (int64_t)std::floor(pos[2*i] * inv),
                 (int64_t)std::floor(pos[2*i+1] * inv) };
    };
    for (int i = 0; i < n; i++) {
        auto [cx, cy] = cell_of(i);
        grid[{ (cx << 32) ^ (cy & 0xffffffffLL) }].push_back(i);
    }
    int count = 0;
    for (int i = 0; i < n && count < max_pairs; i++) {
        auto [cx, cy] = cell_of(i);
        for (int dy = -1; dy <= 1; dy++) {
            for (int dx = -1; dx <= 1; dx++) {
                auto it = grid.find({ ((cx+dx) << 32) ^ ((cy+dy) & 0xffffffffLL) });
                if (it == grid.end()) continue;
                for (int j : it->second) {
                    if (j <= i) continue;
                    double ddx = pos[2*j] - pos[2*i];
                    double ddy = pos[2*j+1] - pos[2*i+1];
                    double d = std::hypot(ddx, ddy);
                    if (d < max_dist && count < max_pairs) {
                        pair_a[count] = i;
                        pair_b[count] = j;
                        pair_dist[count] = (float)d;
                        count++;
                    }
                }
            }
        }
    }
    return count;
}

// Elastic-triad connectivity via a grid flood-fill Voronoi diagram
// (behavioral counterpart of ref: particle/VoronoiDiagram.cs:18-119 +
// UpdatePairsAndTriads :827-861): cell size = stride/2, bbox padded by
// 2*stride; a BFS seeded at each generator fills empty cells first-come,
// then a correction sweep steals cells for strictly closer generators;
// triads are emitted at 2x2 cell corners where three distinct regions
// meet, capped at the reference's max triad edge length (2*diameter),
// deduplicated on the unordered index triple. Writes (a, b, c) triples
// and the rest offsets (pa, pb, pc from midpoint). Returns triad count.
int build_triads(const float* pos, int n, float stride,
                 int32_t* tri, float* rest, int max_triads) {
    if (n < 3) return 0;
    double radius = 0.5 * stride;          // ref: Generate(ParticleStride/2,
    double margin = 2.0 * stride;          //               ParticleStride*2)
    double diameter = stride / 0.75;       // stride = 0.75 * diameter
    double maxd2 = 4.0 * diameter * diameter;  // b2_maxTriadDistanceSquared
    double inv = 1.0 / radius;
    double lx = 1e300, ly = 1e300, ux = -1e300, uy = -1e300;
    for (int i = 0; i < n; i++) {
        lx = std::min(lx, (double)pos[2*i]);
        ux = std::max(ux, (double)pos[2*i]);
        ly = std::min(ly, (double)pos[2*i+1]);
        uy = std::max(uy, (double)pos[2*i+1]);
    }
    lx -= margin; ly -= margin; ux += margin; uy += margin;
    int cx = 1 + (int)(inv * (ux - lx));
    int cy = 1 + (int)(inv * (uy - ly));
    if (cx <= 0 || cy <= 0 || (int64_t)cx * cy > ((int64_t)1 << 26))
        return 0;                          // degenerate / absurdly sparse
    std::vector<int> diag((size_t)cx * cy, -1);
    std::vector<double> gx(n), gy(n);
    struct Task { int x, y, i, g; };
    std::deque<Task> q;
    for (int i = 0; i < n; i++) {
        gx[i] = inv * (pos[2*i] - lx);
        gy[i] = inv * (pos[2*i+1] - ly);
        int x = (int)gx[i], y = (int)gy[i];
        if (x >= 0 && y >= 0 && x < cx && y < cy)
            q.push_back({x, y, x + y * cx, i});
    }
    auto push4 = [&](int x, int y, int i, int g) {
        if (x > 0) q.push_back({x - 1, y, i - 1, g});
        if (y > 0) q.push_back({x, y - 1, i - cx, g});
        if (x < cx - 1) q.push_back({x + 1, y, i + 1, g});
        if (y < cy - 1) q.push_back({x, y + 1, i + cx, g});
    };
    while (!q.empty()) {                   // first-come flood fill
        Task t = q.front(); q.pop_front();
        if (diag[t.i] < 0) { diag[t.i] = t.g; push4(t.x, t.y, t.i, t.g); }
    }
    for (int y = 0; y < cy; y++)           // boundary-correction seeds
        for (int x = 0; x < cx - 1; x++) {
            int i = x + y * cx;
            if (diag[i] != diag[i + 1]) {
                q.push_back({x, y, i, diag[i + 1]});
                q.push_back({x + 1, y, i + 1, diag[i]});
            }
        }
    for (int y = 0; y < cy - 1; y++)
        for (int x = 0; x < cx; x++) {
            int i = x + y * cx;
            if (diag[i] != diag[i + cx]) {
                q.push_back({x, y, i, diag[i + cx]});
                q.push_back({x, y + 1, i + cx, diag[i]});
            }
        }
    auto d2 = [&](int g, int x, int y) {
        double dx = gx[g] - x, dy = gy[g] - y;
        return dx * dx + dy * dy;
    };
    while (!q.empty()) {                   // steal strictly-closer cells
        Task t = q.front(); q.pop_front();
        int a = diag[t.i], b = t.g;
        if (a != b && d2(a, t.x, t.y) > d2(b, t.x, t.y)) {
            diag[t.i] = b;
            push4(t.x, t.y, t.i, b);
        }
    }
    std::set<std::array<int, 3>> seen;
    int count = 0;
    auto emit = [&](int a, int b, int c) {
        if (count >= max_triads) return;
        double pax = pos[2*a], pay = pos[2*a+1];
        double pbx = pos[2*b], pby = pos[2*b+1];
        double pcx = pos[2*c], pcy = pos[2*c+1];
        double ab2 = (pax-pbx)*(pax-pbx) + (pay-pby)*(pay-pby);
        double bc2 = (pbx-pcx)*(pbx-pcx) + (pby-pcy)*(pby-pcy);
        double ca2 = (pcx-pax)*(pcx-pax) + (pcy-pay)*(pcy-pay);
        if (ab2 > maxd2 || bc2 > maxd2 || ca2 > maxd2) return;
        std::array<int, 3> k{a, b, c};
        std::sort(k.begin(), k.end());
        if (!seen.insert(k).second) return;
        double mx = (pax + pbx + pcx) / 3.0, my = (pay + pby + pcy) / 3.0;
        tri[3*count] = a; tri[3*count+1] = b; tri[3*count+2] = c;
        rest[6*count+0] = (float)(pax - mx); rest[6*count+1] = (float)(pay - my);
        rest[6*count+2] = (float)(pbx - mx); rest[6*count+3] = (float)(pby - my);
        rest[6*count+4] = (float)(pcx - mx); rest[6*count+5] = (float)(pcy - my);
        count++;
    };
    for (int y = 0; y < cy - 1; y++)       // GetNodes (ref :104-119)
        for (int x = 0; x < cx - 1; x++) {
            int i = x + y * cx;
            int a = diag[i], b = diag[i + 1];
            int c = diag[i + cx], d = diag[i + cx + 1];
            if (b != c) {
                if (a != b && a != c) emit(a, b, c);
                if (d != b && d != c) emit(b, d, c);
            }
        }
    return count;
}

}  // extern "C"
