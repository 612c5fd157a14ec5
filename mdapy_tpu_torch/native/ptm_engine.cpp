// A copy of mdapy_tpu/native/ptm_engine.cpp (:1-1093, whole and unchanged),
// built by mdapy_tpu_torch/native/__init__.py:load_library (no -march=native,
// so no FMA contraction where the JAX package's build has it: ROADMAP C16).
//
// Polyhedral template matching engine (native runtime component).
//
// Algorithm per Larsen, Schmidt & Schiotz, "Robust structural identification
// via polyhedral template matching", MSMSE 24 (2016) 055007:
//   1. Order an atom's candidate neighbours by the solid angle their Voronoi
//      face subtends at the central atom (descending; ties by distance).
//   2. For each candidate structure, take the first k ordered neighbours,
//      build the convex hull of the (barycentre-normalised) point set, and
//      require the template's facet count / degree profile.
//   3. Compute a Weinberg canonical code of the hull triangulation graph and
//      look it up in the structure's code table; every stored labelling
//      (graph x automorphism) yields a point correspondence.
//   4. For each correspondence, the optimal rotation (quaternion eigenproblem)
//      + scale gives an RMSD; keep the global best; threshold outside.
//
// Fresh architecture (not a port): template code tables are BOOTSTRAPPED at
// setup time — Python enumerates all triangulations of the ideal template's
// degenerate hull faces and passes explicit facet lists; this file computes
// their canonical codes with the same function used at runtime, so template
// and observation codes are self-consistent by construction. The Voronoi
// cell is obtained from the dual convex hull (plane -> point duality) with
// the same incremental hull routine used for the template matching step.
//
// Exposed as a C API for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int MAXP = 20;    // max points in a matched set (central + nbrs)
constexpr int MAXF = 40;    // max hull facets
constexpr int MAXK = 32;    // max candidate neighbours (+ box planes)

// ---------------------------------------------------------------- small math
inline double dot3(const double* a, const double* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
inline void cross3(const double* a, const double* b, double* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}
inline double norm3(const double* a) { return std::sqrt(dot3(a, a)); }

// solid angle of spherical triangle (unit vectors), Van Oosterom-Strackee
inline double solid_angle(const double* r1, const double* r2, const double* r3) {
    double c23[3];
    cross3(r2, r3, c23);
    double num = dot3(r1, c23);
    double den = 1.0 + dot3(r1, r2) + dot3(r2, r3) + dot3(r3, r1);
    return std::fabs(2.0 * std::atan2(num, den));
}

// Solve 3x3 linear system A x = b (A rows are plane normals).
inline bool solve3(const double A[3][3], const double b[3], double* x) {
    double m[3][4] = {
        {A[0][0], A[0][1], A[0][2], b[0]},
        {A[1][0], A[1][1], A[1][2], b[1]},
        {A[2][0], A[2][1], A[2][2], b[2]},
    };
    for (int c = 0; c < 3; ++c) {
        int p = c;
        for (int r = c + 1; r < 3; ++r)
            if (std::fabs(m[r][c]) > std::fabs(m[p][c])) p = r;
        if (std::fabs(m[p][c]) < 1e-14) return false;
        if (p != c)
            for (int k = c; k < 4; ++k) std::swap(m[p][k], m[c][k]);
        for (int r = 0; r < 3; ++r) {
            if (r == c) continue;
            double f = m[r][c] / m[c][c];
            for (int k = c; k < 4; ++k) m[r][k] -= f * m[c][k];
        }
    }
    for (int c = 0; c < 3; ++c) x[c] = m[c][3] / m[c][c];
    return true;
}

// ------------------------------------------------------------ incremental hull
// Small robust-enough incremental convex hull for <= MAXK well-spread points.
// Produces outward-oriented triangular facets.
struct Hull {
    int nf = 0;
    int facets[MAXF][3];
    bool vertex_used[MAXK];
    bool ok = false;
};

bool build_hull(const double (*pts)[3], int n, Hull& h, double eps) {
    h.nf = 0;
    h.ok = false;
    if (n < 4) return false;
    // initial simplex: spread points
    int i0 = 0, i1 = -1;
    double best = -1;
    for (int i = 1; i < n; ++i) {
        double d[3] = {pts[i][0] - pts[i0][0], pts[i][1] - pts[i0][1],
                       pts[i][2] - pts[i0][2]};
        double q = dot3(d, d);
        if (q > best) { best = q; i1 = i; }
    }
    int i2 = -1;
    best = -1;
    double e0[3] = {pts[i1][0] - pts[i0][0], pts[i1][1] - pts[i0][1],
                    pts[i1][2] - pts[i0][2]};
    for (int i = 0; i < n; ++i) {
        if (i == i0 || i == i1) continue;
        double d[3] = {pts[i][0] - pts[i0][0], pts[i][1] - pts[i0][1],
                       pts[i][2] - pts[i0][2]};
        double c[3];
        cross3(e0, d, c);
        double q = dot3(c, c);
        if (q > best) { best = q; i2 = i; }
    }
    if (i2 < 0 || best < eps * eps) return false;
    int i3 = -1;
    best = -1;
    double e1[3] = {pts[i2][0] - pts[i0][0], pts[i2][1] - pts[i0][1],
                    pts[i2][2] - pts[i0][2]};
    double nrm[3];
    cross3(e0, e1, nrm);
    for (int i = 0; i < n; ++i) {
        if (i == i0 || i == i1 || i == i2) continue;
        double d[3] = {pts[i][0] - pts[i0][0], pts[i][1] - pts[i0][1],
                       pts[i][2] - pts[i0][2]};
        double q = std::fabs(dot3(nrm, d));
        if (q > best) { best = q; i3 = i; }
    }
    if (i3 < 0 || best < eps) return false;

    struct Facet { int v[3]; double n[3]; double d; bool alive; };
    std::vector<Facet> fs;
    fs.reserve(64);
    auto add_facet = [&](int a, int b, int c, const double* interior) {
        Facet f;
        f.v[0] = a; f.v[1] = b; f.v[2] = c;
        double ea[3] = {pts[b][0] - pts[a][0], pts[b][1] - pts[a][1],
                        pts[b][2] - pts[a][2]};
        double eb[3] = {pts[c][0] - pts[a][0], pts[c][1] - pts[a][1],
                        pts[c][2] - pts[a][2]};
        cross3(ea, eb, f.n);
        f.d = dot3(f.n, pts[a]);
        if (dot3(f.n, interior) > f.d) {  // orient outward
            std::swap(f.v[1], f.v[2]);
            f.n[0] = -f.n[0]; f.n[1] = -f.n[1]; f.n[2] = -f.n[2];
            f.d = -f.d;
        }
        f.alive = true;
        fs.push_back(f);
    };
    double interior[3] = {
        (pts[i0][0] + pts[i1][0] + pts[i2][0] + pts[i3][0]) / 4,
        (pts[i0][1] + pts[i1][1] + pts[i2][1] + pts[i3][1]) / 4,
        (pts[i0][2] + pts[i1][2] + pts[i2][2] + pts[i3][2]) / 4,
    };
    add_facet(i0, i1, i2, interior);
    add_facet(i0, i1, i3, interior);
    add_facet(i0, i2, i3, interior);
    add_facet(i1, i2, i3, interior);

    bool done[MAXK] = {};
    done[i0] = done[i1] = done[i2] = done[i3] = true;
    for (int i = 0; i < n; ++i) {
        if (done[i]) continue;
        // find visible facets
        int nvis = 0;
        for (auto& f : fs) {
            if (!f.alive) continue;
            double nl = norm3(f.n);
            if (dot3(f.n, pts[i]) - f.d > eps * nl) { f.alive = false; ++nvis; }
            // temporarily mark: alive=false means visible (to be removed)
        }
        if (nvis == 0) continue;  // interior point
        // horizon edges: edges of removed facets not shared with another
        // removed facet
        std::vector<std::pair<int, int>> horizon;
        for (auto& f : fs) {
            if (f.alive) continue;
            if (f.v[0] < 0) continue;  // already recycled
            for (int e = 0; e < 3; ++e) {
                int a = f.v[e], b = f.v[(e + 1) % 3];
                // shared with another visible facet?
                bool shared = false;
                for (auto& g : fs) {
                    if (g.alive || g.v[0] < 0 || &g == &f) continue;
                    for (int e2 = 0; e2 < 3; ++e2) {
                        if (g.v[e2] == b && g.v[(e2 + 1) % 3] == a) {
                            shared = true;
                            break;
                        }
                    }
                    if (shared) break;
                }
                if (!shared) horizon.emplace_back(a, b);
            }
        }
        // mark removed facets recycled
        for (auto& f : fs)
            if (!f.alive && f.v[0] >= 0) f.v[0] = -1;
        for (auto& e : horizon) add_facet(e.first, e.second, i, interior);
        done[i] = true;
    }
    std::memset(h.vertex_used, 0, sizeof(h.vertex_used));
    h.nf = 0;
    for (auto& f : fs) {
        if (!f.alive || f.v[0] < 0) continue;
        if (h.nf >= MAXF) return false;
        h.facets[h.nf][0] = f.v[0];
        h.facets[h.nf][1] = f.v[1];
        h.facets[h.nf][2] = f.v[2];
        for (int e = 0; e < 3; ++e) h.vertex_used[f.v[e]] = true;
        ++h.nf;
    }
    h.ok = h.nf >= 4;
    return h.ok;
}

// ------------------------------------------------------- Weinberg canonical
// succ[v][u] = w: around vertex v, edge to w follows edge to u in rotation
// (built from outward-oriented facets). Canonical code = lexicographically
// smallest label sequence over all starting directed edges; all labellings
// achieving the minimum are collected (automorphisms).
struct Canon {
    uint64_t hash;
    int n_label;  // number of graph vertices
    // labellings achieving the minimal code: each maps vertex -> label
    std::vector<std::array<int8_t, MAXP>> labellings;
};
}  // namespace
// std::array needs <array>
#include <array>

namespace {

bool weinberg_canonical(int nf, const int (*facets)[3], int nv, Canon& out,
                        const int8_t* colours = nullptr) {
    int8_t succ[MAXP][MAXP];
    std::memset(succ, -1, sizeof(succ));
    int deg[MAXP] = {};
    for (int f = 0; f < nf; ++f) {
        int a = facets[f][0], b = facets[f][1], c = facets[f][2];
        if (succ[a][b] >= 0 || succ[b][c] >= 0 || succ[c][a] >= 0)
            return false;  // non-manifold
        succ[a][b] = c;
        succ[b][c] = a;
        succ[c][a] = b;
        deg[a]++; deg[b]++; deg[c]++;
    }
    const int nedge = 3 * nf;  // directed edges
    int16_t best_code[2 * 3 * MAXF + 2];
    int best_len = -1;
    out.labellings.clear();
    out.n_label = nv;

    int16_t code[2 * 3 * MAXF + 2];
    int8_t label[MAXP];
    bool used[MAXP][MAXP];
    // code element: label * 8 + (first visit ? 1 + colour : 0) — folds the
    // vertex colouring into the canonical form
    auto emit = [&](int vert, bool isnew) -> int16_t {
        int col = colours ? colours[vert] : 0;
        return (int16_t)(label[vert] * 8 + (isnew ? 1 + col : 0));
    };

    for (int sa = 0; sa < nv; ++sa) {
        if (deg[sa] == 0) return false;  // vertex missing from hull
        for (int sb = 0; sb < nv; ++sb) {
            if (succ[sa][sb] < 0) continue;
            std::memset(label, -1, sizeof(label));
            std::memset(used, 0, sizeof(used));
            int nlab = 0, clen = 0;
            int u = sa, v = sb;
            label[u] = nlab++;
            code[clen++] = emit(u, true);
            bool worse = false;   // lexicographically above current best
            bool better = best_len < 0;  // strictly below current best
            for (int step = 0; step < nedge; ++step) {
                used[u][v] = true;
                bool isnew = label[v] < 0;
                if (isnew) label[v] = nlab++;
                code[clen] = emit(v, isnew);
                if (!better) {
                    if (code[clen] > best_code[clen]) { worse = true; break; }
                    if (code[clen] < best_code[clen]) better = true;
                }
                ++clen;
                if (step == nedge - 1) break;
                int w;
                if (isnew) {
                    w = succ[v][u];
                } else if (!used[v][u]) {
                    w = u;
                } else {
                    w = succ[v][u];
                    int guard = 0;
                    while (used[v][w]) {
                        w = succ[v][w];
                        if (++guard > MAXP) { worse = true; break; }
                    }
                    if (worse) break;
                }
                u = v;
                v = w;
            }
            if (worse) continue;
            if (better) {
                std::memcpy(best_code, code, clen * sizeof(int16_t));
                best_len = clen;
                out.labellings.clear();
            }
            std::array<int8_t, MAXP> lab{};
            for (int i = 0; i < nv; ++i) lab[i] = label[i];
            bool dup = false;
            for (auto& ex : out.labellings)
                if (std::memcmp(ex.data(), lab.data(), nv) == 0) { dup = true; break; }
            if (!dup) out.labellings.push_back(lab);
        }
    }
    if (best_len < 0) return false;
    uint64_t hsh = 1469598103934665603ULL;
    for (int i = 0; i < best_len; ++i) {
        hsh ^= (uint64_t)(uint16_t)best_code[i];
        hsh *= 1099511628211ULL;
    }
    hsh ^= (uint64_t)best_len;
    hsh *= 1099511628211ULL;
    out.hash = hsh;
    return true;
}

// -------------------------------------------------------------- rmsd (QCP)
// 4x4 Jacobi eigen for the Davenport K matrix -> max eigenpair.
void jacobi4(double A[4][4], double* evals, double V[4][4]) {
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) V[i][j] = (i == j) ? 1.0 : 0.0;
    for (int sweep = 0; sweep < 50; ++sweep) {
        double off = 0;
        for (int p = 0; p < 4; ++p)
            for (int q = p + 1; q < 4; ++q) off += A[p][q] * A[p][q];
        if (off < 1e-24) break;
        for (int p = 0; p < 4; ++p)
            for (int q = p + 1; q < 4; ++q) {
                if (std::fabs(A[p][q]) < 1e-18) continue;
                double theta = (A[q][q] - A[p][p]) / (2 * A[p][q]);
                double t = (theta >= 0 ? 1.0 : -1.0) /
                           (std::fabs(theta) + std::sqrt(theta * theta + 1));
                double c = 1.0 / std::sqrt(t * t + 1), s = t * c;
                for (int k = 0; k < 4; ++k) {
                    double akp = A[k][p], akq = A[k][q];
                    A[k][p] = c * akp - s * akq;
                    A[k][q] = s * akp + c * akq;
                }
                for (int k = 0; k < 4; ++k) {
                    double apk = A[p][k], aqk = A[q][k];
                    A[p][k] = c * apk - s * aqk;
                    A[q][k] = s * apk + c * aqk;
                }
                for (int k = 0; k < 4; ++k) {
                    double vkp = V[k][p], vkq = V[k][q];
                    V[k][p] = c * vkp - s * vkq;
                    V[k][q] = s * vkp + c * vkq;
                }
            }
    }
    for (int i = 0; i < 4; ++i) evals[i] = A[i][i];
}

// Optimal rotation R (applied to ideal) maximising sum (R u_i) . v_i, via the
// quaternion method; A = sum u_i v_i^T passed in. Returns q (w,x,y,z) and R.
void best_rotation(const double A[3][3], double* q, double R[3][3]) {
    double K[4][4] = {
        {A[0][0] + A[1][1] + A[2][2], A[1][2] - A[2][1], A[2][0] - A[0][2], A[0][1] - A[1][0]},
        {A[1][2] - A[2][1], A[0][0] - A[1][1] - A[2][2], A[0][1] + A[1][0], A[2][0] + A[0][2]},
        {A[2][0] - A[0][2], A[0][1] + A[1][0], A[1][1] - A[0][0] - A[2][2], A[1][2] + A[2][1]},
        {A[0][1] - A[1][0], A[2][0] + A[0][2], A[1][2] + A[2][1], A[2][2] - A[0][0] - A[1][1]},
    };
    double evals[4], V[4][4];
    jacobi4(K, evals, V);
    int bi = 0;
    for (int i = 1; i < 4; ++i)
        if (evals[i] > evals[bi]) bi = i;
    double w = V[0][bi], x = V[1][bi], y = V[2][bi], z = V[3][bi];
    double nq = std::sqrt(w * w + x * x + y * y + z * z);
    w /= nq; x /= nq; y /= nq; z /= nq;
    q[0] = w; q[1] = x; q[2] = y; q[3] = z;
    R[0][0] = 1 - 2 * (y * y + z * z);
    R[0][1] = 2 * (x * y - w * z);
    R[0][2] = 2 * (x * z + w * y);
    R[1][0] = 2 * (x * y + w * z);
    R[1][1] = 1 - 2 * (x * x + z * z);
    R[1][2] = 2 * (y * z - w * x);
    R[2][0] = 2 * (x * z - w * y);
    R[2][1] = 2 * (y * z + w * x);
    R[2][2] = 1 - 2 * (x * x + y * y);
}

// ---------------------------------------------------------------- templates
struct Entry {
    uint64_t hash;
    std::array<int8_t, MAXP> labelling;  // template nbr index -> canonical label
};

struct Template {
    int type_id = 0;
    int num_nbrs = 0;
    int num_facets = 0;
    int max_degree = 0;
    bool require_deg4 = false;  // sc gate
    int kind = 0;               // 0 single-shell, 1 two-shell graph, 2 direct
    int8_t colours[MAXP] = {};
    double ideal[MAXP][3];      // normalised template (central first)
    double nn_dist = 0;         // |ideal[1]| for interatomic-distance output
    double G1 = 0;
    std::vector<Entry> entries;
    std::map<uint64_t, std::vector<int>> by_hash;
};

struct Ctx {
    std::vector<Template> templates;
};

// observed-side canonical data, shared between structures with the same
// neighbour count (fcc/hcp/ico share the 12-point hull)
struct Observed {
    bool valid = false;
    uint64_t hash = 0;
    int nf = 0;
    int max_degree = 0;
    bool all_deg4 = true;
    int8_t inv_label[MAXP];      // canonical label -> observed nbr index
    double normalized[MAXP][3];  // barycentre-subtracted raw points
    double G2 = 0;
};

void compute_observed(const double (*points)[3], int num_points, Observed& ob) {
    ob.valid = false;
    // normalise (scale-free) copy for the hull
    double bary[3] = {0, 0, 0};
    for (int i = 0; i < num_points; ++i)
        for (int d = 0; d < 3; ++d) bary[d] += points[i][d];
    for (int d = 0; d < 3; ++d) bary[d] /= num_points;
    double chp[MAXP][3];
    double mean = 0;
    for (int i = 0; i < num_points; ++i) {
        for (int d = 0; d < 3; ++d) {
            ob.normalized[i][d] = points[i][d] - bary[d];
            chp[i][d] = ob.normalized[i][d];
        }
        if (i > 0) mean += norm3(ob.normalized[i]);
    }
    mean /= num_points;
    if (mean < 1e-12) return;
    for (int i = 0; i < num_points; ++i)
        for (int d = 0; d < 3; ++d) chp[i][d] /= mean;

    Hull h;
    if (!build_hull(chp, num_points, h, 1e-8)) return;
    if (h.vertex_used[0]) return;  // central atom on hull -> not a cage
    for (int i = 1; i < num_points; ++i)
        if (!h.vertex_used[i]) return;  // interior neighbour

    // relabel facets to neighbour indexing (0..num_nbrs-1)
    int facets[MAXF][3];
    for (int f = 0; f < h.nf; ++f)
        for (int e = 0; e < 3; ++e) facets[f][e] = h.facets[f][e] - 1;
    int nv = num_points - 1;
    int deg[MAXP] = {};
    for (int f = 0; f < h.nf; ++f)
        for (int e = 0; e < 3; ++e) deg[facets[f][e]]++;
    ob.max_degree = 0;
    ob.all_deg4 = true;
    for (int i = 0; i < nv; ++i) {
        if (deg[i] > ob.max_degree) ob.max_degree = deg[i];
        if (deg[i] != 4) ob.all_deg4 = false;
    }
    ob.nf = h.nf;

    Canon canon;
    if (!weinberg_canonical(h.nf, facets, nv, canon)) return;
    ob.hash = canon.hash;
    const auto& lab = canon.labellings[0];
    for (int i = 0; i < nv; ++i) ob.inv_label[lab[i]] = (int8_t)i;
    ob.G2 = 0;
    for (int i = 0; i < num_points; ++i) ob.G2 += dot3(ob.normalized[i], ob.normalized[i]);
    ob.valid = true;
}

struct MatchResult {
    double rmsd = 1e30;
    double scale = 0;
    double q[4] = {1, 0, 0, 0};
    int type_id = 0;
    int num_nbrs = 0;
    double nn_dist = 0;
    int8_t mapping[MAXP];  // ideal point index -> observed point index
};

void try_template(const Template& t, const Observed& ob, MatchResult& best) {
    if (!ob.valid) return;
    if (ob.nf != t.num_facets) return;
    if (ob.max_degree > t.max_degree) return;
    if (t.require_deg4 && !ob.all_deg4) return;
    auto it = t.by_hash.find(ob.hash);
    if (it == t.by_hash.end()) return;
    int num_points = t.num_nbrs + 1;
    for (int ei : it->second) {
        const Entry& e = t.entries[ei];
        int8_t mapping[MAXP];
        mapping[0] = 0;
        for (int v = 0; v < t.num_nbrs; ++v)
            mapping[1 + v] = (int8_t)(1 + ob.inv_label[e.labelling[v]]);
        // A = sum ideal_i (x) obs_map[i]
        double A[3][3] = {};
        for (int i = 0; i < num_points; ++i) {
            const double* u = t.ideal[i];
            const double* v = ob.normalized[mapping[i]];
            for (int r = 0; r < 3; ++r)
                for (int c = 0; c < 3; ++c) A[r][c] += u[r] * v[c];
        }
        double q[4], R[3][3];
        best_rotation(A, q, R);
        double k0 = 0;
        for (int i = 0; i < num_points; ++i) {
            const double* u = t.ideal[i];
            const double* v = ob.normalized[mapping[i]];
            for (int r = 0; r < 3; ++r)
                k0 += (R[r][0] * u[0] + R[r][1] * u[1] + R[r][2] * u[2]) * v[r];
        }
        double scale = k0 / ob.G2;
        double rmsd = std::sqrt(std::fabs(t.G1 - scale * k0) / num_points);
        if (rmsd < best.rmsd) {
            best.rmsd = rmsd;
            best.scale = scale;
            best.type_id = t.type_id;
            best.num_nbrs = t.num_nbrs;
            best.nn_dist = t.nn_dist;
            std::memcpy(best.q, q, sizeof(q));
            std::memcpy(best.mapping, mapping, sizeof(mapping));
        }
    }
}

// Diamond (dcub/dhex) observed side: the 4 inner atoms of a perfect
// diamond environment are interior to the hull of the 12 outer atoms; each
// is re-inserted into the all-outer facet formed by its own 3 second-shell
// neighbours (facet surgery, cf. Larsen's matcher). Inner atoms that do sit
// on the hull ("inverted", under large strain) already contribute facets.
// Point layout: [central, inner x4, outer x12 grouped 3-per-inner].
bool compute_observed_diamond(const double (*points)[3], Observed& ob) {
    ob.valid = false;
    const int num_points = 17;
    double bary[3] = {0, 0, 0};
    for (int i = 0; i < num_points; ++i)
        for (int d = 0; d < 3; ++d) bary[d] += points[i][d];
    for (int d = 0; d < 3; ++d) bary[d] /= num_points;
    double chp[MAXP][3];
    double mean = 0;
    for (int i = 0; i < num_points; ++i) {
        for (int d = 0; d < 3; ++d) {
            ob.normalized[i][d] = points[i][d] - bary[d];
            chp[i][d] = ob.normalized[i][d];
        }
        if (i > 0) mean += norm3(ob.normalized[i]);
    }
    mean /= num_points;
    if (mean < 1e-12) return false;
    for (int i = 0; i < num_points; ++i)
        for (int d = 0; d < 3; ++d) chp[i][d] /= mean;

    Hull h;
    if (!build_hull(chp, num_points, h, 1e-8)) return false;
    if (h.vertex_used[0]) return false;

    int facets[MAXF][3];
    int nf = h.nf;
    if (nf > MAXF - 12) return false;
    for (int f = 0; f < nf; ++f)
        for (int e = 0; e < 3; ++e) facets[f][e] = h.facets[f][e] - 1;

    bool inverted[4] = {false, false, false, false};
    for (int f = 0; f < nf; ++f) {
        int n_inner = 0;
        for (int e = 0; e < 3; ++e)
            if (facets[f][e] <= 3) { inverted[facets[f][e]] = true; ++n_inner; }
        if (n_inner > 1) return false;
    }
    int num_inverted = 0;
    for (int i = 0; i < 4; ++i) num_inverted += inverted[i] ? 1 : 0;
    if (nf != 20 + 2 * num_inverted) return false;

    // remove all-outer facets whose vertices share one inner group
    int toadd[4][3];
    int num_found = 0;
    for (int f = 0; f < nf; ++f) {
        int a = facets[f][0], b = facets[f][1], c = facets[f][2];
        if (a <= 3 || b <= 3 || c <= 3) continue;
        int i0 = (a - 4) / 3, i1 = (b - 4) / 3, i2 = (c - 4) / 3;
        if (i0 == i1 && i0 == i2) {
            if (num_found + num_inverted >= 4) return false;
            toadd[num_found][0] = a;
            toadd[num_found][1] = b;
            toadd[num_found][2] = c;
            ++num_found;
            facets[f][0] = facets[nf - 1][0];
            facets[f][1] = facets[nf - 1][1];
            facets[f][2] = facets[nf - 1][2];
            --nf;
            --f;
        }
    }
    if (num_found + num_inverted != 4) return false;
    for (int i = 0; i < num_found; ++i) {
        int a = toadd[i][0], b = toadd[i][1], c = toadd[i][2];
        int i0 = (a - 4) / 3;
        facets[nf][0] = i0; facets[nf][1] = b; facets[nf][2] = c; ++nf;
        facets[nf][0] = a; facets[nf][1] = i0; facets[nf][2] = c; ++nf;
        facets[nf][0] = a; facets[nf][1] = b; facets[nf][2] = i0; ++nf;
    }

    const int nv = 16;
    int deg[MAXP] = {};
    for (int f = 0; f < nf; ++f)
        for (int e = 0; e < 3; ++e) deg[facets[f][e]]++;
    ob.max_degree = 0;
    ob.all_deg4 = false;
    for (int i = 0; i < nv; ++i)
        if (deg[i] > ob.max_degree) ob.max_degree = deg[i];
    ob.nf = nf;

    static const int8_t DIAMOND_COLOURS[MAXP] = {1, 1, 1, 1, 0, 0, 0, 0,
                                                 0, 0, 0, 0, 0, 0, 0, 0};
    Canon canon;
    if (!weinberg_canonical(nf, facets, nv, canon, DIAMOND_COLOURS))
        return false;
    ob.hash = canon.hash;
    const auto& lab = canon.labellings[0];
    for (int i = 0; i < nv; ++i) ob.inv_label[lab[i]] = (int8_t)i;
    ob.G2 = 0;
    for (int i = 0; i < num_points; ++i)
        ob.G2 += dot3(ob.normalized[i], ob.normalized[i]);
    ob.valid = true;
    return true;
}

// Graphene direct matcher: layout [central, inner x3, outer pairs (4,5),
// (6,7), (8,9)]; no hull — try the 8 outer-pair swaps.
void try_graphene(const Template& t, const double (*points)[3],
                  MatchResult& best) {
    const int num_points = 10;
    double normalized[MAXP][3];
    double bary[3] = {0, 0, 0};
    for (int i = 0; i < num_points; ++i)
        for (int d = 0; d < 3; ++d) bary[d] += points[i][d];
    for (int d = 0; d < 3; ++d) bary[d] /= num_points;
    double G2 = 0;
    for (int i = 0; i < num_points; ++i) {
        for (int d = 0; d < 3; ++d)
            normalized[i][d] = points[i][d] - bary[d];
        G2 += dot3(normalized[i], normalized[i]);
    }
    int8_t mapping[MAXP];
    for (int i = 0; i < num_points; ++i) mapping[i] = (int8_t)i;
    for (int s1 = 0; s1 < 2; ++s1) {
        std::swap(mapping[4], mapping[5]);
        for (int s2 = 0; s2 < 2; ++s2) {
            std::swap(mapping[6], mapping[7]);
            for (int s3 = 0; s3 < 2; ++s3) {
                std::swap(mapping[8], mapping[9]);
                double A[3][3] = {};
                for (int i = 0; i < num_points; ++i) {
                    const double* u = t.ideal[i];
                    const double* v = normalized[mapping[i]];
                    for (int r = 0; r < 3; ++r)
                        for (int c = 0; c < 3; ++c) A[r][c] += u[r] * v[c];
                }
                double q[4], R[3][3];
                best_rotation(A, q, R);
                double k0 = 0;
                for (int i = 0; i < num_points; ++i) {
                    const double* u = t.ideal[i];
                    const double* v = normalized[mapping[i]];
                    for (int r = 0; r < 3; ++r)
                        k0 += (R[r][0] * u[0] + R[r][1] * u[1] +
                               R[r][2] * u[2]) * v[r];
                }
                double scale = k0 / G2;
                double rmsd = std::sqrt(std::fabs(t.G1 - scale * k0) / num_points);
                if (rmsd < best.rmsd) {
                    best.rmsd = rmsd;
                    best.scale = scale;
                    best.type_id = t.type_id;
                    best.num_nbrs = t.num_nbrs;
                    best.nn_dist = t.nn_dist;
                    std::memcpy(best.q, q, sizeof(q));
                    std::memcpy(best.mapping, mapping, sizeof(mapping));
                }
            }
        }
    }
}

// ------------------------------------------------- solid-angle ordering
// Voronoi cell of the origin w.r.t. midplanes of up to K neighbours plus a
// bounding cube; face solid angles via the dual convex hull.
int solid_angle_order(const double (*delta)[3], int k, int* order) {
    double areas[MAXK] = {};
    double normsq[MAXK];
    double max_norm = 0;
    for (int i = 0; i < k; ++i) {
        normsq[i] = dot3(delta[i], delta[i]);
        max_norm = std::max(max_norm, normsq[i]);
    }
    max_norm = std::sqrt(max_norm);
    double bound = 10.0 * max_norm;
    // halfspaces: n.x <= b  (neighbour midplanes and cube walls)
    double nrm[MAXK + 6][3];
    double off[MAXK + 6];
    int nh = 0;
    for (int i = 0; i < k; ++i) {
        nrm[nh][0] = delta[i][0];
        nrm[nh][1] = delta[i][1];
        nrm[nh][2] = delta[i][2];
        off[nh] = normsq[i] / 2.0;
        ++nh;
    }
    for (int d = 0; d < 3; ++d)
        for (int s = -1; s <= 1; s += 2) {
            nrm[nh][0] = nrm[nh][1] = nrm[nh][2] = 0;
            nrm[nh][d] = s;
            off[nh] = bound;
            ++nh;
        }
    // dual points n/b (origin strictly inside all halfspaces since b>0)
    double dual[MAXK + 6][3];
    for (int i = 0; i < nh; ++i) {
        if (off[i] < 1e-12) return -1;
        for (int d = 0; d < 3; ++d) dual[i][d] = nrm[i][d] / off[i];
    }
    Hull h;
    if (!build_hull(dual, nh, h, 1e-12)) return -1;
    // cell vertex per dual facet
    double verts[MAXF][3];
    for (int f = 0; f < h.nf; ++f) {
        double A[3][3], b[3];
        for (int e = 0; e < 3; ++e) {
            int i = h.facets[f][e];
            A[e][0] = nrm[i][0];
            A[e][1] = nrm[i][1];
            A[e][2] = nrm[i][2];
            b[e] = off[i];
        }
        if (!solve3(A, b, verts[f])) return -1;
        double n = norm3(verts[f]);
        if (n < 1e-12) return -1;
        for (int d = 0; d < 3; ++d) verts[f][d] /= n;
    }
    // umbrella of facets around each dual vertex i = cyclic face of nbr i
    // succ_facet: for vertex i in facet f, the next facet sharing edge
    int8_t succv[MAXK + 6][MAXK + 6];
    std::memset(succv, -1, sizeof(succv));
    int fidx[MAXK + 6][MAXK + 6];
    for (int f = 0; f < h.nf; ++f) {
        for (int e = 0; e < 3; ++e) {
            int a = h.facets[f][e];
            int b2 = h.facets[f][(e + 1) % 3];
            int c = h.facets[f][(e + 2) % 3];
            succv[a][b2] = (int8_t)c;
            fidx[a][b2] = f;  // facet containing directed edge a: b2 -> c order
        }
    }
    for (int i = 0; i < k; ++i) {
        if (!h.vertex_used[i]) { areas[i] = 0; continue; }
        // find a starting co-vertex
        int start = -1;
        for (int j = 0; j < nh; ++j)
            if (succv[i][j] >= 0) { start = j; break; }
        if (start < 0) { areas[i] = 0; continue; }
        // walk the umbrella, collecting facet vertices in cyclic order
        double poly[MAXF][3];
        int np = 0;
        int j = start;
        int guard = 0;
        do {
            int f = fidx[i][j];
            for (int d = 0; d < 3; ++d) poly[np][d] = verts[f][d];
            ++np;
            j = succv[i][j];
            if (++guard > MAXF) return -1;
        } while (j != start && np < MAXF);
        double omega = 0;
        for (int t2 = 2; t2 < np; ++t2)
            omega += solid_angle(poly[0], poly[t2 - 1], poly[t2]);
        areas[i] = omega;
    }
    // stable sort: area desc, tie normsq asc, stable by input order
    for (int i = 0; i < k; ++i) order[i] = i;
    std::stable_sort(order, order + k, [&](int a, int b) {
        if (areas[a] > areas[b]) return true;
        if (areas[a] < areas[b]) return false;
        return normsq[a] < normsq[b];
    });
    return 0;
}

}  // namespace

extern "C" {

Ctx* ptmx_create() { return new Ctx(); }
void ptmx_destroy(Ctx* c) { delete c; }

// points: (num_nbrs+1) x 3 raw template coordinates, central first.
// facets_flat: n_var * nf * 3 neighbour-indexed, outward-oriented triangles.
// Returns 0 on success.
int ptmx_add_template(Ctx* ctx, int type_id, int num_nbrs, const double* points,
                      int n_var, int nf, const int* facets_flat,
                      int require_deg4, const int* colours, int kind) {
    Template t;
    t.type_id = type_id;
    t.num_nbrs = num_nbrs;
    t.num_facets = nf;
    t.require_deg4 = require_deg4 != 0;
    t.kind = kind;
    for (int i = 0; i < num_nbrs; ++i)
        t.colours[i] = colours ? (int8_t)colours[i] : 0;
    int num_points = num_nbrs + 1;
    // normalise: subtract barycentre, mean neighbour distance -> 1
    double bary[3] = {0, 0, 0};
    for (int i = 0; i < num_points; ++i)
        for (int d = 0; d < 3; ++d) bary[d] += points[i * 3 + d];
    for (int d = 0; d < 3; ++d) bary[d] /= num_points;
    double mean = 0;
    for (int i = 0; i < num_points; ++i) {
        for (int d = 0; d < 3; ++d) t.ideal[i][d] = points[i * 3 + d] - bary[d];
        if (i > 0) mean += norm3(t.ideal[i]);
    }
    mean /= num_nbrs;
    for (int i = 0; i < num_points; ++i)
        for (int d = 0; d < 3; ++d) t.ideal[i][d] /= mean;
    t.nn_dist = norm3(t.ideal[1]);
    for (int i = 1; i < num_points; ++i)
        t.nn_dist = std::min(t.nn_dist, norm3(t.ideal[i]));
    t.G1 = 0;
    for (int i = 0; i < num_points; ++i) t.G1 += dot3(t.ideal[i], t.ideal[i]);

    t.max_degree = 0;
    for (int v = 0; v < n_var; ++v) {
        int facets[MAXF][3];
        int deg[MAXP] = {};
        for (int f = 0; f < nf; ++f)
            for (int e = 0; e < 3; ++e) {
                facets[f][e] = facets_flat[(v * nf + f) * 3 + e];
                deg[facets[f][e]]++;
            }
        for (int i = 0; i < num_nbrs; ++i)
            t.max_degree = std::max(t.max_degree, deg[i]);
        Canon canon;
        if (!weinberg_canonical(nf, facets, num_nbrs, canon, t.colours))
            return -1;
        for (auto& lab : canon.labellings) {
            Entry e;
            e.hash = canon.hash;
            e.labelling = lab;
            bool dup = false;
            for (auto& ex : t.entries)
                if (ex.hash == e.hash &&
                    std::memcmp(ex.labelling.data(), e.labelling.data(),
                                num_nbrs) == 0) { dup = true; break; }
            if (!dup) t.entries.push_back(e);
        }
    }
    for (size_t i = 0; i < t.entries.size(); ++i)
        t.by_hash[t.entries[i].hash].push_back((int)i);
    ctx->templates.push_back(std::move(t));
    return (int)ctx->templates.size() - 1;
}

int ptmx_num_entries(Ctx* ctx, int tmpl_idx) {
    return (int)ctx->templates[tmpl_idx].entries.size();
}

// Assemble a two-shell environment: [central, inner x ni, outer grouped
// no-per-inner]. order/ordn hold every atom's solid-angle ordering (first 13
// ranked neighbour slots). Returns env atom "slots": for out_map we record
// (atom, slot-of-owner) pairs as global atom indices instead.
bool build_two_shell(
    long long i, int ni, int no, int K, const double* deltas,
    const long long* nbr_idx, const int8_t* ord, const int* ordn,
    double (*env_pts)[3], long long* env_atoms) {
    int k0 = std::min(ordn[i], 13);
    if (k0 < ni) return false;
    env_pts[0][0] = env_pts[0][1] = env_pts[0][2] = 0;
    env_atoms[0] = i;
    for (int j = 0; j < ni; ++j) {
        int slot = ord[i * 18 + j];
        for (int d = 0; d < 3; ++d)
            env_pts[1 + j][d] = deltas[(i * K + slot) * 3 + d];
        env_atoms[1 + j] = nbr_idx[i * K + slot];
    }
    double d01[3] = {env_pts[1][0], env_pts[1][1], env_pts[1][2]};
    double tol = std::max(1e-5 * norm3(d01), 1e-5);

    struct Cand { int rank; int inner; long long atom; double delta[3]; };
    Cand cands[4 * 13];
    int nc = 0;
    for (int j = 0; j < ni; ++j) {
        long long a = env_atoms[1 + j];
        int ka = std::min(ordn[a], 13);
        if (ka < ni) return false;
        for (int r = 0; r < ka; ++r) {
            int slot = ord[a * 18 + r];
            Cand c;
            c.rank = r + 1;
            c.inner = j;
            c.atom = nbr_idx[a * K + slot];
            for (int d = 0; d < 3; ++d)
                c.delta[d] = env_pts[1 + j][d] + deltas[(a * K + slot) * 3 + d];
            cands[nc++] = c;
        }
    }
    std::stable_sort(cands, cands + nc,
                     [](const Cand& a, const Cand& b) { return a.rank < b.rank; });

    int counts[4] = {0, 0, 0, 0};
    int found = 0;
    for (int c = 0; c < nc && found < ni * no; ++c) {
        int inner = cands[c].inner;
        if (counts[inner] >= no) continue;
        // already claimed? (central + inners + claimed outers)
        bool claimed = false;
        for (int j = 0; j < ni + 1 && !claimed; ++j) {
            if (cands[c].atom == env_atoms[j]) {
                double dd[3] = {cands[c].delta[0] - env_pts[j][0],
                                cands[c].delta[1] - env_pts[j][1],
                                cands[c].delta[2] - env_pts[j][2]};
                if (norm3(dd) < tol) claimed = true;
            }
        }
        for (int j = 0; j < ni && !claimed; ++j) {
            for (int m = 0; m < counts[j] && !claimed; ++m) {
                int idx = 1 + ni + no * j + m;
                if (cands[c].atom == env_atoms[idx]) {
                    double dd[3] = {cands[c].delta[0] - env_pts[idx][0],
                                    cands[c].delta[1] - env_pts[idx][1],
                                    cands[c].delta[2] - env_pts[idx][2]};
                    if (norm3(dd) < tol) claimed = true;
                }
            }
        }
        if (claimed) continue;
        int idx = 1 + ni + no * inner + counts[inner];
        env_atoms[idx] = cands[c].atom;
        for (int d = 0; d < 3; ++d) env_pts[idx][d] = cands[c].delta[d];
        counts[inner]++;
        ++found;
    }
    return found == ni * no;
}

// deltas: N x K x 3 neighbour displacement vectors (min-imaged, dist-sorted).
// nbr_idx: N x K neighbour atom indices. counts: valid neighbour counts.
// enabled: per-template 0/1. out: N x 8 (type, ordering, rmsd, interatomic
// distance, q0..q3). out_atoms: N x MAXP matched atom index per template
// position (central first; -1 unused).
void ptmx_compute(Ctx* ctx, long long N, int K, const double* deltas,
                  const long long* nbr_idx, const int* counts,
                  const int* enabled, double threshold, double* out,
                  long long* out_atoms, int nthreads) {
    const int ntempl = (int)ctx->templates.size();
    bool want_two_shell = false, want_graphene = false;
    for (int ti = 0; ti < ntempl; ++ti) {
        if (!enabled[ti]) continue;
        if (ctx->templates[ti].kind == 1) want_two_shell = true;
        if (ctx->templates[ti].kind == 2) want_graphene = true;
    }

    // pass 1: per-atom solid-angle orderings
    std::vector<int8_t> ord((size_t)N * 18);
    std::vector<int> ordn(N, 0);
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads) schedule(dynamic, 64)
#endif
    for (long long i = 0; i < N; ++i) {
        int k = counts[i];
        if (k < 3) continue;
        if (k > 18) k = 18;
        double delta[MAXK][3];
        for (int j = 0; j < k; ++j)
            for (int d = 0; d < 3; ++d)
                delta[j][d] = deltas[(i * K + j) * 3 + d];
        int order[MAXK];
        if (solid_angle_order(delta, k, order) != 0) continue;
        for (int j = 0; j < k; ++j) ord[i * 18 + j] = (int8_t)order[j];
        ordn[i] = k;
    }

#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads) schedule(dynamic, 64)
#endif
    for (long long i = 0; i < N; ++i) {
        double* o = &out[i * 8];
        long long* om = &out_atoms[i * MAXP];
        for (int j = 0; j < 8; ++j) o[j] = 0;
        for (int j = 0; j < MAXP; ++j) om[j] = -1;
        int k = ordn[i];
        if (k < 3) continue;

        double pts[MAXP][3] = {};
        int maxp = std::min(k, MAXP - 1);
        for (int j = 0; j < maxp; ++j) {
            int slot = ord[i * 18 + j];
            for (int d = 0; d < 3; ++d)
                pts[1 + j][d] = deltas[(i * K + slot) * 3 + d];
        }

        MatchResult best;
        Observed cache[MAXP + 1];
        bool cached[MAXP + 1] = {};

        double denv_pts[MAXP][3];
        long long denv_atoms[MAXP];
        bool denv_ok = false;
        if (want_two_shell)
            denv_ok = build_two_shell(i, 4, 3, K, deltas, nbr_idx, ord.data(),
                                      ordn.data(), denv_pts, denv_atoms);
        Observed dob;
        bool dob_done = false;

        double genv_pts[MAXP][3];
        long long genv_atoms[MAXP];
        bool genv_ok = false;
        if (want_graphene)
            genv_ok = build_two_shell(i, 3, 2, K, deltas, nbr_idx, ord.data(),
                                      ordn.data(), genv_pts, genv_atoms);

        int best_kind = 0;
        for (int ti = 0; ti < ntempl; ++ti) {
            if (!enabled[ti]) continue;
            const Template& t = ctx->templates[ti];
            double prev = best.rmsd;
            if (t.kind == 0) {
                int np = t.num_nbrs + 1;
                if (np > maxp + 1) continue;
                if (!cached[np]) {
                    compute_observed(pts, np, cache[np]);
                    cached[np] = true;
                }
                try_template(t, cache[np], best);
            } else if (t.kind == 1) {
                if (!denv_ok) continue;
                if (!dob_done) {
                    compute_observed_diamond(denv_pts, dob);
                    dob_done = true;
                }
                try_template(t, dob, best);
            } else {
                if (!genv_ok) continue;
                try_graphene(t, genv_pts, best);
            }
            if (best.rmsd < prev) best_kind = t.kind;
        }
        if (best.rmsd > threshold) continue;
        o[0] = best.type_id;
        o[1] = 0;  // alloy ordering: not yet implemented
        o[2] = best.rmsd;
        o[3] = best.nn_dist / best.scale;  // interatomic distance
        o[4] = best.q[0];
        o[5] = best.q[1];
        o[6] = best.q[2];
        o[7] = best.q[3];
        if (best_kind == 0) {
            om[0] = nbr_idx ? i : i;
            for (int j = 1; j <= best.num_nbrs; ++j) {
                int slot = ord[i * 18 + (best.mapping[j] - 1)];
                om[j] = nbr_idx[i * K + slot];
            }
        } else {
            long long* env_atoms = best_kind == 1 ? denv_atoms : genv_atoms;
            for (int j = 0; j <= best.num_nbrs; ++j)
                om[j] = env_atoms[best.mapping[j]];
        }
    }
}

}  // extern "C"
