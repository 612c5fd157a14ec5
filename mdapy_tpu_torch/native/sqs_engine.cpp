// A copy of mdapy_tpu/native/sqs_engine.cpp (:1-378, whole and unchanged),
// built by mdapy_tpu_torch/native/__init__.py:load_library (no -march=native,
// so no FMA contraction where the JAX package's build has it: ROADMAP C16).
//
// TPU-framework native runtime component: SQS Monte-Carlo swap engine.
//
// Design notes (fresh architecture, not a translation):
//   * Geometry-major layout. A *cluster* is a geometric tuple of 2..4 atom
//     indices plus a distance-shell id. A *channel* is (body order, shell,
//     canonical function tuple). Clusters are stored once; each cluster
//     contributes to the contiguous block of channels belonging to its
//     (body, shell) — the channel block table is built host-side in Python
//     and passed in as flat arrays.
//   * Per-cluster "sigma" for a function tuple f is the permutation-averaged
//     product  (1/n!) sum_perm prod_p phi[f_p][type[a_perm(p)]]  — i.e.
//     perm(A)/n! with A[p][q] = phi[f_p][type[a_q]]. Evaluated with static
//     permutation index tables for n <= 4.
//   * Incremental Metropolis: a swap (i, j) touches only the clusters listed
//     in the CSR adjacency of i and j (clusters containing both atoms are
//     visited once, through i's list). Channel sums are patched, the ATAT
//     mcsqs objective (van de Walle CALPHAD 42 (2013): weighted residual
//     over d >= d1 minus the d1 perfect-match reward) is re-evaluated over
//     the channel table, and the move is accepted/rejected.
//   * Replicas: independent chains, OpenMP parallel, each tracking its
//     best-ever (lowest objective) configuration; global best wins.
//
// Exposed as a plain C API for ctypes (no pybind11 in this environment).
// Behavioural parity target: reference src/sqs.cpp + src/mdapy/sqs.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// permutation index tables for n = 2, 3, 4
static const int PERM2[2][2] = {{0, 1}, {1, 0}};
static const int PERM3[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};
static const int PERM4[24][4] = {
    {0, 1, 2, 3}, {0, 1, 3, 2}, {0, 2, 1, 3}, {0, 2, 3, 1}, {0, 3, 1, 2},
    {0, 3, 2, 1}, {1, 0, 2, 3}, {1, 0, 3, 2}, {1, 2, 0, 3}, {1, 2, 3, 0},
    {1, 3, 0, 2}, {1, 3, 2, 0}, {2, 0, 1, 3}, {2, 0, 3, 1}, {2, 1, 0, 3},
    {2, 1, 3, 0}, {2, 3, 0, 1}, {2, 3, 1, 0}, {3, 0, 1, 2}, {3, 0, 2, 1},
    {3, 1, 0, 2}, {3, 1, 2, 0}, {3, 2, 0, 1}, {3, 2, 1, 0}};

struct Engine {
    int n_atoms = 0;
    int n_species = 0;
    int n_func = 0;

    // phi table, row-major [n_func][n_species]
    std::vector<double> phi;

    // channel table
    int nc = 0;
    std::vector<int> ch_npts;      // [nc]
    std::vector<int> ch_funcs;     // [nc*4]
    std::vector<int> ch_ninst;     // [nc] number of contributing clusters
    std::vector<double> ch_target; // [nc]
    std::vector<double> ch_diam;   // [nc]
    std::vector<double> ch_weight; // [nc] shell weight * npts weight baked host-side? no: raw shell weight

    // cluster table
    int ncl = 0;
    std::vector<int> cl_atoms;     // [ncl*4], -1 padded
    std::vector<int> cl_npts;      // [ncl]
    std::vector<int> cl_ch0;       // [ncl] first channel of this cluster's block
    std::vector<int> cl_nch;       // [ncl] block size

    // CSR atom -> cluster adjacency
    std::vector<int> adj_off;      // [n_atoms+1]
    std::vector<int> adj;          // cluster ids

    // objective parameters
    int mode = 1;          // 0 = plain weighted sum, 1 = ATAT d1
    double tol = 1e-3;
    double w_dist = 1.0;
    double rho = 1.0;      // per-extra-body weight (atat_w_npts)
    int max_npts = 2;
    double d_min = 1.0;

    // --- sigma of one cluster for every channel in its block -------------
    // out must hold cl_nch[c] doubles.
    inline void cluster_sigmas(int c, const int* types, double* out) const {
        const int n = cl_npts[c];
        const int* a = &cl_atoms[(size_t)c * 4];
        const int c0 = cl_ch0[c];
        const int nf = cl_nch[c];
        // type-resolved phi columns: col[q][k] = phi[k][type[a_q]]
        int t[4];
        for (int q = 0; q < n; ++q) t[q] = types[a[q]];
        for (int f = 0; f < nf; ++f) {
            const int* fn = &ch_funcs[(size_t)(c0 + f) * 4];
            double acc = 0.0;
            if (n == 2) {
                for (int p = 0; p < 2; ++p) {
                    acc += phi[fn[0] * n_species + t[PERM2[p][0]]] *
                           phi[fn[1] * n_species + t[PERM2[p][1]]];
                }
                acc *= (1.0 / 2.0);
            } else if (n == 3) {
                for (int p = 0; p < 6; ++p) {
                    acc += phi[fn[0] * n_species + t[PERM3[p][0]]] *
                           phi[fn[1] * n_species + t[PERM3[p][1]]] *
                           phi[fn[2] * n_species + t[PERM3[p][2]]];
                }
                acc *= (1.0 / 6.0);
            } else {
                for (int p = 0; p < 24; ++p) {
                    acc += phi[fn[0] * n_species + t[PERM4[p][0]]] *
                           phi[fn[1] * n_species + t[PERM4[p][1]]] *
                           phi[fn[2] * n_species + t[PERM4[p][2]]] *
                           phi[fn[3] * n_species + t[PERM4[p][3]]];
                }
                acc *= (1.0 / 24.0);
            }
            out[f] = acc;
        }
    }

    void full_sums(const int* types, double* sums) const {
        std::fill(sums, sums + nc, 0.0);
        double buf[64];
        for (int c = 0; c < ncl; ++c) {
            cluster_sigmas(c, types, buf);
            const int c0 = cl_ch0[c];
            for (int f = 0; f < cl_nch[c]; ++f) sums[c0 + f] += buf[f];
        }
    }

    double objective(const double* sums) const {
        if (mode == 0) {
            double obj = 0.0;
            for (int i = 0; i < nc; ++i) {
                double pi = sums[i] / (double)ch_ninst[i];
                obj += ch_weight[i] * std::fabs(pi - ch_target[i]);
            }
            return obj;
        }
        // ATAT d1 formula: per body order b (= npts-2), maxdist[b] starts at
        // (largest diameter of that body) + d_min and shrinks to the smallest
        // mismatched diameter; then made monotonically non-increasing over b.
        const int nb = max_npts - 1;
        double maxdist[3];
        for (int b = 0; b < nb; ++b) maxdist[b] = 0.0;
        for (int i = 0; i < nc; ++i) {
            int b = ch_npts[i] - 2;
            if (ch_diam[i] > maxdist[b]) maxdist[b] = ch_diam[i];
        }
        for (int b = 0; b < nb; ++b) maxdist[b] += d_min;
        double dev_buf_static[512];
        std::vector<double> dev_heap;
        double* dev = dev_buf_static;
        if (nc > 512) { dev_heap.resize(nc); dev = dev_heap.data(); }
        for (int i = 0; i < nc; ++i) {
            double pi = sums[i] / (double)ch_ninst[i];
            double d = std::fabs(pi - ch_target[i]);
            dev[i] = d;
            int b = ch_npts[i] - 2;
            if (d > tol && ch_diam[i] < maxdist[b]) maxdist[b] = ch_diam[i];
        }
        double d1 = maxdist[0];
        for (int b = 1; b < nb; ++b) {
            if (maxdist[b] > maxdist[b - 1]) maxdist[b] = maxdist[b - 1];
            if (maxdist[b] < d1) d1 = maxdist[b];
        }
        double num = 0.0, den = 0.0;
        for (int i = 0; i < nc; ++i) {
            if (ch_diam[i] >= d1 - 1e-12) {
                double w = ch_weight[i] * std::pow(rho, ch_npts[i] - 2);
                num += dev[i] * w;
                den += w;
            }
        }
        double obj = den > 0.0 ? num / den : 0.0;
        for (int b = 0; b < nb; ++b) {
            obj -= w_dist * std::pow(rho, b) * maxdist[b] / d_min;
        }
        return obj;
    }

    inline bool cluster_has_atom(int c, int atom) const {
        const int* a = &cl_atoms[(size_t)c * 4];
        for (int p = 0; p < cl_npts[c]; ++p)
            if (a[p] == atom) return true;
        return false;
    }
};

}  // namespace

extern "C" {

Engine* sqs_create() { return new Engine(); }
void sqs_destroy(Engine* e) { delete e; }

void sqs_setup(
    Engine* e, int n_atoms, int n_species,
    const double* phi,                 // [ (n_species-1) * n_species ]
    int nc, const int* ch_npts, const int* ch_funcs, const int* ch_ninst,
    const double* ch_target, const double* ch_diam, const double* ch_weight,
    int ncl, const int* cl_atoms, const int* cl_npts,
    const int* cl_ch0, const int* cl_nch,
    int mode, double tol, double w_dist, double rho) {
    e->n_atoms = n_atoms;
    e->n_species = n_species;
    e->n_func = n_species - 1;
    e->phi.assign(phi, phi + (size_t)e->n_func * n_species);
    e->nc = nc;
    e->ch_npts.assign(ch_npts, ch_npts + nc);
    e->ch_funcs.assign(ch_funcs, ch_funcs + (size_t)nc * 4);
    e->ch_ninst.assign(ch_ninst, ch_ninst + nc);
    e->ch_target.assign(ch_target, ch_target + nc);
    e->ch_diam.assign(ch_diam, ch_diam + nc);
    e->ch_weight.assign(ch_weight, ch_weight + nc);
    e->ncl = ncl;
    e->cl_atoms.assign(cl_atoms, cl_atoms + (size_t)ncl * 4);
    e->cl_npts.assign(cl_npts, cl_npts + ncl);
    e->cl_ch0.assign(cl_ch0, cl_ch0 + ncl);
    e->cl_nch.assign(cl_nch, cl_nch + ncl);
    e->mode = mode;
    e->tol = tol;
    e->w_dist = w_dist;
    e->rho = rho;
    e->max_npts = 2;
    double dmin = std::numeric_limits<double>::infinity();
    for (int i = 0; i < nc; ++i) {
        if (ch_npts[i] > e->max_npts) e->max_npts = ch_npts[i];
        if (ch_diam[i] < dmin) dmin = ch_diam[i];
    }
    e->d_min = (std::isfinite(dmin) && dmin > 0.0) ? dmin : 1.0;
    // build CSR adjacency
    e->adj_off.assign(n_atoms + 1, 0);
    for (int c = 0; c < ncl; ++c) {
        const int* a = &e->cl_atoms[(size_t)c * 4];
        int seen[4];
        int ns = 0;
        for (int p = 0; p < e->cl_npts[c]; ++p) {
            bool dup = false;
            for (int q = 0; q < ns; ++q)
                if (seen[q] == a[p]) { dup = true; break; }
            if (!dup) { seen[ns++] = a[p]; e->adj_off[a[p] + 1]++; }
        }
    }
    for (int i = 0; i < n_atoms; ++i) e->adj_off[i + 1] += e->adj_off[i];
    e->adj.resize(e->adj_off[n_atoms]);
    std::vector<int> cur(e->adj_off.begin(), e->adj_off.end() - 1);
    for (int c = 0; c < ncl; ++c) {
        const int* a = &e->cl_atoms[(size_t)c * 4];
        int seen[4];
        int ns = 0;
        for (int p = 0; p < e->cl_npts[c]; ++p) {
            bool dup = false;
            for (int q = 0; q < ns; ++q)
                if (seen[q] == a[p]) { dup = true; break; }
            if (!dup) { seen[ns++] = a[p]; e->adj[cur[a[p]]++] = c; }
        }
    }
}

// correlations pi per channel for the given types
void sqs_correlations(Engine* e, const int* types, double* out) {
    std::vector<double> sums(e->nc);
    e->full_sums(types, sums.data());
    for (int i = 0; i < e->nc; ++i) out[i] = sums[i] / (double)e->ch_ninst[i];
}

double sqs_objective(Engine* e, const int* types) {
    std::vector<double> sums(e->nc);
    e->full_sums(types, sums.data());
    return e->objective(sums.data());
}

void sqs_per_channel_delta(Engine* e, const int* types, double* out) {
    std::vector<double> sums(e->nc);
    e->full_sums(types, sums.data());
    for (int i = 0; i < e->nc; ++i)
        out[i] = std::fabs(sums[i] / (double)e->ch_ninst[i] - e->ch_target[i]);
}

// Run n_replicas chains; writes best types into best_types (n_atoms ints),
// best correlations into best_corr (nc doubles); returns best objective.
double sqs_run_mc(
    Engine* e, const int* init_types, long long max_steps, double T,
    int n_replicas, unsigned long long seed, int num_threads,
    int* best_types_out, double* best_corr_out) {
    const int N = e->n_atoms;
    const int NC = e->nc;

    struct Best {
        std::vector<int> types;
        std::vector<double> sums;
        double obj;
    };
    std::vector<Best> best(n_replicas);

#ifdef _OPENMP
#pragma omp parallel for num_threads(num_threads) schedule(dynamic, 1)
#endif
    for (int r = 0; r < n_replicas; ++r) {
        std::mt19937_64 rng(seed * 1000003ULL + (unsigned long long)r * 97ULL);
        std::vector<int> types(init_types, init_types + N);
        std::shuffle(types.begin(), types.end(), rng);
        std::vector<double> sums(NC);
        e->full_sums(types.data(), sums.data());
        double obj = e->objective(sums.data());

        Best b{types, sums, obj};

        std::uniform_real_distribution<double> u01(0.0, 1.0);
        std::uniform_int_distribution<int> pick(0, N - 1);
        double sig_old[64], sig_new[64];

        for (long long step = 0; step < max_steps; ++step) {
            int i = pick(rng), j = pick(rng);
            if (i == j || types[i] == types[j]) continue;

            // patch channel sums for clusters touching i or j
            // (clusters containing both are visited only via i's list)
            const int oi = types[i], oj = types[j];
            for (int pass = 0; pass < 2; ++pass) {
                int atom = pass == 0 ? i : j;
                for (int k = e->adj_off[atom]; k < e->adj_off[atom + 1]; ++k) {
                    int c = e->adj[k];
                    if (pass == 1 && e->cluster_has_atom(c, i)) continue;
                    e->cluster_sigmas(c, types.data(), sig_old);
                    // swapped view
                    types[i] = oj; types[j] = oi;
                    e->cluster_sigmas(c, types.data(), sig_new);
                    types[i] = oi; types[j] = oj;
                    const int c0 = e->cl_ch0[c];
                    for (int f = 0; f < e->cl_nch[c]; ++f)
                        sums[c0 + f] += sig_new[f] - sig_old[f];
                }
            }
            double new_obj = e->objective(sums.data());
            double delta = new_obj - obj;
            bool accept = delta <= 0.0 || u01(rng) < std::exp(-delta / T);
            if (accept) {
                std::swap(types[i], types[j]);
                obj = new_obj;
                if (obj < b.obj) { b.obj = obj; b.types = types; b.sums = sums; }
            } else {
                // undo the channel patches
                for (int pass = 0; pass < 2; ++pass) {
                    int atom = pass == 0 ? i : j;
                    for (int k = e->adj_off[atom]; k < e->adj_off[atom + 1]; ++k) {
                        int c = e->adj[k];
                        if (pass == 1 && e->cluster_has_atom(c, i)) continue;
                        e->cluster_sigmas(c, types.data(), sig_old);
                        types[i] = oj; types[j] = oi;
                        e->cluster_sigmas(c, types.data(), sig_new);
                        types[i] = oi; types[j] = oj;
                        const int c0 = e->cl_ch0[c];
                        for (int f = 0; f < e->cl_nch[c]; ++f)
                            sums[c0 + f] -= sig_new[f] - sig_old[f];
                    }
                }
            }
        }
        best[r] = std::move(b);
    }

    int bi = 0;
    for (int r = 1; r < n_replicas; ++r)
        if (best[r].obj < best[bi].obj) bi = r;
    std::memcpy(best_types_out, best[bi].types.data(), sizeof(int) * N);
    for (int i = 0; i < NC; ++i)
        best_corr_out[i] = best[bi].sums[i] / (double)e->ch_ninst[i];
    return best[bi].obj;
}

}  // extern "C"
