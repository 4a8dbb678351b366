// Sequential reference-semantics race oracle (native).
//
// A C++ reimplementation of the behavioral contract in SURVEY.md §2 for
// /root/reference/src/simulation.py — the same semantics as the Python
// oracle in tests/oracle/reference_sim.py, ~1000x faster. Used to validate
// the engine's finish-order distributions at high sample counts, where
// the pure-Python oracle is too slow for tight statistical tolerances.
//
// Deliberately serial and simple: this is the ground truth, not the fast
// path. RNG is splitmix64->xoshiro256++ with Box-Muller normals; all
// distributions match the reference's (uniform/normal/categorical draws),
// draw ORDER differs (as it does between reference and oracle already).
//
// Build: g++ -O3 -shared -fPIC -o liboracle.so oracle.cpp
// ABI: run_oracle(...) fills counts_out[driver*D + (position-1)].

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Rng {
    uint64_t s[4];
    explicit Rng(uint64_t seed) {
        // splitmix64 seeding
        uint64_t x = seed;
        for (int i = 0; i < 4; i++) {
            x += 0x9e3779b97f4a7c15ULL;
            uint64_t z = x;
            z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
            z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
            s[i] = z ^ (z >> 31);
        }
    }
    static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
    uint64_t next() {
        uint64_t result = rotl(s[0] + s[3], 23) + s[0];
        uint64_t t = s[1] << 17;
        s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
        s[2] ^= t; s[3] = rotl(s[3], 45);
        return result;
    }
    double uniform() {  // [0, 1)
        return (next() >> 11) * 0x1.0p-53;
    }
    double normal() {
        double u1 = uniform();
        if (u1 < 1e-300) u1 = 1e-300;
        double u2 = uniform();
        return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
    }
    // categorical over n weights (need not be normalized)
    int categorical(const double* w, int n) {
        double total = 0.0;
        for (int i = 0; i < n; i++) total += w[i];
        double r = uniform() * total;
        double acc = 0.0;
        for (int i = 0; i < n; i++) {
            acc += w[i];
            if (r < acc) return i;
        }
        return n - 1;
    }
};

enum Compound { SOFT = 0, MEDIUM = 1, HARD = 2, INTER = 3, WETC = 4 };
enum Condition { DRY = 0, DAMP = 1, FULL_WET = 2 };

struct Car {
    int idx;
    int grid_slot;
    int compound;
    double tire_age;
    double fuel = 110.0;
    double cum = 0.0;
    double last_lap = 0.0;
    double behind_leader = 0.0;
    bool drs = false;
    bool dnf = false;
    int dnf_lap = 0;
    int laps_done = 0;
    bool used[3] = {false, false, false};  // dry compounds
    void mark_used(int c) { if (c <= HARD) used[c] = true; }
};

struct Params {
    int d, laps, condition;
    const float *grid_probs, *base_pace, *tire_deg, *variance, *dnf_rate, *team_dnf;
    double pit_loss, overtake_delta, sc_p, vsc_p, red_p, drs_delta,
        dirty_thresh, dirty_pen;
    const float *comp_pace, *comp_deg;
    const int32_t *comp_optimal;
    // Test-only rule mutations (mutation-sensitivity proofs for the
    // statistical tolerances; see tests/test_engine_stats.py). 0 = none.
    int32_t mutation = 0;
};

enum Mutation { MUT_NONE = 0, MUT_NO_FRONT_ROW_START_CLAMP = 1,
                MUT_NO_TWO_COMPOUND_RULE = 2 };

int condition_compound(int cond, int remaining) {
    if (cond == FULL_WET) return WETC;
    if (cond == DAMP) return INTER;
    if (remaining > 30) return HARD;
    if (remaining > 15) return MEDIUM;
    return SOFT;
}

void sample_grid(Rng& rng, const Params& p, std::vector<int>& order) {
    const int d = p.d;
    std::vector<bool> remaining(d, true);
    std::vector<double> w(d);
    order.clear();
    for (int pos = 0; pos < d; pos++) {
        double total = 0.0;
        for (int i = 0; i < d; i++) {
            w[i] = remaining[i] ? std::max(0.0f, p.grid_probs[i * d + pos]) : 0.0;
            total += w[i];
        }
        if (total <= 0.0) {
            for (int i = 0; i < d; i++) w[i] = remaining[i] ? 1.0 : 0.0;
        }
        int pick = rng.categorical(w.data(), d);
        order.push_back(pick);
        remaining[pick] = false;
    }
}

double clean_time(Rng& rng, const Params& p, const Car& c) {
    double deg = p.tire_deg[c.idx];
    double factor = deg > 0 ? deg / 0.05 : 1.0;
    double t = p.base_pace[c.idx]
        + c.tire_age * p.comp_deg[c.compound] * factor
        - (110.0 - c.fuel) * 0.03
        + p.comp_pace[c.compound]
        - (c.drs ? p.drs_delta : 0.0)
        + rng.normal() * p.variance[c.idx];
    return t;
}

void update_positions(std::vector<Car>& cars, int lap, bool drs_disabled) {
    std::vector<Car*> active;
    for (auto& c : cars) if (!c.dnf) active.push_back(&c);
    std::stable_sort(active.begin(), active.end(),
                     [](Car* a, Car* b) { return a->cum < b->cum; });
    for (size_t i = 0; i < active.size(); i++) {
        Car* c = active[i];
        c->behind_leader = c->cum - active[0]->cum;
        if (lap <= 2 || drs_disabled || i == 0) c->drs = false;
        else c->drs = (c->cum - active[i - 1]->cum) < 1.0;
    }
}

void simulate_one(Rng& rng, const Params& p, const std::vector<int>& order,
                  int32_t* result_pos /* per driver, 1-indexed */) {
    const int d = p.d;
    std::vector<Car> cars(d);
    for (int slot = 0; slot < d; slot++) {
        Car& c = cars[slot];
        c.idx = order[slot];
        c.grid_slot = slot;
        if (p.condition == FULL_WET) c.compound = WETC;
        else if (p.condition == DAMP) c.compound = INTER;
        else c.compound = slot < 10 ? SOFT : MEDIUM;
        c.tire_age = (p.condition == DRY && slot < 10) ? 4.0 : 0.0;
        c.mark_used(c.compound);
    }

    // lap 1
    for (auto& c : cars) {
        if (rng.uniform() < p.team_dnf[c.idx] * 4.0) {
            c.dnf = true; c.dnf_lap = 1; continue;
        }
        double base = clean_time(rng, p, c);
        double pos = c.grid_slot + 1;
        double delta = rng.normal() * std::min(1.5, 0.5 + pos * 0.1);
        if (pos <= 3 && p.mutation != MUT_NO_FRONT_ROW_START_CLAMP)
            delta = std::min(delta, 1.0);
        c.cum += base - delta * 0.5;
        c.tire_age += 1;
        c.fuel = std::max(0.0, c.fuel - 1.5);
    }
    update_positions(cars, 1, true);

    int drs_until = 0;
    std::vector<Car*> sorted_ptr;
    std::vector<double> ahead_lap(d);
    for (int lap = 2; lap <= p.laps; lap++) {
        // race control
        if (rng.uniform() < p.red_p) {
            sorted_ptr.clear();
            for (auto& c : cars) if (!c.dnf) sorted_ptr.push_back(&c);
            std::stable_sort(sorted_ptr.begin(), sorted_ptr.end(),
                             [](Car* a, Car* b) { return a->cum < b->cum; });
            if (!sorted_ptr.empty()) {
                double leader = sorted_ptr[0]->cum;
                int remaining = p.laps - lap;
                int comp = condition_compound(p.condition, remaining);
                for (size_t i = 0; i < sorted_ptr.size(); i++) {
                    Car* c = sorted_ptr[i];
                    c->cum = leader + i * 0.1;
                    c->behind_leader = c->cum - leader;
                    c->tire_age = 0;
                    c->compound = comp;
                    c->mark_used(comp);
                }
            }
            drs_until = lap + 2;
        } else if (rng.uniform() < p.sc_p) {
            sorted_ptr.clear();
            for (auto& c : cars) if (!c.dnf) sorted_ptr.push_back(&c);
            std::stable_sort(sorted_ptr.begin(), sorted_ptr.end(),
                             [](Car* a, Car* b) { return a->cum < b->cum; });
            if (!sorted_ptr.empty()) {
                double leader = sorted_ptr[0]->cum;
                int llaps = sorted_ptr[0]->laps_done;
                for (size_t i = 0; i < sorted_ptr.size(); i++) {
                    Car* c = sorted_ptr[i];
                    int down = llaps - c->laps_done;
                    c->cum = leader + i * 0.5 + (down > 0 ? down * 90.0 : 0.0);
                    c->behind_leader = c->cum - leader;
                    c->tire_age = std::max(0.0, c->tire_age - 1);
                }
            }
            drs_until = lap + 2;
        } else if (rng.uniform() < p.vsc_p) {
            sorted_ptr.clear();
            for (auto& c : cars) if (!c.dnf) sorted_ptr.push_back(&c);
            std::stable_sort(sorted_ptr.begin(), sorted_ptr.end(),
                             [](Car* a, Car* b) { return a->cum < b->cum; });
            if (!sorted_ptr.empty()) {
                double leader = sorted_ptr[0]->cum;
                for (auto* c : sorted_ptr) {
                    c->cum = leader + (c->cum - leader) * 0.8;
                    c->behind_leader = c->cum - leader;
                }
                if (rng.uniform() < 0.3)
                    for (auto* c : sorted_ptr)
                        c->tire_age = std::max(0.0, c->tire_age - 1);
            }
            drs_until = lap + 1;
        }

        // dirty-air table: last lap time of the car one active rank ahead
        sorted_ptr.clear();
        for (auto& c : cars) if (!c.dnf) sorted_ptr.push_back(&c);
        std::stable_sort(sorted_ptr.begin(), sorted_ptr.end(),
                         [](Car* a, Car* b) { return a->cum < b->cum; });
        std::fill(ahead_lap.begin(), ahead_lap.end(), 0.0);
        for (size_t i = 1; i < sorted_ptr.size(); i++)
            ahead_lap[sorted_ptr[i]->idx] = sorted_ptr[i - 1]->last_lap;

        // per-car lap
        for (auto& c : cars) {
            if (c.dnf) continue;
            if (rng.uniform() < p.dnf_rate[c.idx]) {
                c.dnf = true; c.dnf_lap = lap; continue;
            }
            double t = clean_time(rng, p, c);
            if (c.behind_leader > 0) {
                double a = ahead_lap[c.idx];
                if (a > 0 && c.behind_leader < p.dirty_thresh)
                    t = std::max(t + p.dirty_pen, a);
            }
            c.cum += t;
            c.last_lap = t;
            c.tire_age += 1;
            c.fuel = std::max(0.0, c.fuel - 1.5);
            c.laps_done += 1;
        }

        // pit stops
        int remaining = p.laps - lap;
        for (auto& c : cars) {
            if (c.dnf) continue;
            double optimal = p.comp_optimal[c.compound];
            // Compare at float32 precision: parameters arrive as f32, and a
            // deg of exactly 0.05 rounds to 0.0500000007f, which must NOT
            // count as "> 0.05" (the engine and the double-precision
            // reference both treat it as equal).
            float deg = p.tire_deg[c.idx];
            if (deg > 0.05f) optimal = (int)(optimal * 0.85);
            else if (deg < 0.02f) optimal = (int)(optimal * 1.1);
            if (c.tire_age > optimal && remaining > 5) {
                c.cum += p.pit_loss;
                int nc = condition_compound(p.condition, remaining);
                int n_used = c.used[0] + c.used[1] + c.used[2];
                if (n_used == 1 && nc <= HARD && c.used[nc] && p.condition == DRY
                    && p.mutation != MUT_NO_TWO_COMPOUND_RULE) {
                    if (remaining > 20) nc = !c.used[MEDIUM] ? MEDIUM : HARD;
                    else nc = !c.used[SOFT] ? SOFT : MEDIUM;
                }
                c.compound = nc;
                c.mark_used(nc);
                c.tire_age = 0;
            }
        }

        // overtakes: 3 passes, early break
        for (int pass = 0; pass < 3; pass++) {
            bool occurred = false;
            std::vector<Car*> all;
            for (auto& c : cars) all.push_back(&c);
            std::stable_sort(all.begin(), all.end(),
                             [](Car* a, Car* b) { return a->cum < b->cum; });
            for (int i = 1; i < d; i++) {
                Car* behind = all[i];
                Car* ahead = all[i - 1];
                if (behind->dnf || ahead->dnf) continue;
                double pb = p.base_pace[behind->idx] + behind->tire_age * p.tire_deg[behind->idx];
                double pa = p.base_pace[ahead->idx] + ahead->tire_age * p.tire_deg[ahead->idx];
                double delta = pa - pb + (behind->drs ? p.drs_delta : 0.0);
                if (delta > p.overtake_delta) {
                    if (rng.uniform() < std::min(0.5, delta / 2.0)) {
                        double nb = std::max(0.1, ahead->cum - 0.1);
                        behind->cum = nb;
                        ahead->cum = nb + 0.3;
                        occurred = true;
                    }
                }
            }
            if (!occurred) break;
        }

        update_positions(cars, lap, lap <= drs_until);
    }

    // classification
    std::vector<Car*> active, dnfs;
    for (auto& c : cars) (c.dnf ? dnfs : active).push_back(&c);
    std::stable_sort(active.begin(), active.end(),
                     [](Car* a, Car* b) { return a->cum < b->cum; });
    std::stable_sort(dnfs.begin(), dnfs.end(), [](Car* a, Car* b) {
        if (a->dnf_lap != b->dnf_lap) return a->dnf_lap > b->dnf_lap;
        return a->cum > b->cum;
    });
    int pos = 1;
    for (auto* c : active) result_pos[c->idx] = pos++;
    for (auto* c : dnfs) result_pos[c->idx] = pos++;
}

}  // namespace

extern "C" void run_oracle_mut(
    uint64_t seed, int32_t n_sims, int32_t n_drivers, int32_t total_laps,
    const float* grid_probs, const float* base_pace, const float* tire_deg,
    const float* variance, const float* dnf_rate, const float* team_dnf_rate,
    float pit_loss, float overtake_delta, float sc_p, float vsc_p, float red_p,
    float drs_delta, float dirty_thresh, float dirty_pen, int32_t track_condition,
    const float* comp_pace, const float* comp_deg, const int32_t* comp_optimal,
    int32_t mutation, int64_t* counts_out) {
    Params p;
    p.d = n_drivers; p.laps = total_laps; p.condition = track_condition;
    p.grid_probs = grid_probs; p.base_pace = base_pace; p.tire_deg = tire_deg;
    p.variance = variance; p.dnf_rate = dnf_rate; p.team_dnf = team_dnf_rate;
    p.pit_loss = pit_loss; p.overtake_delta = overtake_delta;
    p.sc_p = sc_p; p.vsc_p = vsc_p; p.red_p = red_p; p.drs_delta = drs_delta;
    p.dirty_thresh = dirty_thresh; p.dirty_pen = dirty_pen;
    p.comp_pace = comp_pace; p.comp_deg = comp_deg; p.comp_optimal = comp_optimal;
    p.mutation = mutation;

    std::memset(counts_out, 0, sizeof(int64_t) * n_drivers * n_drivers);
    Rng rng(seed);
    std::vector<int> order;
    std::vector<int32_t> result(n_drivers);
    for (int s = 0; s < n_sims; s++) {
        sample_grid(rng, p, order);
        simulate_one(rng, p, order, result.data());
        for (int drv = 0; drv < n_drivers; drv++)
            counts_out[drv * n_drivers + (result[drv] - 1)] += 1;
    }
}

extern "C" void run_oracle(
    uint64_t seed, int32_t n_sims, int32_t n_drivers, int32_t total_laps,
    const float* grid_probs, const float* base_pace, const float* tire_deg,
    const float* variance, const float* dnf_rate, const float* team_dnf_rate,
    float pit_loss, float overtake_delta, float sc_p, float vsc_p, float red_p,
    float drs_delta, float dirty_thresh, float dirty_pen, int32_t track_condition,
    const float* comp_pace, const float* comp_deg, const int32_t* comp_optimal,
    int64_t* counts_out) {
    run_oracle_mut(seed, n_sims, n_drivers, total_laps, grid_probs, base_pace,
                   tire_deg, variance, dnf_rate, team_dnf_rate, pit_loss,
                   overtake_delta, sc_p, vsc_p, red_p, drs_delta, dirty_thresh,
                   dirty_pen, track_condition, comp_pace, comp_deg,
                   comp_optimal, 0, counts_out);
}
