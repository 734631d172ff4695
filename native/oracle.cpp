// Sequential double-precision physics oracle for FutbolEnv parity tests.
//
// This is the JAX engine's stand-in for the role Chipmunk2D's C core
// plays in the reference (SURVEY.md §2.2): a native, sequential,
// single-env implementation of the NORMATIVE PHYSICS SPEC in
// gym_futbol_tpu/physics.py (module docstring). It is written from that
// spec — not from Chipmunk or pymunk sources — and must match the JAX
// engine bit-closely in float64 (parity harness: parity/check_physics_parity.py,
// SURVEY.md §4.2 item 1). Any change to the spec must land in both.
//
// Build: g++ -O2 -shared -fPIC -o liboracle.so oracle.cpp   (native/build.py)
// ABI: plain C, driven via ctypes.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Params {
  double width, height, goal_size;
  double player_radius, ball_radius;
  double player_mass, ball_mass;
  double player_elasticity, ball_elasticity, wall_elasticity;
  double friction;
  double dt;
  double substeps;          // integral value
  double damping;
  double solver_iterations; // integral value
  double collision_slop;
  double baumgarte;
  double max_speed;
};

struct V2 {
  double x, y;
};

inline V2 operator+(V2 a, V2 b) { return {a.x + b.x, a.y + b.y}; }
inline V2 operator-(V2 a, V2 b) { return {a.x - b.x, a.y - b.y}; }
inline V2 operator*(V2 a, double s) { return {a.x * s, a.y * s}; }
inline double dot(V2 a, V2 b) { return a.x * b.x + a.y * b.y; }

// One sub-step of the spec. pos/vel length n (bodies); body 0 = ball.
void substep(std::vector<V2>& pos, std::vector<V2>& vel,
             const std::vector<V2>& forces, const Params& p) {
  const int n = static_cast<int>(pos.size());
  const double dt_sub = p.dt / p.substeps;
  const int iters = static_cast<int>(p.solver_iterations);

  std::vector<double> inv_m(n), radii(n), elas(n);
  inv_m[0] = 1.0 / p.ball_mass;
  radii[0] = p.ball_radius;
  elas[0] = p.ball_elasticity;
  for (int i = 1; i < n; ++i) {
    inv_m[i] = 1.0 / p.player_mass;
    radii[i] = p.player_radius;
    elas[i] = p.player_elasticity;
  }

  // ---- spec item 1: velocity integration -------------------------------
  // Hot-form algebra (physics.py spec item 3 "Hot-form"): the JAX engine
  // computes the speed clamp as max_speed * rsqrt(max(|v|^2, 1e-12));
  // on CPU rsqrt == 1.0/sqrt bit-exactly, mirrored here literally.
  const double damp = std::pow(p.damping, dt_sub);
  for (int i = 0; i < n; ++i) {
    V2 v = vel[i] * damp + forces[i] * (inv_m[i] * dt_sub);
    double s2 = v.x * v.x + v.y * v.y;
    double scale =
        std::fmin(1.0, p.max_speed * (1.0 / std::sqrt(std::fmax(s2, 1e-12))));
    vel[i] = v * scale;
  }

  // ---- spec item 2: contact generation ----------------------------------
  const double goal_y_lo = (p.height - p.goal_size) / 2.0;
  const double goal_y_hi = (p.height + p.goal_size) / 2.0;
  const double bias_coef = p.baumgarte / dt_sub;
  const double BIG = 1e20;  // inactive-contact sentinel (spec item 3)

  struct CC {
    int i, j;
    V2 nrm;
    double nxi, nyi, nxj, nyj;  // inv-mass-premultiplied normal components
    double nkn;                 // -k_n
    double bmv;                 // bounce - v_bias, or +BIG when inactive
  };
  std::vector<CC> cc;
  cc.reserve(n * (n - 1) / 2);
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      V2 dp = pos[j] - pos[i];
      double d2 = dp.x * dp.x + dp.y * dp.y;
      double inv_d = 1.0 / std::sqrt(std::fmax(d2, 1e-12));
      double dist = d2 * inv_d;
      double pen = (radii[i] + radii[j]) - dist;
      CC c;
      c.i = i;
      c.j = j;
      c.nrm = dp * inv_d;
      c.nxi = c.nrm.x * inv_m[i];
      c.nyi = c.nrm.y * inv_m[i];
      c.nxj = c.nrm.x * inv_m[j];
      c.nyj = c.nrm.y * inv_m[j];
      c.nkn = -(1.0 / (inv_m[i] + inv_m[j]));
      double e = elas[i] * elas[j];
      double vrn0 = dot(vel[j] - vel[i], c.nrm);
      double bounce = e * std::fmin(vrn0, 0.0);
      double vbias = bias_coef * std::fmax(pen - p.collision_slop, 0.0);
      c.bmv = pen > 0.0 ? bounce - vbias : BIG;
      cc.push_back(c);
    }
  }

  // walls: order [bottom, top, left, right]; normals point into the field.
  // Stored NEGATED (v_bias - bounce; -BIG when inactive) for the
  // velocity-units wall solve (k_n = m_i cancels inv_m — spec item 3).
  const V2 wall_n[4] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0}};
  std::vector<double> w_nbmv(4 * n);
  for (int i = 0; i < n; ++i) {
    bool ball_in_mouth =
        (i == 0) && pos[i].y >= goal_y_lo && pos[i].y <= goal_y_hi;
    double d[4];
    d[0] = radii[i] - pos[i].y;
    d[1] = radii[i] - (p.height - pos[i].y);
    d[2] = ball_in_mouth ? -1.0 : radii[i] - pos[i].x;
    d[3] = ball_in_mouth ? -1.0 : radii[i] - (p.width - pos[i].x);
    double e = elas[i] * p.wall_elasticity;
    for (int w = 0; w < 4; ++w) {
      double vrn0 = dot(vel[i], wall_n[w]);
      double wbounce = e * std::fmin(vrn0, 0.0);
      double wvbias = bias_coef * std::fmax(d[w] - p.collision_slop, 0.0);
      w_nbmv[w * n + i] = d[w] > 0.0 ? wvbias - wbounce : -BIG;
    }
  }

  // ---- spec item 3: impulse solve (hot-form algebra) --------------------
  std::vector<double> jn_cc(cc.size(), 0.0), jt_cc(cc.size(), 0.0);
  std::vector<double> jv_w(4 * n, 0.0), jtv_w(4 * n, 0.0);  // velocity units

  for (int it = 0; it < iters; ++it) {
    // circle–circle, sequential in fixed lexicographic order
    for (size_t k = 0; k < cc.size(); ++k) {
      const CC& c = cc[k];
      double vrn = dot(vel[c.j] - vel[c.i], c.nrm);
      double jn_new = std::fmax(jn_cc[k] + c.nkn * (vrn + c.bmv), 0.0);
      double dj = jn_new - jn_cc[k];
      jn_cc[k] = jn_new;
      vel[c.i].x -= dj * c.nxi;
      vel[c.i].y -= dj * c.nyi;
      vel[c.j].x += dj * c.nxj;
      vel[c.j].y += dj * c.nyj;
      // friction (tangent t = (-ny, nx))
      double vrt = (vel[c.j].y - vel[c.i].y) * c.nrm.x -
                   (vel[c.j].x - vel[c.i].x) * c.nrm.y;
      double djt = c.nkn * vrt;
      double lim = p.friction * jn_new;
      double jt_new = std::fmin(std::fmax(jt_cc[k] + djt, -lim), lim);
      djt = jt_new - jt_cc[k];
      jt_cc[k] = jt_new;
      vel[c.i].x += djt * c.nyi;
      vel[c.i].y -= djt * c.nxi;
      vel[c.j].x -= djt * c.nyj;
      vel[c.j].y += djt * c.nxj;
    }

    // walls: velocity-units solve, per-wall, per-body (independent
    // bodies => same math as the JAX vectorized pass)
    for (int w = 0; w < 4; ++w) {
      for (int i = 0; i < n; ++i) {
        const size_t k = w * n + i;
        // dv0 = -(vrn + bmv) = wnbmv - vrn, sign-folded per wall
        double dv0;
        if (w == 0) dv0 = w_nbmv[k] - vel[i].y;
        else if (w == 1) dv0 = w_nbmv[k] + vel[i].y;
        else if (w == 2) dv0 = w_nbmv[k] - vel[i].x;
        else dv0 = w_nbmv[k] + vel[i].x;
        double jv_new = std::fmax(jv_w[k] + dv0, 0.0);
        double dv = jv_new - jv_w[k];
        jv_w[k] = jv_new;
        if (w == 0) vel[i].y += dv;
        else if (w == 1) vel[i].y -= dv;
        else if (w == 2) vel[i].x += dv;
        else vel[i].x -= dv;
        // friction: dvt0 = -vrt, sign-folded per wall tangent
        double dvt0;
        if (w == 0) dvt0 = vel[i].x;        // vrt = -vx
        else if (w == 1) dvt0 = -vel[i].x;  // vrt = vx
        else if (w == 2) dvt0 = -vel[i].y;  // vrt = vy
        else dvt0 = vel[i].y;               // vrt = -vy
        double limv = p.friction * jv_new;
        double jt_new = std::fmin(std::fmax(jtv_w[k] + dvt0, -limv), limv);
        double dvt = jt_new - jtv_w[k];
        jtv_w[k] = jt_new;
        // vel += t * dvt with t = (-1,0),(1,0),(0,1),(0,-1)
        if (w == 0) vel[i].x -= dvt;
        else if (w == 1) vel[i].x += dvt;
        else if (w == 2) vel[i].y += dvt;
        else vel[i].y -= dvt;
      }
    }
  }

  // ---- spec item 4: position integration --------------------------------
  for (int i = 0; i < n; ++i) {
    pos[i] = pos[i] + vel[i] * dt_sub;
  }
}

}  // namespace

namespace {

// Game-logic constants (second params array; order must match
// native/build.py game_params_array).
struct GameParams {
  double move_force, dash_multiplier;
  double possession_radius, dribble_offset;
  double pass_power, shoot_power;
  double placement_noise;
  double max_steps;  // integral value
  // RewardConfig
  double r_goal, r_concede, r_ball_to_goal, r_player_to_ball;
  double r_possession, r_oob, r_time;
};

inline void dir_unit(int d, double& ux, double& uy) {
  ux = (d == 2) ? 1.0 : (d == 4) ? -1.0 : 0.0;
  uy = (d == 1) ? 1.0 : (d == 3) ? -1.0 : 0.0;
}

constexpr int ACT_DASH = 1, ACT_PRESS = 2, ACT_PASS = 3, ACT_SHOOT = 4;

double ball_goal_dist(const std::vector<V2>& pos, const Params& p, int team) {
  double gx = (team == 0) ? p.width : 0.0;
  double gy = p.height / 2.0;
  double dx = pos[0].x - gx, dy = pos[0].y - gy;
  return std::sqrt(dx * dx + dy * dy);
}

double nearest_player_ball_dist(const std::vector<V2>& pos, int ppt, int team) {
  int lo = 1 + team * ppt;
  double best = 0.0;
  for (int b = lo; b < lo + ppt; ++b) {
    double dx = pos[b].x - pos[0].x, dy = pos[b].y - pos[0].y;
    double d = std::sqrt(dx * dx + dy * dy);
    best = (b == lo) ? d : std::fmin(best, d);
  }
  return best;
}

}  // namespace

extern "C" {

// Full env.step in sequential double precision — the native oracle for the
// WHOLE normative step pipeline in gym_futbol_tpu/env.py (STEP ORDER), not
// just the physics. RNG is injected: ``theta`` is the kick-noise angle
// already scaled by kick_noise; ``kickoff_noise`` is [n_bodies*2] uniforms
// in [-1, 1] (the draw game.kickoff_positions makes). The parity harness
// (parity/check_env_parity.py) replicates the jnp path's key-split to
// produce identical draws for both implementations.
//
// In/out: pos, vel [n*2]; possession, t [1] int32; score [2] int32.
// Out: reward [2] (per-team shaped reward), done [1] int32.
void futbol_env_step(double* pos_io, double* vel_io, int32_t* possession_io,
                     int32_t* score_io, int32_t* t_io, const int32_t* actions,
                     double theta, const double* kickoff_noise, double* reward,
                     int32_t* done_out, int auto_reset, int n_bodies,
                     const double* phys_params, const double* game_params) {
  const Params& p = *reinterpret_cast<const Params*>(phys_params);
  const GameParams& g = *reinterpret_cast<const GameParams*>(game_params);
  const int n = n_bodies;
  const int n_players = n - 1;
  const int ppt = n_players / 2;

  std::vector<V2> pos(n), vel(n);
  for (int i = 0; i < n; ++i) {
    pos[i] = {pos_io[2 * i], pos_io[2 * i + 1]};
    vel[i] = {vel_io[2 * i], vel_io[2 * i + 1]};
  }
  std::vector<V2> pos_before = pos;
  int possession = *possession_io;

  // ---- 2: action decode -> forces (ball row zero) ----------------------
  std::vector<V2> forces(n, V2{0.0, 0.0});
  for (int pl = 0; pl < n_players; ++pl) {
    double ux, uy;
    dir_unit(actions[2 * pl], ux, uy);
    double mag = (actions[2 * pl + 1] == ACT_DASH)
                     ? g.move_force * g.dash_multiplier
                     : g.move_force;
    forces[1 + pl] = {ux * mag, uy * mag};
  }

  // ---- 3: possession bids (pre-step positions) --------------------------
  {
    std::vector<double> d(n_players);
    std::vector<bool> within(n_players), bids(n_players);
    for (int pl = 0; pl < n_players; ++pl) {
      double dx = pos[1 + pl].x - pos[0].x, dy = pos[1 + pl].y - pos[0].y;
      d[pl] = std::sqrt(dx * dx + dy * dy);
      within[pl] = d[pl] <= g.possession_radius;
      bids[pl] = (actions[2 * pl + 1] == ACT_PRESS) && within[pl];
    }
    // nearest bidder wins, ties -> lowest index (strict <)
    int best = 0;
    double best_d = bids[0] ? d[0] : 1e300;
    bool any_bid = bids[0];
    for (int pl = 1; pl < n_players; ++pl) {
      double bd = bids[pl] ? d[pl] : 1e300;
      if (bd < best_d) {
        best = pl;
        best_d = bd;
      }
      any_bid = any_bid || bids[pl];
    }
    int owner_player = possession - 1;
    bool owner_within = (possession > 0 && owner_player < n_players)
                            ? within[owner_player]
                            : false;
    int keep = owner_within ? possession : -1;
    possession = any_bid ? (best + 1) : keep;
  }

  // ---- 4: owner pass/shoot -> ball impulse ------------------------------
  {
    bool has_owner = possession > 0;
    int owner_p = possession - 1;
    if (owner_p < 0) owner_p = 0;
    if (owner_p > n_players - 1) owner_p = n_players - 1;
    int owner_act = actions[2 * owner_p + 1];
    bool do_pass = has_owner && owner_act == ACT_PASS;
    bool do_shoot = has_owner && owner_act == ACT_SHOOT;
    // owner position (falls back to ball row when unowned, like the jnp)
    V2 o = pos[0];
    for (int b = 1; b <= n_players; ++b)
      if (possession == b) o = pos[b];
    int owner_team = owner_p >= ppt ? 1 : 0;
    V2 ball = pos[0];
    // shoot target: opponent goal mouth center
    double gx = owner_team == 0 ? p.width : 0.0;
    double sdx = gx - ball.x, sdy = p.height / 2.0 - ball.y;
    double snorm = std::fmax(std::sqrt(sdx * sdx + sdy * sdy), 1e-9);
    sdx /= snorm;
    sdy /= snorm;
    // pass target: nearest teammate of the owner (distance from OWNER,
    // direction from BALL — mirrors game.apply_kick_scalars exactly)
    double mate_d = 1e300;
    double mx = pos[1].x, my = pos[1].y;
    bool has_mate = false;
    for (int pl = 0; pl < n_players; ++pl) {
      int team_p = pl >= ppt ? 1 : 0;
      double dx = pos[1 + pl].x - o.x, dy = pos[1 + pl].y - o.y;
      double dp = std::sqrt(dx * dx + dy * dy);
      bool is_mate = (owner_team == team_p) && (owner_p != pl);
      if (!is_mate) dp = 1e300;
      if (dp < mate_d) {
        mx = pos[1 + pl].x;
        my = pos[1 + pl].y;
        mate_d = dp;
      }
      has_mate = has_mate || is_mate;
    }
    double pdx = mx - ball.x, pdy = my - ball.y;
    double pnorm = std::fmax(std::sqrt(pdx * pdx + pdy * pdy), 1e-9);
    pdx /= pnorm;
    pdy /= pnorm;
    if (!has_mate) {
      pdx = sdx;
      pdy = sdy;
    }
    double c = std::cos(theta), s = std::sin(theta);
    double kdx = do_shoot ? c * sdx - s * sdy : c * pdx - s * pdy;
    double kdy = do_shoot ? s * sdx + c * sdy : s * pdx + c * pdy;
    double power = do_shoot ? g.shoot_power : g.pass_power;
    bool kicked = do_pass || do_shoot;
    if (kicked) {
      vel[0].x += kdx * power / p.ball_mass;
      vel[0].y += kdy * power / p.ball_mass;
      possession = -1;
    }
  }

  // ---- 5: physics --------------------------------------------------------
  const int substeps = static_cast<int>(p.substeps);
  for (int s = 0; s < substeps; ++s) substep(pos, vel, forces, p);

  // ---- 6: dribble carry --------------------------------------------------
  {
    bool has_owner = possession > 0;
    if (has_owner) {
      int owner_p = possession - 1;
      int dir = actions[2 * owner_p];
      double ux, uy;
      dir_unit(dir, ux, uy);
      int owner_team = owner_p >= ppt ? 1 : 0;
      double fbx = owner_team == 0 ? 1.0 : -1.0;
      bool moving = ux != 0.0 || uy != 0.0;
      double cdx = moving ? ux : fbx;
      double cdy = moving ? uy : 0.0;
      V2 o = pos[possession], ov = vel[possession];
      double offset = p.player_radius + p.ball_radius + g.dribble_offset;
      pos[0] = {o.x + cdx * offset, o.y + cdy * offset};
      vel[0] = ov;
    }
  }

  // ---- 7: goal detection -------------------------------------------------
  const double glo = (p.height - p.goal_size) / 2.0;
  const double ghi = (p.height + p.goal_size) / 2.0;
  bool in_mouth7 = pos[0].y >= glo && pos[0].y <= ghi;
  bool goal0 = pos[0].x > p.width && in_mouth7;
  bool goal1 = pos[0].x < 0.0 && in_mouth7;

  // ---- 8: OOB clamp ------------------------------------------------------
  bool ball_clamped = false;
  {
    bool in_mouth = pos[0].y >= glo && pos[0].y <= ghi;  // pre-clamp ball y
    for (int i = 0; i < n; ++i) {
      double r = i == 0 ? p.ball_radius : p.player_radius;
      double cx = std::fmin(std::fmax(pos[i].x, r), p.width - r);
      double cy = std::fmin(std::fmax(pos[i].y, r), p.height - r);
      if (i == 0 && in_mouth) cx = pos[0].x;  // free x inside the mouth
      bool moved_x = std::fabs(cx - pos[i].x) > 0.0;
      bool moved_y = std::fabs(cy - pos[i].y) > 0.0;
      if (moved_x) vel[i].x = 0.0;
      if (moved_y) vel[i].y = 0.0;
      pos[i] = {cx, cy};
      if (i == 0) ball_clamped = moved_x || moved_y;
    }
  }

  // ---- 9: shaped rewards (pre-step vs post-clamp positions) --------------
  for (int team = 0; team < 2; ++team) {
    double r = g.r_time;
    if (team == 0 ? goal0 : goal1) r += g.r_goal;
    if (team == 0 ? goal1 : goal0) r += g.r_concede;
    r += g.r_ball_to_goal *
         (ball_goal_dist(pos_before, p, team) - ball_goal_dist(pos, p, team));
    r += g.r_player_to_ball * (nearest_player_ball_dist(pos_before, ppt, team) -
                               nearest_player_ball_dist(pos, ppt, team));
    int owner_p = possession - 1;
    bool owns = possession > 0 && owner_p >= team * ppt &&
                owner_p < (team + 1) * ppt;
    if (owns) r += g.r_possession;
    if (ball_clamped) r += g.r_oob;
    reward[team] = r;
  }

  // ---- 10: kickoff re-placement where a goal occurred --------------------
  std::vector<V2> kick_pos(n);
  {
    double amp = g.placement_noise * p.height;
    kick_pos[0] = {p.width / 2.0 + kickoff_noise[0] * amp,
                   p.height / 2.0 + kickoff_noise[1] * amp};
    int b = 1;
    for (int team = 0; team < 2; ++team) {
      double base_x = team == 0 ? p.width / 4.0 : 3.0 * p.width / 4.0;
      for (int k = 0; k < ppt; ++k, ++b) {
        double y0 = (k + 1.0) * (p.height / (ppt + 1.0));
        kick_pos[b] = {base_x + kickoff_noise[2 * b] * amp,
                       y0 + kickoff_noise[2 * b + 1] * amp};
      }
    }
  }
  bool any_goal = goal0 || goal1;
  if (any_goal) {
    pos = kick_pos;
    for (int i = 0; i < n; ++i) vel[i] = {0.0, 0.0};
    possession = -1;
  }
  score_io[0] += goal0 ? 1 : 0;
  score_io[1] += goal1 ? 1 : 0;

  // ---- 11: clock + optional fused auto-reset -----------------------------
  int t = *t_io + 1;
  bool done = t >= static_cast<int>(g.max_steps);
  *done_out = done ? 1 : 0;
  if (auto_reset && done) {
    pos = kick_pos;
    for (int i = 0; i < n; ++i) vel[i] = {0.0, 0.0};
    possession = -1;
    score_io[0] = 0;
    score_io[1] = 0;
    t = 0;
  }
  *t_io = t;
  *possession_io = possession;
  for (int i = 0; i < n; ++i) {
    pos_io[2 * i] = pos[i].x;
    pos_io[2 * i + 1] = pos[i].y;
    vel_io[2 * i] = vel[i].x;
    vel_io[2 * i + 1] = vel[i].y;
  }
}

// pos, vel, forces: [n_bodies * 2] row-major doubles. params: Params layout.
void futbol_physics_step(double* pos, double* vel, const double* forces,
                         int n_bodies, const double* params) {
  const Params& p = *reinterpret_cast<const Params*>(params);
  std::vector<V2> P(n_bodies), V(n_bodies), F(n_bodies);
  for (int i = 0; i < n_bodies; ++i) {
    P[i] = {pos[2 * i], pos[2 * i + 1]};
    V[i] = {vel[2 * i], vel[2 * i + 1]};
    F[i] = {forces[2 * i], forces[2 * i + 1]};
  }
  const int substeps = static_cast<int>(p.substeps);
  for (int s = 0; s < substeps; ++s) {
    substep(P, V, F, p);
  }
  for (int i = 0; i < n_bodies; ++i) {
    pos[2 * i] = P[i].x;
    pos[2 * i + 1] = P[i].y;
    vel[2 * i] = V[i].x;
    vel[2 * i + 1] = V[i].y;
  }
}

int futbol_oracle_abi_version() { return 3; }

}  // extern "C"
