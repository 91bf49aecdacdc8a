// Native host-side Xiangqi rules core.
//
// C++ counterpart of the reference's Cython extension
// (reference: training/cython_engine/game_core.pyx) for the host paths that
// step one game at a time — the demo/serving API, the parity oracle's fast
// mode, and host-side tooling. The TPU batch path does NOT use this (it is
// the pure-JAX vectorized env); this exists so single-game hosts aren't
// bottlenecked by Python movegen, exactly the role the Cython core played.
//
// Semantics contract: bit-exact with the Python oracle
// (xiangqi_alphazero_tpu/engine/oracle.py), which is itself differentially
// verified against the upstream reference engine. Exposed via a plain C ABI
// for ctypes.
//
// Board: int8_t[90], square = row*9+col, row 0 = red base. Pieces:
// 1 king, 2 advisor, 3 elephant, 4 horse, 5 rook, 6 cannon, 7 pawn;
// red positive, black negative. Action encoding: from*90 + to.

#include <cstdint>
#include <algorithm>

namespace {

constexpr int ROWS = 10, COLS = 9, NSQ = 90;

inline int rc(int r, int c) { return r * COLS + c; }
inline bool in_board(int r, int c) {
  return r >= 0 && r < ROWS && c >= 0 && c < COLS;
}
inline bool in_palace(int r, int c, int side) {
  if (c < 3 || c > 5) return false;
  return side > 0 ? r <= 2 : r >= 7;
}
inline bool advisor_spot(int r, int c, int side) {
  if (side > 0)
    return (r == 0 && (c == 3 || c == 5)) || (r == 1 && c == 4) ||
           (r == 2 && (c == 3 || c == 5));
  return (r == 7 && (c == 3 || c == 5)) || (r == 8 && c == 4) ||
         (r == 9 && (c == 3 || c == 5));
}

constexpr int ORTH[4][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}};
constexpr int DIAG[4][2] = {{1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
constexpr int HORSE_D[8][2] = {{2, 1},  {2, -1},  {-2, 1},  {-2, -1},
                               {1, 2},  {1, -2},  {-1, 2},  {-1, -2}};
constexpr int ELE_D[4][2] = {{2, 2}, {2, -2}, {-2, 2}, {-2, -2}};

int find_king(const int8_t* b, int side) {
  const int8_t target = static_cast<int8_t>(side);  // king code = 1*side
  const int r0 = side > 0 ? 0 : 7, r1 = side > 0 ? 3 : 10;
  for (int r = r0; r < r1; ++r)
    for (int c = 3; c <= 5; ++c)
      if (b[rc(r, c)] == target) return rc(r, c);
  return -1;
}

// Reverse attack detection from the target square; replicates the oracle
// (oracle.py attacked()) including the enemy-king-as-ray-attacker quirk.
bool attacked(const int8_t* b, int sq, int by) {
  const int kr = sq / COLS, kc = sq % COLS;
  const int8_t e_rook = static_cast<int8_t>(5 * by);
  const int8_t e_cannon = static_cast<int8_t>(6 * by);
  const int8_t e_horse = static_cast<int8_t>(4 * by);
  const int8_t e_pawn = static_cast<int8_t>(7 * by);
  const int8_t e_king = static_cast<int8_t>(by);

  for (const auto& d : ORTH) {
    int r = kr + d[0], c = kc + d[1];
    int screen = 0;
    while (in_board(r, c)) {
      const int8_t p = b[rc(r, c)];
      if (p != 0) {
        if (screen == 0) {
          if (p == e_rook || p == e_king) return true;
          screen = 1;
        } else {
          if (p == e_cannon) return true;
          break;
        }
      }
      r += d[0];
      c += d[1];
    }
  }

  for (const auto& d : HORSE_D) {
    const int r = kr + d[0], c = kc + d[1];
    if (!in_board(r, c) || b[rc(r, c)] != e_horse) continue;
    int leg_r, leg_c;  // leg adjacent to the horse, toward the target
    if (d[0] == 2 || d[0] == -2) {
      leg_r = r - d[0] / 2;
      leg_c = c;
    } else {
      leg_r = r;
      leg_c = c - d[1] / 2;
    }
    if (b[rc(leg_r, leg_c)] == 0) return true;
  }

  const int fwd = by > 0 ? 1 : -1;
  {
    const int r = kr - fwd;
    if (in_board(r, kc) && b[rc(r, kc)] == e_pawn) return true;
  }
  const bool crossed = by > 0 ? kr >= 5 : kr <= 4;
  if (crossed) {
    if (kc - 1 >= 0 && b[rc(kr, kc - 1)] == e_pawn) return true;
    if (kc + 1 < COLS && b[rc(kr, kc + 1)] == e_pawn) return true;
  }
  return false;
}

bool kings_facing(const int8_t* b) {
  const int rk = find_king(b, 1), bk = find_king(b, -1);
  if (rk < 0 || bk < 0) return false;
  if (rk % COLS != bk % COLS) return false;
  const int c = rk % COLS;
  int lo = rk / COLS, hi = bk / COLS;
  if (lo > hi) std::swap(lo, hi);
  for (int r = lo + 1; r < hi; ++r)
    if (b[rc(r, c)] != 0) return false;
  return true;
}

// Own king survives, no flying general, not in check after f->t.
bool move_safe(int8_t* b, int f, int t, int side) {
  const int8_t moving = b[f], captured = b[t];
  b[t] = moving;
  b[f] = 0;
  bool ok = false;
  const int k = find_king(b, side);
  if (k >= 0 && !kings_facing(b)) ok = !attacked(b, k, -side);
  b[f] = moving;
  b[t] = captured;
  return ok;
}

inline bool takeable(const int8_t* b, int t, int side) {
  const int8_t q = b[t];
  return q == 0 || (q > 0) != (side > 0);
}

// Append pseudo-legal destinations for the piece on square s.
int piece_dests(const int8_t* b, int s, int* out) {
  const int8_t p = b[s];
  const int side = p > 0 ? 1 : -1;
  const int kind = p > 0 ? p : -p;
  const int r = s / COLS, c = s % COLS;
  int n = 0;

  switch (kind) {
    case 1:  // king
      for (const auto& d : ORTH) {
        const int nr = r + d[0], nc = c + d[1];
        if (in_palace(nr, nc, side) && takeable(b, rc(nr, nc), side))
          out[n++] = rc(nr, nc);
      }
      break;
    case 2:  // advisor
      for (const auto& d : DIAG) {
        const int nr = r + d[0], nc = c + d[1];
        if (in_board(nr, nc) && advisor_spot(nr, nc, side) &&
            takeable(b, rc(nr, nc), side))
          out[n++] = rc(nr, nc);
      }
      break;
    case 3:  // elephant
      for (const auto& d : ELE_D) {
        const int nr = r + d[0], nc = c + d[1];
        if (!in_board(nr, nc)) continue;
        if (side > 0 ? nr > 4 : nr < 5) continue;
        if (b[rc(r + d[0] / 2, c + d[1] / 2)] != 0) continue;
        if (takeable(b, rc(nr, nc), side)) out[n++] = rc(nr, nc);
      }
      break;
    case 4:  // horse
      for (const auto& d : HORSE_D) {
        const int nr = r + d[0], nc = c + d[1];
        if (!in_board(nr, nc)) continue;
        const int leg = (d[0] == 2 || d[0] == -2) ? rc(r + d[0] / 2, c)
                                                  : rc(r, c + d[1] / 2);
        if (b[leg] != 0) continue;
        if (takeable(b, rc(nr, nc), side)) out[n++] = rc(nr, nc);
      }
      break;
    case 5:  // rook
      for (const auto& d : ORTH) {
        int nr = r + d[0], nc = c + d[1];
        while (in_board(nr, nc)) {
          const int t = rc(nr, nc);
          if (b[t] == 0) {
            out[n++] = t;
          } else {
            if ((b[t] > 0) != (side > 0)) out[n++] = t;
            break;
          }
          nr += d[0];
          nc += d[1];
        }
      }
      break;
    case 6:  // cannon
      for (const auto& d : ORTH) {
        int nr = r + d[0], nc = c + d[1];
        while (in_board(nr, nc) && b[rc(nr, nc)] == 0) {
          out[n++] = rc(nr, nc);
          nr += d[0];
          nc += d[1];
        }
        nr += d[0];
        nc += d[1];
        while (in_board(nr, nc)) {
          const int t = rc(nr, nc);
          if (b[t] != 0) {
            if ((b[t] > 0) != (side > 0)) out[n++] = t;
            break;
          }
          nr += d[0];
          nc += d[1];
        }
      }
      break;
    case 7: {  // pawn
      const int fwd = side > 0 ? 1 : -1;
      const int nr = r + fwd;
      if (in_board(nr, c) && takeable(b, rc(nr, c), side)) out[n++] = rc(nr, c);
      const bool crossed = side > 0 ? r >= 5 : r <= 4;
      if (crossed) {
        if (c - 1 >= 0 && takeable(b, rc(r, c - 1), side))
          out[n++] = rc(r, c - 1);
        if (c + 1 < COLS && takeable(b, rc(r, c + 1), side))
          out[n++] = rc(r, c + 1);
      }
      break;
    }
    default:
      break;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Alpha-beta minimax opponent (the external Elo anchor).
//
// Same semantics as the browser engine's negamax (serve/static/engine.js,
// which replicates the reference web AI, reference:
// web/client/src/lib/xiangqi-engine.ts:292-357): material-only evaluation
// with the king at 10000 so king capture dominates, depth = AI level,
// alpha-beta pruning, and a 30%-probability tie-break among equal-valued
// root moves. The only intentional difference: the RNG is a seeded xorshift
// so anchor matches are reproducible.

constexpr int MVAL[8] = {0, 10000, 20, 20, 40, 90, 45, 10};

int eval_board(const int8_t* b, int side) {
  int score = 0;
  for (int s = 0; s < NSQ; ++s) {
    const int8_t p = b[s];
    if (p > 0) score += MVAL[p];
    else if (p < 0) score -= MVAL[-p];
  }
  return side > 0 ? score : -score;
}

int gen_legal_local(int8_t* b, int side, int32_t* out, int cap) {
  int dests[32];
  int n = 0;
  for (int s = 0; s < NSQ; ++s) {
    const int8_t p = b[s];
    if (p == 0 || (p > 0) != (side > 0)) continue;
    const int m = piece_dests(b, s, dests);
    for (int j = 0; j < m; ++j)
      if (move_safe(b, s, dests[j], side) && n < cap)
        out[n++] = s * NSQ + dests[j];
  }
  std::sort(out, out + n);
  return n;
}

int negamax(int8_t* b, int side, int depth, int alpha, int beta) {
  if (find_king(b, side) < 0) return -100000;
  if (find_king(b, -side) < 0) return 100000;
  if (depth == 0) return eval_board(b, side);
  int32_t moves[128];
  const int n = gen_legal_local(b, side, moves, 128);
  if (n == 0) return -100000;
  int best = -1000000;
  for (int i = 0; i < n; ++i) {
    const int f = moves[i] / NSQ, t = moves[i] % NSQ;
    const int8_t moving = b[f], captured = b[t];
    b[t] = moving;
    b[f] = 0;
    const int v = -negamax(b, -side, depth - 1, -beta, -alpha);
    b[f] = moving;
    b[t] = captured;
    if (v > best) best = v;
    if (best > alpha) alpha = best;
    if (alpha >= beta) break;
  }
  return best;
}

inline uint64_t xorshift64(uint64_t& s) {
  s ^= s << 13;
  s ^= s >> 7;
  s ^= s << 17;
  return s;
}

}  // namespace

extern "C" {

int xq_find_king(const int8_t* board, int side) {
  return find_king(board, side);
}

int xq_is_attacked(const int8_t* board, int sq, int by) {
  return attacked(board, sq, by) ? 1 : 0;
}

int xq_is_in_check(const int8_t* board, int side) {
  const int k = find_king(board, side);
  if (k < 0) return 1;
  return attacked(board, k, -side) ? 1 : 0;
}

// Writes legal actions (from*90+to), ascending, into out[cap]; returns the
// count (clamped to cap). 128 slots always suffice (max legal < 120).
int xq_gen_legal(const int8_t* board, int side, int32_t* out, int cap) {
  int8_t b[NSQ];
  for (int i = 0; i < NSQ; ++i) b[i] = board[i];
  int dests[32];
  int n = 0;
  for (int s = 0; s < NSQ; ++s) {
    const int8_t p = b[s];
    if (p == 0 || (p > 0) != (side > 0)) continue;
    const int m = piece_dests(b, s, dests);
    for (int j = 0; j < m; ++j) {
      if (move_safe(b, s, dests[j], side) && n < cap)
        out[n++] = s * NSQ + dests[j];
    }
  }
  std::sort(out, out + n);
  return n;
}

int xq_has_legal(const int8_t* board, int side) {
  int8_t b[NSQ];
  for (int i = 0; i < NSQ; ++i) b[i] = board[i];
  int dests[32];
  for (int s = 0; s < NSQ; ++s) {
    const int8_t p = b[s];
    if (p == 0 || (p > 0) != (side > 0)) continue;
    const int m = piece_dests(b, s, dests);
    for (int j = 0; j < m; ++j)
      if (move_safe(b, s, dests[j], side)) return 1;
  }
  return 0;
}

// Best move for `side` by alpha-beta minimax at `depth` (depth 0 = greedy
// material). Returns from*90+to, or -1 with no legal move. `seed` drives
// the 30% equal-value tie-break (engine.js minimaxMove parity).
int32_t xq_minimax_move(const int8_t* board, int side, int depth,
                        uint64_t seed) {
  int8_t b[NSQ];
  for (int i = 0; i < NSQ; ++i) b[i] = board[i];
  int32_t moves[128];
  const int n = gen_legal_local(b, side, moves, 128);
  if (n == 0) return -1;
  uint64_t rng = seed ? seed : 0x9e3779b97f4a7c15ull;
  int32_t best = -1;
  int best_v = -1000000;
  for (int i = 0; i < n; ++i) {
    const int f = moves[i] / NSQ, t = moves[i] % NSQ;
    const int8_t moving = b[f], captured = b[t];
    b[t] = moving;
    b[f] = 0;
    const int v = depth <= 0
                      ? eval_board(b, side)
                      : -negamax(b, -side, depth, -1000000, 1000000);
    b[f] = moving;
    b[t] = captured;
    const bool tie_take =
        v == best_v && (xorshift64(rng) >> 40) % 10 < 3;  // ~30%
    if (v > best_v || tie_take) {
      best_v = v;
      best = moves[i];
    }
  }
  return best;
}

}  // extern "C"
