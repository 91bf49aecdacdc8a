/* Browser-side Xiangqi rules engine + minimax AI.
 *
 * Independent third implementation of the rules (after the Python oracle
 * and the vectorized JAX env), playing the role of the reference's
 * TypeScript engine (reference: web/client/src/lib/xiangqi-engine.ts):
 * full legal movegen, check detection, and an alpha-beta minimax opponent
 * with material evaluation whose search depth is the AI level (0-3).
 *
 * Board: Int8Array(90), square = row*9+col, row 0 = red base.
 * Pieces: 1 king, 2 advisor, 3 elephant, 4 horse, 5 rook, 6 cannon,
 * 7 pawn; red positive. Move = {from, to} squares.
 *
 * Like the reference web engine (and unlike the training engine), the
 * minimax evaluation uses a large king value so king capture dominates
 * (xiangqi-engine.ts:292-295).
 */
"use strict";

const ROWS = 10, COLS = 9, NSQ = 90;
const ORTH = [[1, 0], [-1, 0], [0, 1], [0, -1]];
const DIAG = [[1, 1], [1, -1], [-1, 1], [-1, -1]];
const HORSE = [[2, 1], [2, -1], [-2, 1], [-2, -1], [1, 2], [1, -2], [-1, 2], [-1, -2]];
const ELE = [[2, 2], [2, -2], [-2, 2], [-2, -2]];
// minimax material values by |piece| (king huge, as in the reference web AI)
const MVAL = [0, 10000, 20, 20, 40, 90, 45, 10];

function inBoard(r, c) { return r >= 0 && r < ROWS && c >= 0 && c < COLS; }
function inPalace(r, c, side) {
  return c >= 3 && c <= 5 && (side > 0 ? r <= 2 : r >= 7);
}
function advisorSpot(r, c, side) {
  if (side > 0)
    return (r === 0 && (c === 3 || c === 5)) || (r === 1 && c === 4) ||
           (r === 2 && (c === 3 || c === 5));
  return (r === 7 && (c === 3 || c === 5)) || (r === 8 && c === 4) ||
         (r === 9 && (c === 3 || c === 5));
}

export function initialBoard() {
  const b = new Int8Array(NSQ);
  const back = [5, 4, 3, 2, 1, 2, 3, 4, 5];
  for (let c = 0; c < 9; c++) { b[c] = back[c]; b[81 + c] = -back[c]; }
  b[9 * 2 + 1] = 6; b[9 * 2 + 7] = 6; b[9 * 7 + 1] = -6; b[9 * 7 + 7] = -6;
  for (const c of [0, 2, 4, 6, 8]) { b[27 + c] = 7; b[54 + c] = -7; }
  return b;
}

export function findKing(b, side) {
  const target = side;
  const r0 = side > 0 ? 0 : 7, r1 = side > 0 ? 3 : 10;
  for (let r = r0; r < r1; r++)
    for (let c = 3; c <= 5; c++)
      if (b[r * 9 + c] === target) return r * 9 + c;
  return -1;
}

export function attacked(b, sq, by) {
  const kr = (sq / 9) | 0, kc = sq % 9;
  for (const [dr, dc] of ORTH) {
    let r = kr + dr, c = kc + dc, screen = 0;
    while (inBoard(r, c)) {
      const p = b[r * 9 + c];
      if (p !== 0) {
        if (screen === 0) {
          if (p === 5 * by || p === by) return true;
          screen = 1;
        } else {
          if (p === 6 * by) return true;
          break;
        }
      }
      r += dr; c += dc;
    }
  }
  for (const [dr, dc] of HORSE) {
    const r = kr + dr, c = kc + dc;
    if (!inBoard(r, c) || b[r * 9 + c] !== 4 * by) continue;
    const legR = Math.abs(dr) === 2 ? r - dr / 2 : r;
    const legC = Math.abs(dr) === 2 ? c : c - dc / 2;
    if (b[legR * 9 + legC] === 0) return true;
  }
  const fwd = by > 0 ? 1 : -1;
  if (inBoard(kr - fwd, kc) && b[(kr - fwd) * 9 + kc] === 7 * by) return true;
  const crossed = by > 0 ? kr >= 5 : kr <= 4;
  if (crossed) {
    if (kc - 1 >= 0 && b[kr * 9 + kc - 1] === 7 * by) return true;
    if (kc + 1 < 9 && b[kr * 9 + kc + 1] === 7 * by) return true;
  }
  return false;
}

function pieceDests(b, s) {
  const p = b[s], side = p > 0 ? 1 : -1, kind = Math.abs(p);
  const r = (s / 9) | 0, c = s % 9;
  const out = [];
  const take = (t) => b[t] === 0 || (b[t] > 0) !== (p > 0);
  if (kind === 1) {
    for (const [dr, dc] of ORTH) {
      const nr = r + dr, nc = c + dc;
      if (inPalace(nr, nc, side) && take(nr * 9 + nc)) out.push(nr * 9 + nc);
    }
  } else if (kind === 2) {
    for (const [dr, dc] of DIAG) {
      const nr = r + dr, nc = c + dc;
      if (inBoard(nr, nc) && advisorSpot(nr, nc, side) && take(nr * 9 + nc))
        out.push(nr * 9 + nc);
    }
  } else if (kind === 3) {
    for (const [dr, dc] of ELE) {
      const nr = r + dr, nc = c + dc;
      if (!inBoard(nr, nc)) continue;
      if (side > 0 ? nr > 4 : nr < 5) continue;
      if (b[(r + dr / 2) * 9 + c + dc / 2] !== 0) continue;
      if (take(nr * 9 + nc)) out.push(nr * 9 + nc);
    }
  } else if (kind === 4) {
    for (const [dr, dc] of HORSE) {
      const nr = r + dr, nc = c + dc;
      if (!inBoard(nr, nc)) continue;
      const leg = Math.abs(dr) === 2 ? (r + dr / 2) * 9 + c : r * 9 + c + dc / 2;
      if (b[leg] !== 0) continue;
      if (take(nr * 9 + nc)) out.push(nr * 9 + nc);
    }
  } else if (kind === 5) {
    for (const [dr, dc] of ORTH) {
      let nr = r + dr, nc = c + dc;
      while (inBoard(nr, nc)) {
        const t = nr * 9 + nc;
        if (b[t] === 0) out.push(t);
        else { if ((b[t] > 0) !== (p > 0)) out.push(t); break; }
        nr += dr; nc += dc;
      }
    }
  } else if (kind === 6) {
    for (const [dr, dc] of ORTH) {
      let nr = r + dr, nc = c + dc;
      while (inBoard(nr, nc) && b[nr * 9 + nc] === 0) {
        out.push(nr * 9 + nc); nr += dr; nc += dc;
      }
      nr += dr; nc += dc;
      while (inBoard(nr, nc)) {
        const t = nr * 9 + nc;
        if (b[t] !== 0) { if ((b[t] > 0) !== (p > 0)) out.push(t); break; }
        nr += dr; nc += dc;
      }
    }
  } else if (kind === 7) {
    const fwd = side > 0 ? 1 : -1;
    if (inBoard(r + fwd, c) && take((r + fwd) * 9 + c)) out.push((r + fwd) * 9 + c);
    if (side > 0 ? r >= 5 : r <= 4) {
      if (c - 1 >= 0 && take(r * 9 + c - 1)) out.push(r * 9 + c - 1);
      if (c + 1 < 9 && take(r * 9 + c + 1)) out.push(r * 9 + c + 1);
    }
  }
  return out;
}

function kingsFacing(b) {
  const rk = findKing(b, 1), bk = findKing(b, -1);
  if (rk < 0 || bk < 0 || rk % 9 !== bk % 9) return false;
  const c = rk % 9;
  const lo = Math.min((rk / 9) | 0, (bk / 9) | 0), hi = Math.max((rk / 9) | 0, (bk / 9) | 0);
  for (let r = lo + 1; r < hi; r++) if (b[r * 9 + c] !== 0) return false;
  return true;
}

function moveSafe(b, f, t, side) {
  const moving = b[f], captured = b[t];
  b[t] = moving; b[f] = 0;
  let ok = false;
  const k = findKing(b, side);
  if (k >= 0 && !kingsFacing(b)) ok = !attacked(b, k, -side);
  b[f] = moving; b[t] = captured;
  return ok;
}

export function legalMoves(b, side) {
  const out = [];
  for (let s = 0; s < NSQ; s++) {
    const p = b[s];
    if (p === 0 || (p > 0) !== (side > 0)) continue;
    for (const t of pieceDests(b, s))
      if (moveSafe(b, s, t, side)) out.push({ from: s, to: t });
  }
  return out;
}

export function inCheck(b, side) {
  const k = findKing(b, side);
  return k < 0 || attacked(b, k, -side);
}

function evalBoard(b, side) {
  let score = 0;
  for (let s = 0; s < NSQ; s++) {
    const p = b[s];
    if (p !== 0) score += (p > 0 ? MVAL[p] : -MVAL[-p]);
  }
  return side > 0 ? score : -score;
}

function negamax(b, side, depth, alpha, beta) {
  if (findKing(b, side) < 0) return -100000;
  if (findKing(b, -side) < 0) return 100000;
  if (depth === 0) return evalBoard(b, side);
  const moves = legalMoves(b, side);
  if (moves.length === 0) return -100000;
  let best = -Infinity;
  for (const m of moves) {
    const captured = b[m.to];
    b[m.to] = b[m.from]; b[m.from] = 0;
    const v = -negamax(b, -side, depth - 1, -beta, -alpha);
    b[m.from] = b[m.to]; b[m.to] = captured;
    if (v > best) best = v;
    if (best > alpha) alpha = best;
    if (alpha >= beta) break;
  }
  return best;
}

/** Pick a move for `side` at the given level (minimax depth; level 0 =
 * greedy material). Returns {from, to} or null. */
export function minimaxMove(b, side, level) {
  const moves = legalMoves(b, side);
  if (moves.length === 0) return null;
  let best = null, bestV = -Infinity;
  for (const m of moves) {
    const captured = b[m.to];
    b[m.to] = b[m.from]; b[m.from] = 0;
    const v = level <= 0
      ? evalBoard(b, side)
      : -negamax(b, -side, level, -Infinity, Infinity);
    b[m.from] = b[m.to]; b[m.to] = captured;
    if (v > bestV || (v === bestV && Math.random() < 0.3)) { bestV = v; best = m; }
  }
  return best;
}
