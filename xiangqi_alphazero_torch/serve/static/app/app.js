/* Rich Xiangqi client — store + panels.
 *
 * Capability parity with the reference's React app (reference:
 * web/client/src/hooks/useXiangqi.ts, pages/Home.tsx): choose side and AI
 * level (4 browser minimax levels via the independent rules engine in
 * ../engine.js) or play the SERVER's AlphaZero model over the REST API,
 * undo, move history (Chinese notation), captured pieces, check / result
 * banners, board flip. Hand-rolled store + render, no framework.
 */

import * as XQ from "../engine.js";
import { createBoard } from "./board.js";

const LEVELS = [
  { v: 0, name: "入门 · 贪吃" },
  { v: 1, name: "初级 · 一步" },
  { v: 2, name: "中级 · 两步" },
  { v: 3, name: "高级 · 三步" },
];
const RED_CH = { 1: "帥", 2: "仕", 3: "相", 4: "馬", 5: "車", 6: "炮", 7: "兵" };
const BLK_CH = { 1: "將", 2: "士", 3: "象", 4: "馬", 5: "車", 6: "砲", 7: "卒" };
const DIGITS_R = ["一", "二", "三", "四", "五", "六", "七", "八", "九"];

const S = {
  mode: "browser",        // "browser" | "server"
  sessionId: null,        // server games run in their own session, so many
  //                         browsers can play the model concurrently (the
  //                         server coalesces their searches into one
  //                         device batch — /api/session/*)
  level: 2,
  humanSide: 1,
  board: XQ.initialBoard(),
  current: 1,
  selected: null,
  targets: [],
  lastMove: null,
  history: [],            // {notation, side}
  undoStack: [],          // {board, current, lastMove, histLen}
  over: false,
  winner: null,
  thinking: false,
  started: false,
  models: [],
  model: null,
  sims: 200,
  analysis: null,         // {value, topMoves:[{label, prob, rawProb}]}
  error: null,
};

// ----------------------------------------------------------------- utils
const sq = (r, c) => r * 9 + c;

function notation(board, from, to) {
  // Standard Chinese notation: piece, from-file (each side counts from its
  // own right), 进/退/平 + destination. 前/后 disambiguates stacked pairs.
  const p = board[from], side = p > 0 ? 1 : -1, a = Math.abs(p);
  const ch = side > 0 ? RED_CH[a] : BLK_CH[a];
  const fr = Math.floor(from / 9), fc = from % 9;
  const tr = Math.floor(to / 9), tc = to % 9;
  const file = (c) => (side > 0 ? DIGITS_R[8 - c] : String(c + 1));
  let head;
  const twin = [];
  for (let r = 0; r < 10; r++) if (board[sq(r, fc)] === p) twin.push(r);
  if (twin.length > 1 && a !== 2 && a !== 3) {
    // front-first order from the mover's perspective; 前/中/后 covers
    // pairs and triples, deeper stacks (4-5 pawns) use 二/三/... ranks
    twin.sort((x, y) => (side > 0 ? y - x : x - y));
    const i = twin.indexOf(fr);
    const tag =
      i === 0 ? "前"
      : i === twin.length - 1 ? "后"
      : twin.length === 3 ? "中"
      : DIGITS_R[i];
    head = tag + ch;
  } else {
    head = ch + file(fc);
  }
  const fwd = side > 0 ? tr - fr : fr - tr;
  if (tr === fr) return head + "平" + file(tc);
  const dir = fwd > 0 ? "进" : "退";
  // knights/elephants/advisors name the destination file, others the count
  if (a === 2 || a === 3 || a === 4) return head + dir + file(tc);
  return head + dir + (side > 0 ? DIGITS_R[Math.abs(fwd) - 1] : String(Math.abs(fwd)));
}

function terminal(board, sideToMove) {
  if (XQ.findKing(board, 1) < 0) return { over: true, winner: -1 };
  if (XQ.findKing(board, -1) < 0) return { over: true, winner: 1 };
  if (XQ.legalMoves(board, sideToMove).length === 0)
    return { over: true, winner: -sideToMove };
  return { over: false, winner: null };
}

function capturedPieces(board) {
  const full = { 1: 1, 2: 2, 3: 2, 4: 2, 5: 2, 6: 2, 7: 5 };
  const left = { r: {}, b: {} };
  for (const v of board) {
    if (v > 0) left.r[v] = (left.r[v] || 0) + 1;
    else if (v < 0) left.b[-v] = (left.b[-v] || 0) + 1;
  }
  const out = { r: [], b: [] };
  for (let a = 1; a <= 7; a++) {
    for (let i = (left.r[a] || 0); i < full[a]; i++) out.r.push(a);
    for (let i = (left.b[a] || 0); i < full[a]; i++) out.b.push(a);
  }
  return out; // pieces LOST by each color
}

// ------------------------------------------------------------- API calls
async function api(path, body) {
  const opts = body === undefined ? {} : {
    method: "POST", body: JSON.stringify(body),
  };
  const resp = await fetch(path, opts);
  const data = await resp.json();
  if (!resp.ok) throw new Error(data.error || resp.statusText);
  return data;
}

// ----------------------------------------------------------------- moves
function applyLocal(from, to) {
  S.undoStack.push({
    board: Int8Array.from(S.board), current: S.current,
    lastMove: S.lastMove, histLen: S.history.length,
  });
  S.history.push({ notation: notation(S.board, from, to), side: S.current });
  S.board[to] = S.board[from];
  S.board[from] = 0;
  S.lastMove = { from, to };
  S.current = -S.current;
  const t = terminal(S.board, S.current);
  S.over = t.over;
  S.winner = t.winner;
}

function browserAIMove() {
  S.thinking = true;
  render();
  setTimeout(() => {
    const mv = XQ.minimaxMove(S.board, S.current, S.level);
    S.thinking = false;
    if (mv) applyLocal(mv.from, mv.to);
    render();
  }, 60);
}

async function serverHumanMove(from, to) {
  S.thinking = true;
  render();
  try {
    const d = await api("/api/session/move", {
      session_id: S.sessionId,
      from_row: Math.floor(from / 9), from_col: from % 9,
      to_row: Math.floor(to / 9), to_col: to % 9,
    });
    S.history.push({ notation: notation(S.board, from, to), side: S.current });
    S.board = Int8Array.from(d.board.flat());
    S.current = d.current_player;
    S.over = d.game_over;
    S.winner = d.winner ?? null;
    S.lastMove = { from, to };  // AI reply below overrides when present
    if (d.ai_move) {
      const m = d.ai_move;  // {from: [r,c], to: [r,c], label}
      S.lastMove = { from: sq(m.from[0], m.from[1]), to: sq(m.to[0], m.to[1]) };
      S.history.push({ notation: m.label || "", side: -S.humanSide });
    }
    S.analysis = d.ai_analysis ? {
      value: d.ai_analysis.value_score,
      topMoves: (d.ai_analysis.top_moves || []).slice(0, 8),
    } : S.analysis;
    S.error = null;
  } catch (e) {
    S.error = e.message;
  }
  S.thinking = false;
  render();
}

function onCell(r, c) {
  if (S.over || S.thinking || !S.started) return;
  if (S.current !== S.humanSide) return;
  const here = sq(r, c);
  const mine = S.board[here] !== 0 &&
    (S.board[here] > 0) === (S.humanSide > 0);
  if (S.selected === null || mine) {
    if (!mine) return;
    S.selected = here;
    S.targets = XQ.legalMoves(S.board, S.humanSide)
      .filter((m) => m.from === here).map((m) => m.to);
    render();
    return;
  }
  if (!S.targets.includes(here)) { S.selected = null; S.targets = []; render(); return; }
  const from = S.selected;
  S.selected = null;
  S.targets = [];
  if (S.mode === "server") {
    serverHumanMove(from, here);
  } else {
    applyLocal(from, here);
    render();
    if (!S.over) browserAIMove();
  }
}

async function newGame() {
  S.board = XQ.initialBoard();
  S.current = 1;
  S.selected = null; S.targets = [];
  S.lastMove = null; S.history = []; S.undoStack = [];
  S.over = false; S.winner = null; S.analysis = null; S.error = null;
  S.started = true;
  if (S.mode === "server") {
    S.thinking = true;
    render();
    if (S.sessionId) {  // don't leak the old game until its TTL
      api("/api/session/close", { session_id: S.sessionId }).catch(() => {});
      S.sessionId = null;
    }
    try {
      const d = await api("/api/session/new", {
        human_side: S.humanSide > 0 ? "red" : "black",
      });
      S.sessionId = d.session_id;
      S.board = Int8Array.from(d.board.flat());
      S.current = d.current_player;
      if (d.ai_move) {
        S.lastMove = {
          from: sq(d.ai_move.from[0], d.ai_move.from[1]),
          to: sq(d.ai_move.to[0], d.ai_move.to[1]),
        };
        S.history.push({ notation: d.ai_move.label || "", side: -S.humanSide });
      }
      if (d.ai_analysis) {
        S.analysis = {
          value: d.ai_analysis.value_score,
          topMoves: (d.ai_analysis.top_moves || []).slice(0, 8),
        };
      }
      S.error = null;
    } catch (e) { S.error = e.message; S.started = false; }
    S.thinking = false;
    render();
  } else {
    render();
    if (S.current !== S.humanSide) browserAIMove();
  }
}

function undo() {
  // pop the human move AND the AI reply (browser mode only, like the
  // reference's undoMove)
  if (S.mode !== "browser" || S.thinking) return;
  let steps = S.undoStack.length && S.current === S.humanSide ? 2 : 1;
  while (steps-- > 0 && S.undoStack.length) {
    const u = S.undoStack.pop();
    S.board = u.board; S.current = u.current; S.lastMove = u.lastMove;
    S.history.length = u.histLen;
  }
  S.over = false; S.winner = null; S.selected = null; S.targets = [];
  render();
}

// ------------------------------------------------------------------- UI
const root = document.getElementById("root");
root.innerHTML = `
  <div class="board-wrap">
    <div id="board-host"></div>
    <div class="thinking-badge" id="thinking" hidden>思考中…</div>
  </div>
  <div class="panel">
    <h1>中国象棋 · Xiangqi AlphaZero</h1>
    <div class="sub">GPU AlphaZero + 浏览器内独立引擎</div>
    <div class="row"><label>对手</label>
      <div class="seg" id="mode-seg">
        <button data-m="browser">浏览器 AI</button>
        <button data-m="server">AlphaZero 模型</button>
      </div>
    </div>
    <div class="row" id="level-row"><label>难度</label>
      <div class="seg" id="level-seg"></div>
    </div>
    <div class="row" id="server-row" hidden>
      <label>模型</label><select id="models"></select>
      <label>模拟</label>
      <input id="sims" type="number" min="10" max="10000" value="200" style="width:84px"
             title="模拟次数在加载模型时生效（会话共享同一编译程序）">
    </div>
    <div class="row"><label>执子</label>
      <div class="seg" id="side-seg">
        <button data-s="1">执红 (先手)</button>
        <button data-s="-1">执黑</button>
      </div>
    </div>
    <div class="row">
      <button class="primary" id="new">开始新对局</button>
      <button class="ghost" id="undo">悔棋</button>
    </div>
    <div class="status" id="status">选择对手与执子，开始对局</div>
    <div id="value-wrap" hidden>
      <label style="font-size:.8rem;color:#6b573f">模型局面评估</label>
      <div class="value-bar"><div id="value-fill" style="width:50%"></div></div>
    </div>
    <div class="analysis" id="analysis"></div>
    <h2 style="font-size:.95rem;margin:14px 0 6px">棋谱</h2>
    <div class="history"><table id="history">
      <thead><tr><th>#</th><th>红方</th><th>黑方</th></tr></thead>
      <tbody></tbody></table></div>
    <h2 style="font-size:.95rem;margin:14px 0 6px">被吃子力</h2>
    <div class="row"><label>红</label><div class="captures" id="cap-r"></div></div>
    <div class="row"><label>黑</label><div class="captures" id="cap-b"></div></div>
    <footer class="links"><a href="/">简易界面</a> · 独立规则引擎与 AlphaZero 服务互为校验</footer>
  </div>
`;

const boardRender = createBoard(document.getElementById("board-host"), { onCell });
const $ = (id) => document.getElementById(id);

$("level-seg").innerHTML = LEVELS.map(
  (l) => `<button data-l="${l.v}">${l.name}</button>`
).join("");

$("mode-seg").addEventListener("click", (e) => {
  const m = e.target.dataset.m;
  if (m) { S.mode = m; S.started = false; render(); if (m === "server") loadModels(); }
});
$("level-seg").addEventListener("click", (e) => {
  const l = e.target.dataset.l;
  if (l !== undefined) { S.level = +l; render(); }
});
$("side-seg").addEventListener("click", (e) => {
  const s = e.target.dataset.s;
  if (s) { S.humanSide = +s; render(); }
});
$("new").addEventListener("click", newGame);
$("undo").addEventListener("click", undo);
$("sims").addEventListener("change", (e) => { S.sims = +e.target.value || 200; });
$("models").addEventListener("change", async (e) => {
  if (!e.target.value) return;
  S.thinking = true; render();
  try { await api("/api/load_model", { model_name: e.target.value, num_simulations: S.sims }); S.model = e.target.value; S.error = null; }
  catch (err) { S.error = err.message; }
  S.thinking = false; render();
});

async function loadModels() {
  try {
    const d = await api("/api/models");
    S.models = d.models.map((m) => m.name);
    S.model = d.current;
    render();
  } catch (e) { S.error = e.message; render(); }
}

function statusText() {
  if (S.error) return ["错误: " + S.error, ""];
  if (!S.started) return ["选择对手与执子，开始对局", ""];
  if (S.over) {
    if (S.winner === 0 || S.winner === null) return ["和棋", "draw"];
    const humanWon = S.winner === S.humanSide;
    return [
      (S.winner > 0 ? "红方胜" : "黑方胜") + (humanWon ? " — 你赢了！" : " — 再接再厉"),
      humanWon ? "win" : "lose",
    ];
  }
  if (S.thinking) return ["对方思考中…", ""];
  const check = XQ.inCheck(S.board, S.current);
  const turn = S.current === S.humanSide ? "轮到你走" : "等待对方";
  return [check ? `将军！ ${turn}` : turn, check ? "check" : ""];
}

function render() {
  const checkSq = XQ.inCheck(S.board, S.current)
    ? XQ.findKing(S.board, S.current) : null;
  boardRender({
    board: S.board,
    selected: S.selected,
    targets: S.targets,
    lastMove: S.lastMove,
    checkSq,
    flipped: S.humanSide < 0,
  });
  $("thinking").hidden = !S.thinking;
  for (const b of $("mode-seg").children)
    b.classList.toggle("on", b.dataset.m === S.mode);
  for (const b of $("level-seg").children)
    b.classList.toggle("on", +b.dataset.l === S.level);
  for (const b of $("side-seg").children)
    b.classList.toggle("on", +b.dataset.s === S.humanSide);
  $("level-row").hidden = S.mode !== "browser";
  $("server-row").hidden = S.mode !== "server";
  $("undo").disabled = S.mode !== "browser" || !S.undoStack.length;
  const [txt, cls] = statusText();
  $("status").textContent = txt;
  $("status").className = "status " + cls;

  const ms = $("models");
  if (S.mode === "server" && ms.length !== S.models.length) {
    ms.innerHTML = S.models.map(
      (m) => `<option ${m === S.model ? "selected" : ""}>${m}</option>`
    ).join("");
  }

  if (S.analysis && S.mode === "server") {
    $("value-wrap").hidden = false;
    $("value-fill").style.width = `${50 + 50 * Math.max(-1, Math.min(1, S.analysis.value))}%`;
    $("analysis").innerHTML = "<table><tr><th>走法</th><th>搜索</th><th>先验</th></tr>" +
      S.analysis.topMoves.map((t) =>
        `<tr><td>${t.label || t.move}</td><td>${(100 * t.prob).toFixed(1)}%</td>` +
        `<td>${(100 * (t.raw_prob ?? 0)).toFixed(1)}%</td></tr>`).join("") +
      "</table>";
  } else {
    $("value-wrap").hidden = true;
    $("analysis").innerHTML = "";
  }

  const tb = $("history").tBodies[0];
  const rows = [];
  for (let i = 0; i < S.history.length; i += 2) {
    const red = S.history[i], blk = S.history[i + 1];
    rows.push(`<tr><td>${i / 2 + 1}</td><td>${red ? red.notation : ""}</td>` +
              `<td>${blk ? blk.notation : ""}</td></tr>`);
  }
  tb.innerHTML = rows.join("");
  tb.parentElement.parentElement.scrollTop = 1e6;

  const caps = capturedPieces(S.board);
  $("cap-r").innerHTML = caps.r.map((a) => `<span class="r">${RED_CH[a]}</span>`).join("");
  $("cap-b").innerHTML = caps.b.map((a) => `<span class="b">${BLK_CH[a]}</span>`).join("");
}

render();
