/* SVG Xiangqi board component.
 *
 * Own implementation of the capabilities of the reference's React board
 * (reference: web/client/src/components/XiangqiBoard.tsx): wooden grid
 * with palace diagonals, river inscription, position markers, piece discs
 * with shadow + double ring, selection ring, valid-move dots, last-move
 * and check highlights, and board flipping when playing black.
 */

const CELL = 58, PAD = 42, R = 24;
const W = 8 * CELL + 2 * PAD, H = 9 * CELL + 2 * PAD;
const NS = "http://www.w3.org/2000/svg";

const RED_CH = { 1: "帥", 2: "仕", 3: "相", 4: "馬", 5: "車", 6: "炮", 7: "兵" };
const BLK_CH = { 1: "將", 2: "士", 3: "象", 4: "馬", 5: "車", 6: "砲", 7: "卒" };

function el(tag, attrs = {}, text = null) {
  const node = document.createElementNS(NS, tag);
  for (const [k, v] of Object.entries(attrs)) node.setAttribute(k, v);
  if (text !== null) node.textContent = text;
  return node;
}

export function createBoard(container, { onCell }) {
  const svg = el("svg", {
    class: "board", width: W, height: H, viewBox: `0 0 ${W} ${H}`,
  });
  container.appendChild(svg);

  // ---- static background ------------------------------------------------
  const defs = el("defs");
  const grad = el("linearGradient", { id: "wood", x1: 0, y1: 0, x2: 1, y2: 1 });
  grad.appendChild(el("stop", { offset: "0%", "stop-color": "#ecd096" }));
  grad.appendChild(el("stop", { offset: "55%", "stop-color": "#e2bd7c" }));
  grad.appendChild(el("stop", { offset: "100%", "stop-color": "#d4a865" }));
  defs.appendChild(grad);
  svg.appendChild(defs);
  svg.appendChild(el("rect", { width: W, height: H, fill: "url(#wood)", rx: 10 }));

  const staticLayer = el("g");
  const pieceLayer = el("g");
  const hintLayer = el("g");
  svg.appendChild(staticLayer);
  svg.appendChild(pieceLayer);
  svg.appendChild(hintLayer);

  const X = (c) => PAD + c * CELL;
  const Y = (r) => PAD + r * CELL;
  const line = (x1, y1, x2, y2, w = 1.3) =>
    staticLayer.appendChild(el("line", {
      x1, y1, x2, y2, stroke: "#5c3d2e", "stroke-width": w,
    }));

  // horizontals; verticals break at the river (rows here are VISUAL:
  // 0 at the top)
  for (let r = 0; r < 10; r++) line(X(0), Y(r), X(8), Y(r));
  for (let c = 0; c < 9; c++) {
    if (c === 0 || c === 8) line(X(c), Y(0), X(c), Y(9));
    else { line(X(c), Y(0), X(c), Y(4)); line(X(c), Y(5), X(c), Y(9)); }
  }
  line(X(0) - 5, Y(0) - 5, X(8) + 5, Y(0) - 5, 2.4);
  line(X(0) - 5, Y(9) + 5, X(8) + 5, Y(9) + 5, 2.4);
  line(X(0) - 5, Y(0) - 5, X(0) - 5, Y(9) + 5, 2.4);
  line(X(8) + 5, Y(0) - 5, X(8) + 5, Y(9) + 5, 2.4);
  // palaces
  for (const top of [0, 7]) {
    line(X(3), Y(top), X(5), Y(top + 2));
    line(X(5), Y(top), X(3), Y(top + 2));
  }
  // river inscription
  const river = el("text", {
    x: W / 2, y: Y(4) + CELL / 2 + 7, "text-anchor": "middle",
    "font-size": 26, fill: "#8a6a43", "letter-spacing": "1.2em",
    "font-family": "KaiTi, 'Noto Serif SC', serif", opacity: .85,
  }, "楚 河　漢 界");
  staticLayer.appendChild(river);
  // position markers at cannon / pawn starting points
  const mark = (r, c) => {
    for (const [dx, dy] of [[-1, -1], [1, -1], [-1, 1], [1, 1]]) {
      if ((c === 0 && dx < 0) || (c === 8 && dx > 0)) continue;
      const x = X(c) + dx * 7, y = Y(r) + dy * 7;
      staticLayer.appendChild(el("path", {
        d: `M ${x} ${y + dy * 7} L ${x} ${y} L ${x + dx * 7} ${y}`,
        fill: "none", stroke: "#5c3d2e", "stroke-width": 1,
      }));
    }
  };
  for (const r of [2, 7]) for (const c of [1, 7]) mark(r, c);
  for (const r of [3, 6]) for (const c of [0, 2, 4, 6, 8]) mark(r, c);

  // ---- dynamic rendering ------------------------------------------------
  let flippedNow = false;
  // engine rows: 0 = red base. Visual row 0 is the TOP of the screen; the
  // human plays from the bottom, so red-at-bottom means visual flip of the
  // engine row unless the board is "flipped" (human is black).
  const vis = (r, c) => (flippedNow ? [r, 8 - c] : [9 - r, c]);

  svg.addEventListener("click", (ev) => {
    const pt = svg.getBoundingClientRect();
    const sx = ((ev.clientX - pt.left) / pt.width) * W;
    const sy = ((ev.clientY - pt.top) / pt.height) * H;
    const vc = Math.round((sx - PAD) / CELL);
    const vr = Math.round((sy - PAD) / CELL);
    if (vr < 0 || vr > 9 || vc < 0 || vc > 8) return;
    if (Math.abs(sx - X(vc)) > CELL * .42 || Math.abs(sy - Y(vr)) > CELL * .42) return;
    const r = flippedNow ? vr : 9 - vr;
    const c = flippedNow ? 8 - vc : vc;
    onCell(r, c);
  });

  function piece(r, c, code, { selected, inCheck }) {
    const [vr, vc] = vis(r, c);
    const g = el("g", {
      transform: `translate(${X(vc)}, ${Y(vr)})`, cursor: "pointer",
    });
    const red = code > 0;
    const color = red ? "#b5441f" : "#222222";
    g.appendChild(el("circle", { cx: 2, cy: 3, r: R, fill: "rgba(0,0,0,.28)" }));
    g.appendChild(el("circle", {
      cx: 0, cy: 0, r: R, fill: "#fdf4de",
      stroke: color, "stroke-width": 2,
    }));
    g.appendChild(el("circle", {
      cx: 0, cy: 0, r: R - 4, fill: "none",
      stroke: color, "stroke-width": 1,
    }));
    g.appendChild(el("text", {
      x: 0, y: 1.5, "text-anchor": "middle", "dominant-baseline": "central",
      "font-size": 25, fill: color,
      "font-family": "KaiTi, 'Noto Serif SC', serif", "font-weight": 700,
    }, (red ? RED_CH : BLK_CH)[Math.abs(code)]));
    if (selected) {
      g.appendChild(el("circle", {
        cx: 0, cy: 0, r: R + 4, fill: "none",
        stroke: "#1f5ab5", "stroke-width": 2.5, "stroke-dasharray": "6 4",
      }));
    }
    if (inCheck) {
      const warn = el("circle", {
        cx: 0, cy: 0, r: R + 4, fill: "none",
        stroke: "#e03616", "stroke-width": 3,
      });
      warn.appendChild(el("animate", {
        attributeName: "opacity", values: "1;.25;1", dur: "1s",
        repeatCount: "indefinite",
      }));
      g.appendChild(warn);
    }
    return g;
  }

  return function render(state) {
    flippedNow = !!state.flipped;
    pieceLayer.replaceChildren();
    hintLayer.replaceChildren();

    // last-move highlight under the pieces
    if (state.lastMove) {
      for (const sq of [state.lastMove.from, state.lastMove.to]) {
        const [vr, vc] = vis(Math.floor(sq / 9), sq % 9);
        pieceLayer.appendChild(el("rect", {
          x: X(vc) - R - 3, y: Y(vr) - R - 3,
          width: 2 * R + 6, height: 2 * R + 6, rx: 8,
          fill: "rgba(255, 214, 90, .45)",
        }));
      }
    }
    for (let sq = 0; sq < 90; sq++) {
      const code = state.board[sq];
      if (code === 0) continue;
      pieceLayer.appendChild(piece(
        Math.floor(sq / 9), sq % 9, code,
        {
          selected: state.selected === sq,
          inCheck: state.checkSq === sq,
        }
      ));
    }
    for (const sq of state.targets || []) {
      const [vr, vc] = vis(Math.floor(sq / 9), sq % 9);
      const occupied = state.board[sq] !== 0;
      hintLayer.appendChild(el("circle", {
        cx: X(vc), cy: Y(vr), r: occupied ? R + 3 : 8,
        fill: occupied ? "none" : "rgba(31, 90, 181, .55)",
        stroke: occupied ? "rgba(224, 54, 22, .8)" : "none",
        "stroke-width": 3, "pointer-events": "none",
      }));
    }
  };
}
