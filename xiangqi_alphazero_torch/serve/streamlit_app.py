"""Streamlit human-vs-AI demo (reference: demo_app.py).

Port of ``xiangqi_alphazero_tpu.serve.streamlit_app``. Run from the
repository's root, on the card unless given ``--device cpu``:

    python -m streamlit run xiangqi_alphazero_torch/serve/streamlit_app.py [-- --device cpu]

The same widgets as the reference's Streamlit app (demo_app.py:287-431): a
model picker over the ``.pt`` files and training checkpoints under
``models/`` and ``checkpoints/``, the board as a DataFrame, coordinate move
entry, and the AI's reply with its top moves (search probability against
the raw prior, legality marks). Streamlit and pandas are not dependencies
of the package: ``main`` exits naming the one that is missing.
"""

from __future__ import annotations

import argparse
import sys

from xiangqi_alphazero_torch.engine.oracle import PIECE_NAMES, Position, encode_action
from xiangqi_alphazero_torch.serve.predictor import Predictor, find_models


def main(device=None) -> None:
    try:
        import pandas as pd
        import streamlit as st
    except ImportError as e:  # depends on the host's packages
        raise SystemExit(
            "streamlit (and pandas) are required for this demo: "
            "pip install streamlit pandas\n"
            f"missing: {e.name}"
        )

    st.set_page_config(page_title="Xiangqi AlphaZero (PyTorch)", layout="wide")
    st.title("中国象棋 AlphaZero — PyTorch")

    if "game" not in st.session_state:
        st.session_state.game = Position()
        st.session_state.predictor = None
        st.session_state.analysis = None

    with st.sidebar:
        models = find_models(["models", "checkpoints"])
        names = [m["name"] for m in models]
        pick = st.selectbox("模型", names) if names else None
        sims = st.slider("MCTS 模拟次数", 10, 2000, 100)
        if st.button("加载模型") and pick:
            path = next(m["path"] for m in models if m["name"] == pick)
            st.session_state.predictor = Predictor.load(path, num_simulations=sims,
                                                        device=device)
            st.success(f"已加载 {pick}")
        if st.button("新对局"):
            st.session_state.game = Position()
            st.session_state.analysis = None

    game: Position = st.session_state.game
    board = game.board_array().reshape(10, 9)
    df = pd.DataFrame(
        [[PIECE_NAMES[int(p)] for p in row] for row in board[::-1]],
        index=list(range(9, -1, -1)),
        columns=list(range(9)),
    )
    st.dataframe(df, use_container_width=False)

    done, winner = game.result()
    if done:
        st.header({1: "红胜", -1: "黑胜", 0: "和棋"}[winner])
        return

    st.write(f"轮到: {'红' if game.side == 1 else '黑'} · 第 {game.ply} 步")
    c1, c2, c3, c4, c5 = st.columns(5)
    fr = c1.number_input("from 行", 0, 9, 0)
    fc = c2.number_input("from 列", 0, 8, 0)
    tr = c3.number_input("to 行", 0, 9, 0)
    tc = c4.number_input("to 列", 0, 8, 0)
    if c5.button("走棋"):
        a = encode_action(int(fr), int(fc), int(tr), int(tc))
        if a not in game.legal_actions():
            st.error("非法走法")
        else:
            game.apply(a)
            if st.session_state.predictor is not None:
                done, _ = game.result()
                if not done:
                    st.session_state.analysis = st.session_state.predictor.ai_move(game)
            st.rerun()

    an = st.session_state.analysis
    if an:
        st.subheader(f"AI: {an['ai_move']['label']} · 评估 {an['ai_analysis']['value_score']}")
        st.table(
            pd.DataFrame(
                [
                    {
                        "走法": m["label"],
                        "搜索概率": m["prob"],
                        "先验": m["raw_prob"],
                        "合法": "✓" if m["legal"] else "✗",
                        "选中": "◉" if m["selected"] else "",
                    }
                    for m in an["ai_analysis"]["top_moves"]
                ]
            )
        )


def _device_from_argv(argv=None) -> str:
    p = argparse.ArgumentParser(description="Streamlit demo")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' for the CPU)")
    return p.parse_known_args(argv)[0].device


if __name__ == "__main__":
    main(_device_from_argv(sys.argv[1:]))
