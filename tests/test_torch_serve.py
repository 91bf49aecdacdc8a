"""The port's serving path against the JAX package's, on the CPU: one tiny
reference-layout ``.pt`` (8 channels, 1 block) loads into both Predictors,
which must give equal searches and the same AI moves; a coalesced
``search_batch`` lane equals the solo search; and the port's HTTP API,
served on an ephemeral localhost port, answers every endpoint with the JAX
API's status codes, payload keys and moves."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from xiangqi_alphazero_torch.engine import oracle as TO
from xiangqi_alphazero_torch.serve import api as TA
from xiangqi_alphazero_torch.serve import predictor as TP
from xiangqi_alphazero_tpu.engine import oracle as JO
from xiangqi_alphazero_tpu.models import init_net
from xiangqi_alphazero_tpu.serve import api as JA
from xiangqi_alphazero_tpu.serve import predictor as JP
from xiangqi_alphazero_tpu.serve.export import export_torch_checkpoint

SIMS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A directory holding ``tiny.pt``: seeded random JAX weights written by
    the JAX package's exporter."""
    _, variables = init_net(jax.random.key(0), channels=8, blocks=1)
    variables = jax.tree.map(np.asarray, variables)
    d = tmp_path_factory.mktemp("models")
    export_torch_checkpoint(
        str(d / "tiny.pt"), variables["params"], variables["batch_stats"],
        {"num_channels": 8, "num_res_blocks": 1},
    )
    return d


@pytest.fixture(scope="module")
def predictors(model_dir):
    path = str(model_dir / "tiny.pt")
    return (
        JP.Predictor.load(path, num_simulations=SIMS),
        TP.Predictor.load(path, num_simulations=SIMS, device="cpu"),
    )


def _positions(seed: int, plies: int):
    """The same game, with its history, as a JAX and a port Position."""
    rng = np.random.default_rng(seed)
    pj, pt = JO.Position(), TO.Position()
    for _ in range(plies):
        acts = pj.legal_actions()
        if pj.result()[0] or not acts:
            break
        a = int(rng.choice(acts))
        pj.apply(a)
        pt.apply(a)
    return pj, pt


_GAMES = [(0, 0), (1, 14), (2, 31)]   # the opening and two midgames


@pytest.mark.parametrize("seed,plies", _GAMES)
def test_search_and_ai_move_match_jax_predictor(predictors, seed, plies):
    jp, tp = predictors
    pj, pt = _positions(seed, plies)
    for got, want in zip(tp.search_position(pt), jp.search_position(pj)):
        np.testing.assert_array_equal(got, want)
    tj, tt = jp.ai_move(pj.copy()), tp.ai_move(pt.copy())
    assert tt["ai_move"] == tj["ai_move"]
    assert tt["board"] == tj["board"] and tt["game_over"] == tj["game_over"]
    assert abs(tt["ai_analysis"]["value_score"] - tj["ai_analysis"]["value_score"]) < 2e-4
    mj, mt = tj["ai_analysis"]["top_moves"], tt["ai_analysis"]["top_moves"]
    assert len(mt) == len(mj)
    for a, b in zip(mt, mj):
        # raw_prob is a float32 softmax output from two frameworks
        assert abs(a.pop("raw_prob") - b.pop("raw_prob")) < 1e-5
        assert a == b


def test_search_batch_lane_equals_solo(predictors):
    _, tp = predictors
    positions = [_positions(s, p)[1] for s, p in _GAMES]
    batched = tp.search_batch(positions, pad_to=4)
    for pos, lane in zip(positions, batched):
        for got, want in zip(lane, tp.search_position(pos)):
            np.testing.assert_array_equal(got, want)


def test_raw_predict_matches_jax(predictors):
    jp, tp = predictors
    pj, pt = _positions(3, 9)
    (p1, v1), (p2, v2) = jp.raw_predict(pj), tp.raw_predict(pt)
    np.testing.assert_allclose(p2, p1, rtol=1e-4, atol=1e-7)
    assert abs(v1 - v2) < 1e-5
    (bp, bv) = tp.raw_predict_batch([pt, TO.Position()], pad_to=4)
    assert bp.shape == (2, 8100) and bv.shape == (2,)
    np.testing.assert_allclose(bp[0], p2, atol=1e-7)


def test_orbax_bundle_and_gumbel_are_refused(predictors, tmp_path):
    """An orbax bundle is still refused; ``algo="gumbel"`` now serves a
    legal, visited move (the name is kept from when it was refused)."""
    _, tp = predictors
    with pytest.raises(ValueError, match="export"):
        TP.Predictor.load(str(tmp_path), device="cpu")
    g = TP.Predictor(tp.net, num_simulations=SIMS, algo="gumbel", device="cpu")
    actions, visits, _, chosen = g.search_position(TO.Position())
    assert chosen in TO.Position().legal_actions()
    assert visits[actions == chosen].sum() > 0
    with pytest.raises(ValueError, match="algo"):
        TP.Predictor(tp.net, algo="nope", device="cpu")
    clone = tp.with_simulations(20)
    assert clone.net is tp.net and clone.num_simulations == 20
    gclone = g.with_simulations(24)
    assert gclone.algo == "gumbel" and gclone.num_simulations == 24
    assert TP.find_models([str(tmp_path)]) == []


def _jax_key0_draws(batch: int) -> np.ndarray:
    """The JAX Predictor's root draws: key(0) split per lane
    (gumbel.py:262-264)."""
    import jax.numpy as jnp

    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (128,), jnp.float32))(
        jax.random.split(jax.random.key(0), batch)))


@pytest.fixture(scope="module")
def gumbel_predictors(predictors):
    """Both packages' Gumbel Predictors on the same ``.pt`` (one JAX
    compile for the module)."""
    jp, tp = predictors
    return (JP.Predictor(jp.net, jp.variables, SIMS, algo="gumbel"),
            TP.Predictor(tp.net, SIMS, algo="gumbel", device="cpu"))


@pytest.mark.parametrize("seed,plies", _GAMES[1:])
def test_gumbel_predictor_matches_jax(gumbel_predictors, monkeypatch, seed, plies):
    """The Gumbel Predictors of both packages on one ``.pt``, JAX's root
    draws injected into the port: equal (actions, visits, order, chosen),
    and the payload acts ``chosen``; coalesced lanes carry their chosen."""
    from xiangqi_alphazero_torch.search import gumbel as TG

    jp, tp = gumbel_predictors
    monkeypatch.setattr(TG, "_root_gumbel", lambda b, k, gen, dev: torch.from_numpy(
        _jax_key0_draws(b)).to(dev))
    pj, pt = _positions(seed, plies)
    want, got = jp.search_position(pj), tp.search_position(pt)
    assert len(got) == 4 and got[3] == want[3] >= 0
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    payload = tp.ai_move_from_search(pt.copy(), got)
    assert payload["ai_move"]["action"] == got[3]
    sel = [m for m in payload["ai_analysis"]["top_moves"] if m["selected"]]
    assert len(sel) == 1 and sel[0]["action"] == got[3] and sel[0]["legal"]
    # lane 0 of a coalesced batch is the search alone; every lane acts a
    # legal, visited move
    lanes = tp.search_batch([pt, TO.Position()], pad_to=4)
    assert all(len(lane) == 4 for lane in lanes)
    for g, w in zip(lanes[0], got):
        np.testing.assert_array_equal(g, w)
    acts, vis, _, chosen = lanes[1]
    assert chosen in TO.Position().legal_actions() and vis[acts == chosen].sum() > 0


def _keys(x):
    """The payload's key structure (dicts recursively, lists by their
    first element)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [_keys(x[0])]
    return None


def test_http_api_matches_jax_api(model_dir):
    """The port's HTTP API (CPU) and the JAX GameService get the same
    requests: equal status codes, equal payload keys, equal moves."""
    httpd, tsvc = TA.make_server("127.0.0.1", 0, [str(model_dir)], device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def http(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        try:
            with opener.open(urllib.request.Request(base + path, data=data), timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    jsvc = JA.GameService(model_dirs=[str(model_dir)])
    jax_routes = {
        "/api/models": jsvc.models,
        "/api/load_model": jsvc.load_model,
        "/api/new_game": jsvc.new_game,
        "/api/get_legal_moves": jsvc.get_legal_moves,
        "/api/human_move": jsvc.human_move,
        "/api/session/new": jsvc.session_new,
        "/api/session/move": jsvc.session_move,
        "/api/session/stats": jsvc.session_stats,
    }
    jsession = None
    try:
        def both(path, body=None):
            got = http(path, body)
            if body is not None and "session_id" in body:
                body = dict(body, session_id=jsession)
            fn = jax_routes[path]
            code, payload = fn() if body is None else fn(body)
            want = code, json.loads(json.dumps(payload))   # as sent over HTTP
            assert got[0] == want[0], (path, got, want)
            assert _keys(got[1]) == _keys(want[1]), path
            return got[1], want[1]

        got, want = both("/api/models")
        assert [m["name"] for m in got["models"]] == ["tiny.pt"] == [
            m["name"] for m in want["models"]
        ]
        assert got["device"] == "cpu"
        both("/api/load_model", {"model_name": "missing.pt"})            # 404
        got, _ = both("/api/load_model", {"model_name": "tiny.pt", "num_simulations": SIMS})
        assert got["success"] and got["device"] == "cpu"
        both("/api/new_game", {"human_side": "red", "num_simulations": SIMS})
        got, want = both("/api/get_legal_moves", {"row": 3, "col": 0})
        assert got == want and {"to_row": 4, "to_col": 0} in got["moves"]
        got, want = both(
            "/api/human_move", {"from_row": 3, "from_col": 0, "to_row": 4, "to_col": 0}
        )
        assert got["ai_move"] == want["ai_move"] and got["board"] == want["board"]
        both("/api/human_move", {"from_row": 0, "from_col": 0, "to_row": 5, "to_col": 5})  # 400

        got, want = both("/api/session/new", {"human_side": "red"})
        jsession = want["session_id"]
        got, want = both(
            "/api/session/move",
            {"session_id": got["session_id"], "from_row": 2, "from_col": 1,
             "to_row": 2, "to_col": 4},
        )
        assert got["ai_move"] == want["ai_move"]
        assert got["ai_analysis"]["num_simulations"] == SIMS
        got, want = both("/api/session/stats")
        assert got["search"]["requests"] == 1
        assert http("/api/session/move", {"session_id": "nope"})[0] == 404
        assert http("/api/nope", {})[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        for svc in (tsvc, jsvc):
            if svc.searcher is not None:
                svc.searcher.stop()


def test_http_api_gumbel_answers_human_move(model_dir):
    """``GameService(search_algo="gumbel")`` behind the HTTP handler: a
    human move gets a legal AI reply, and a session move its chosen."""
    httpd, svc = TA.make_server("127.0.0.1", 0, [str(model_dir)], device="cpu",
                                search_algo="gumbel")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def http(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        with opener.open(urllib.request.Request(base + path, data=data), timeout=300) as r:
            return r.status, json.loads(r.read())

    try:
        assert http("/api/load_model", {"model_name": "tiny.pt", "num_simulations": SIMS})[0] == 200
        assert svc.predictor.algo == "gumbel"
        http("/api/new_game", {"human_side": "red", "num_simulations": SIMS})
        code, res = http("/api/human_move",
                         {"from_row": 3, "from_col": 0, "to_row": 4, "to_col": 0})
        pos = TO.Position()
        pos.apply(27 * 90 + 36)
        assert code == 200 and res["ai_move"]["action"] in pos.legal_actions()
        sel = [m for m in res["ai_analysis"]["top_moves"] if m["selected"]]
        assert sel and sel[0]["action"] == res["ai_move"]["action"]
        sid = http("/api/session/new", {"human_side": "red"})[1]["session_id"]
        code, res = http("/api/session/move", {"session_id": sid, "from_row": 3, "from_col": 0,
                                                "to_row": 4, "to_col": 0})
        assert code == 200 and res["ai_move"]["action"] in pos.legal_actions()
    finally:
        httpd.shutdown()
        httpd.server_close()
        if svc.searcher is not None:
            svc.searcher.stop()
