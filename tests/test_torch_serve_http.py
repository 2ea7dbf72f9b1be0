# coding=utf-8
"""The port's HTTP daemon (`centerclip_tpu_torch/serve/http.py`) on the
CPU: the JAX package's HTTP tests (tests/test_serve_http.py).  The JSON API
over a live socket must return exactly what the port's
`RetrievalEngine.search` returns, which ranks as the JAX package's engine
does on the same weights and clips, and keep the error contract."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_torch_serve import _batches, _emb, _engines
from centerclip_tpu_torch.serve import RetrievalEngine, VideoIndex
from centerclip_tpu_torch.serve.http import (MAX_QUERIES_PER_REQUEST,
                                             RetrievalServer)

VIDS = [f"v{i}" for i in range(11)]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def engines():
    jeng, eng = _engines()
    for e in (jeng, eng):
        e.build_index(iter(_batches()), VIDS)
    return jeng, eng


@pytest.fixture(scope="module")
def server(engines):
    srv = RetrievalServer(engines[1], port=0, default_k=3).start()
    yield srv
    srv.stop()


def _base(server):
    return "http://%s:%d" % server.address


def test_healthz(server):
    code, body = _get(_base(server) + "/healthz")
    assert code == 200
    assert body["ok"] is True and body["videos"] == len(VIDS)
    assert body["dim"] == server.engine.index.dim
    assert body["quantize"] == "float32"
    assert body["sim_header"] == "meanP"
    assert body["model"] == server.engine.model.cfg.clip_name


def test_search_matches_engine(server, engines):
    queries = ["a man cooking in a kitchen", "a dog running"]
    code, body = _post(_base(server) + "/search",
                       {"queries": queries, "k": 4})
    assert code == 200 and body["took_ms"] > 0
    direct = server.engine.search(queries, k=4)
    assert body["results"] == direct           # JSON keeps every bit
    for got in body["results"]:
        scores = [r["score"] for r in got]
        assert scores == sorted(scores, reverse=True)
    for got, want in zip(body["results"], engines[0].search(queries, k=4)):
        assert [r["video_id"] for r in got] == [r["video_id"] for r in want]
        # logits (cosine x ~14.3) of the same bf16 score operands, the
        # towers' fp32 sums in another order
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], rtol=0,
                                   atol=2e-2)


def test_search_defaults_and_string_query(server):
    # bare string + omitted k -> default_k results
    code, body = _post(_base(server) + "/search", {"queries": "hello world"})
    assert code == 200
    assert len(body["results"]) == 1 and len(body["results"][0]) == 3


def test_error_contract(server):
    base = _base(server)
    assert _get(base + "/nope")[0] == 404
    assert _post(base + "/nope", {})[0] == 404
    for bad in ({}, {"queries": []}, {"queries": [1, 2]},
                {"queries": ["q"], "k": 0}, {"queries": ["q"], "k": "3"},
                {"queries": ["q"], "k": True},  # bool subclasses int
                {"queries": ["q"] * (MAX_QUERIES_PER_REQUEST + 1)}):
        code, body = _post(base + "/search", bad)
        assert code == 400 and "error" in body, bad
    code, body = _post(base + "/search", None, raw=b"[1, 2]")
    assert code == 400
    code, body = _post(base + "/search", None, raw=b"not json {")
    assert code in (400, 500) and "error" in body
    # oversized body -> 413 before any parse; the server replies without
    # reading and closes the connection, so a client mid-send may get a
    # socket error rather than the status: both are a rejection
    try:
        code, body = _post(base + "/search", None,
                           raw=b" " * ((1 << 20) + 1))
        assert code == 413
    except urllib.error.URLError:
        pass


def test_concurrent_clients(server):
    """Threads hitting /search at once: the lock serialises the card's
    work, every request succeeds, results equal the single-client answer
    (inference mode is entered in each handler thread)."""
    queries = [f"query number {i}" for i in range(6)]
    want = [server.engine.search([q], k=3) for q in queries]
    out = [None] * len(queries)

    def hit(i):
        out[i] = _post(_base(server) + "/search",
                       {"queries": [queries[i]], "k": 3})

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, (code, body) in enumerate(out):
        assert code == 200, (i, body)
        assert body["results"][0] == want[i][0]


def test_warmup_and_requires_index(server):
    assert server.warmup(max_queries=2) == 2         # buckets 1 and 2
    assert server.warmup(max_queries=32) == 6
    assert server.warmup() == 8       # up to MAX_QUERIES_PER_REQUEST
    eng = server.engine
    with pytest.raises(ValueError, match="no index"):
        RetrievalServer(RetrievalEngine(eng.model, device="cpu"), port=0)
    emb, ids = _emb(7, n=5)
    other = RetrievalEngine(eng.model, index=VideoIndex(emb, ids,
                                                        device="cpu"),
                            device="cpu")
    srv = RetrievalServer(other, port=0)       # never started
    assert srv._health()["videos"] == 5
    srv._httpd.server_close()
