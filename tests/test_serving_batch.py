"""Cross-request micro-batching in serving (round-2 VERDICT item 3).

The engine's dispatch cost is batch-size-invariant up to query_batch
so concurrent requests must coalesce into shared engine calls instead of
queueing one dispatch each.
Covers: result equivalence with the serial path, coalescing under
contention (direct and through the HTTP loopback), per-request k inside a
shared batch, OOV placeholders, and error propagation to every waiter.
"""

import json
import threading
import urllib.request

import pytest

from sert_tpu import pipeline, recipes
from sert_tpu.serving import EntitySearcher, make_http_server


@pytest.fixture(scope="module")
def searcher(tmp_path_factory):
    root = tmp_path_factory.mktemp("batchserve")
    recipe = recipes.tiny_recipe("loglinear")
    col = recipes.tiny_spec(seed=11).build()
    data = str(root / "data")
    pipeline.prepare_collection(col, data, recipe)
    pipeline.train_from_dir(recipe, data, str(root / "run"), resume=False)
    s = EntitySearcher(recipe, data, str(root / "run"), k=5)
    return s, col


def _queries(col, n):
    topics = sorted(col.topics)
    return [col.topics[topics[i % len(topics)]] for i in range(n)]


class TestMicroBatch:
    def test_single_request_still_one_dispatch(self, searcher):
        s, col = searcher
        base = dict(s.stats)
        hits = s.search(_queries(col, 1)[0])
        assert hits and len(hits) == 5
        assert s.stats["dispatches"] == base["dispatches"] + 1
        assert s.stats["batched_queries"] == base["batched_queries"] + 1

    def test_concurrent_requests_coalesce(self, searcher):
        """16 threads blocked behind one slow dispatch must drain into a
        shared batch, not 16 serial dispatches. The first-arriving leader
        is slowed so the rest provably pile up."""
        s, col = searcher
        texts = _queries(col, 16)
        serial = [s.search(t) for t in texts]

        real = s._score
        release = threading.Event()

        def slow_score(encoded):
            out = real(encoded)
            if not release.is_set():     # only the first (leader) dispatch
                release.set()
                import time
                time.sleep(0.3)
            return out

        s._score = slow_score
        base = dict(s.stats)
        results = [None] * 16
        try:
            def worker(i):
                results[i] = s.search(texts[i])
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(16)]
            threads[0].start()
            release.wait(timeout=5)      # leader is inside the device call
            for t in threads[1:]:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            s._score = real
        d = s.stats["dispatches"] - base["dispatches"]
        q = s.stats["batched_queries"] - base["batched_queries"]
        assert q == 16
        assert d <= 4                    # 1 leader + the drained pile-up
        assert s.stats["max_batch"] >= 8
        for got, want in zip(results, serial):
            assert got == want           # coalescing must not change results

    def test_per_request_k_inside_shared_batch(self, searcher):
        s, col = searcher
        text = _queries(col, 1)[0]
        got = {}
        barrier = threading.Barrier(2)

        def worker(k):
            barrier.wait()
            got[k] = s.search(text, k=k)

        ts = [threading.Thread(target=worker, args=(k,)) for k in (2, 7)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert len(got[2]) == 2 and len(got[7]) == 7
        assert got[7][:2] == got[2]      # same ranking, different slice

    def test_search_many_oov_placeholders(self, searcher):
        s, col = searcher
        text = _queries(col, 1)[0]
        out = s.search_many(["zzzunknownzzz", text, ""])
        assert out[0] is None and out[2] is None
        assert out[1] == s.search(text)
        assert s.search_many(["zzzunknownzzz"]) == [None]

    def test_error_propagates_to_all_waiters(self, searcher):
        s, col = searcher
        texts = _queries(col, 4)
        real = s._score

        def boom(encoded):
            raise RuntimeError("injected engine failure")

        s._score = boom
        errs = []
        try:
            def worker(i):
                try:
                    s.search(texts[i])
                except RuntimeError as e:
                    errs.append(str(e))
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            s._score = real
        assert len(errs) == 4 and all("injected" in e for e in errs)
        # the batcher must be usable again after a failed dispatch
        assert s.search(texts[0])

    def test_http_concurrent_clients_coalesce(self, searcher):
        s, col = searcher
        server = make_http_server(s)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = dict(s.stats)
        texts = _queries(col, 12)
        payloads = [None] * 12
        try:
            def client(i):
                q = urllib.parse.quote(texts[i])
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/search?q={q}&k=3",
                        timeout=30) as r:
                    payloads[i] = json.loads(r.read())
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            server.shutdown()
            server.server_close()
        assert all(p is not None and len(p["results"]) == 3
                   for p in payloads)
        d = s.stats["dispatches"] - base["dispatches"]
        q = s.stats["batched_queries"] - base["batched_queries"]
        assert q == 12
        # ThreadingHTTPServer spawns all clients at once against a ~ms
        # dispatch; strictly fewer engine calls than clients proves the
        # HTTP surface rides the batcher (usually far fewer).
        assert d < 12

    def test_batch_failure_isolated_per_request(self, searcher):
        """One request's input-dependent failure inside a coalesced
        dispatch must NOT surface as errors for the unrelated concurrent
        clients: the leader retries each request alone, so only the
        offending one raises (regression: the whole batch used to inherit
        the first exception)."""
        s, col = searcher
        texts = _queries(col, 6)
        poison = texts[0]
        poison_ids = s.encode(poison)
        serial = [s.search(t) for t in texts[1:]]

        real = s._score
        release = threading.Event()

        def scorer(encoded):
            if any(list(ids) == list(poison_ids) for ids in encoded.values()):
                raise RuntimeError("poisoned query")
            out = real(encoded)
            if not release.is_set():     # slow only the first (leader) call
                release.set()
                import time
                time.sleep(0.3)
            return out

        s._score = scorer
        results = {}
        errors = {}
        try:
            def worker(i, text):
                try:
                    results[i] = s.search(text)
                except RuntimeError as e:
                    errors[i] = str(e)

            threads = [threading.Thread(target=worker, args=(i, t))
                       for i, t in enumerate([texts[1]] + texts)]
            threads[0].start()           # clean leader occupies the device
            release.wait(timeout=5)
            for t in threads[1:]:        # poison + clean pile up together
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            s._score = real
        assert list(errors.values()) == ["poisoned query"]
        assert errors and 1 in errors    # only the poisoned request failed
        for i, want in [(0, serial[0]), (2, serial[0])] + \
                       [(i + 1, serial[i - 1]) for i in range(2, 6)]:
            assert results[i] == want, i
        assert s.search(texts[1])        # batcher healthy afterwards
