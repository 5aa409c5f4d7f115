"""The port's graph library against the JAX package's own suite and across
the packages.

- ``tests/test_graph.py`` runs here a second time on the port's modules on
  the CPU: its globals are swapped by monkeypatch (its ``jnp`` for a thin
  stand-in that builds torch tensors with JAX's default dtypes), its lazy
  ``asyncframework_tpu.graph`` imports are aliased in ``sys.modules`` to
  the port's package, and ``ASYNCTPU_FORCE_CPU`` stands in for the JAX
  package's default device.
- Across the packages, on the same seeded edges at small n: connected
  components, triangle counts, label propagation (ties to the smallest
  label), shortest paths, SCC and every ``partition_edges`` strategy
  exactly; PageRank and personalized PageRank within 1e-6 (max-abs) with
  the same number of Pregel iterations (the JAX package's counted by a
  ``jax.debug.callback`` in its vertex program); SVD++ trained by both
  from the same ``jax.random`` draws of the initial factors, within 1e-4;
  a ``Graph`` and an ``SVDPlusPlusModel`` carried both ways.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

import test_graph as ref_graph

import jax
import jax.numpy as jnp
from asyncframework_tpu import graph as jg
from asyncframework_tpu.graph import algorithms as j_alg
from asyncframework_tpu.ml import persistence as j_persistence
from asyncframework_tpu_torch import convert
from asyncframework_tpu_torch import graph as tg
from asyncframework_tpu_torch.graph import algorithms as t_alg
from asyncframework_tpu_torch.graph import graph as t_graph_mod
from asyncframework_tpu_torch.ml import persistence as t_persistence

CPU = torch.device("cpu")
# the module (the package's ``pregel`` attribute is the function)
t_pregel_mod = importlib.import_module("asyncframework_tpu_torch.graph.pregel")


class _TorchAsJnp:
    """The few ``jax.numpy`` names ``tests/test_graph.py`` uses, building
    torch tensors on the CPU with JAX's default dtypes (float32 and int32
    for host float64 and int64, as JAX narrows them without x64)."""

    int32 = torch.int32
    float32 = torch.float32
    inf = float("inf")
    iinfo = staticmethod(torch.iinfo)
    minimum = staticmethod(torch.minimum)

    @staticmethod
    def asarray(x, dtype=None):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if dtype is None:
            dtype = {torch.float64: torch.float32,
                     torch.int64: torch.int32}.get(t.dtype, t.dtype)
        return t.to(dtype)

    @staticmethod
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)


ALIASES = {
    "asyncframework_tpu.graph": tg,
    "asyncframework_tpu.graph.graph": t_graph_mod,
    "asyncframework_tpu.graph.pregel": t_pregel_mod,
    "asyncframework_tpu.graph.algorithms": t_alg,
}


@pytest.fixture(autouse=True)
def _port_modules(request, monkeypatch):
    """Point ``tests/test_graph.py``'s cases at the port's package on the
    CPU; the cases across the packages (``port_modules = False``) run
    unpatched."""
    if not getattr(request.cls, "port_modules", True):
        yield
        return
    monkeypatch.setenv("ASYNCTPU_FORCE_CPU", "1")
    for name, module in ALIASES.items():
        monkeypatch.setitem(sys.modules, name, module)
    monkeypatch.setattr(importlib.import_module("asyncframework_tpu"),
                        "graph", tg)
    for name, value in dict(
            Graph=tg.Graph, connected_components=tg.connected_components,
            pagerank=tg.pagerank, pregel=tg.pregel,
            segment_combine=t_pregel_mod.segment_combine,
            jnp=_TorchAsJnp).items():
        monkeypatch.setattr(ref_graph, name, value)
    yield


# ------------------------------------------ tests/test_graph.py on the port
for _name in dir(ref_graph):
    if _name.startswith("Test"):
        globals()[f"{_name}OnThePort"] = type(
            f"{_name}OnThePort", (getattr(ref_graph, _name),), {})


# -------------------------------------------------- the port's own surface
class TestPortSurface:
    def test_endpoints_stay_int32_and_widen_once(self):
        g = tg.Graph(np.array([0, 1, 2]), np.array([1, 2, 0]), device=CPU)
        assert g.src.dtype == g.dst.dtype == torch.int32
        assert g.src_index.dtype == torch.int64
        assert g.src_index is g.src_index  # made once
        assert g.reverse().dst.dtype == torch.int32

    def test_graph_follows_its_tensors_device(self):
        src = torch.tensor([0, 1], dtype=torch.int32)
        g = tg.Graph(src, torch.tensor([1, 0]), 2)
        assert g.device == CPU

    def test_entry_point_raises_without_a_card(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default is the card")
        monkeypatch.delenv("ASYNCTPU_FORCE_CPU", raising=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tg.Graph([0, 1], [1, 0])
        with pytest.raises(RuntimeError, match="CUDA"):
            tg.svd_plus_plus([0], [0], [1.0])

    def test_pregel_stopping_rule(self):
        g = tg.Graph.from_edges([(0, 1)], 2, device=CPU)
        out = tg.pregel(g, torch.zeros(2), lambda a, m: a,
                        lambda s, d, e: s, max_iterations=50)
        assert tg.pregel.last_iterations == 1  # the first always runs
        tg.pregel(g, out, lambda a, m: a + 1, lambda s, d, e: s,
                  max_iterations=7)
        assert tg.pregel.last_iterations == 7
        tg.pregel(g, out, lambda a, m: a + 1, lambda s, d, e: s,
                  max_iterations=0)
        assert tg.pregel.last_iterations == 0
        # within tol: stops at the first step that moves at most tol
        tg.pregel(g, torch.zeros(2), lambda a, m: a + 0.5 ** (m * 0 + 1)
                  * (a < 1).float(), lambda s, d, e: s, tol=0.0,
                  max_iterations=10)
        assert tg.pregel.last_iterations == 3

    @pytest.mark.parametrize("merge", ["sum", "min", "max"])
    def test_segment_combine_2d_messages(self, merge):
        rs = np.random.default_rng(4)
        msgs = rs.normal(size=(40, 3)).astype(np.float32)
        dst = rs.integers(0, 9, size=40)
        got = t_pregel_mod.segment_combine(torch.from_numpy(msgs),
                                           torch.from_numpy(dst), 10, merge)
        want = np.asarray(jg.pregel.__globals__["segment_combine"](
            jnp.asarray(msgs), jnp.asarray(dst), 10, merge))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        assert got.shape == (10, 3)


# ---------------------------------------------------- across the packages
def _edges(seed, n, e):
    rs = np.random.default_rng(seed)
    return rs.integers(0, n, size=(e, 2)).astype(np.int32)


GRAPHS = {
    "random_80": (_edges(1, 80, 300), 80),
    "sparse_120": (_edges(2, 120, 130), 120),  # many components
    "cliques_ties": (np.array(
        [(a, b) for a in range(4) for b in range(4) if a < b]
        + [(a, b) for a in range(4, 8) for b in range(4, 8) if a < b]
        + [(3, 4), (8, 9), (9, 10), (10, 8), (11, 12)], np.int32), 14),
    "path_ties": (np.array([(0, 1), (1, 2), (2, 3), (3, 4)], np.int32), 6),
}


def _pair(name):
    e, n = GRAPHS[name]
    return (jg.Graph(e[:, 0], e[:, 1], n),
            tg.Graph(e[:, 0], e[:, 1], n, device=CPU))


class TestAcrossExact:
    port_modules = False

    @pytest.mark.parametrize("graph", sorted(GRAPHS))
    @pytest.mark.parametrize("algo", [
        "connected_components", "triangle_count", "label_propagation",
        "shortest_paths", "strongly_connected_components"])
    def test_equal_to_the_jax_package(self, graph, algo):
        J, T = _pair(graph)
        args = ([0, 3, 5],) if algo == "shortest_paths" else ()
        want = np.asarray(getattr(jg, algo)(J, *args))
        got = getattr(tg, algo)(T, *args)
        assert isinstance(got, torch.Tensor)
        assert got.dtype == {"shortest_paths": torch.float32}.get(
            algo, torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_label_ties_go_to_the_smallest_label(self):
        _, T = _pair("path_ties")
        # one step: every inner vertex sees two labels once each
        lab = tg.label_propagation(T, max_iterations=1).numpy()
        np.testing.assert_array_equal(lab, [1, 0, 1, 2, 3, 5])

    @pytest.mark.parametrize("strategy", [
        "edge_1d", "edge_2d", "random_vertex_cut",
        "canonical_random_vertex_cut"])
    @pytest.mark.parametrize("p", [1, 5, 8, 13])
    def test_partition_edges_bit_equal(self, strategy, p):
        rs = np.random.default_rng(9)
        # ids up to int32's top, where the uint32 products wrap
        e = rs.integers(0, 2**31 - 1, size=(3_000, 2)).astype(np.int32)
        J = jg.Graph(e[:, 0], e[:, 1], 2**31 - 1)
        T = tg.Graph(e[:, 0], e[:, 1], 2**31 - 1, device=CPU)
        want = np.asarray(jg.partition_edges(J, p, strategy))
        got = tg.partition_edges(T, p, strategy)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture()
def jax_iterations(monkeypatch):
    """The JAX package's Pregel supersteps, counted by a debug callback in
    each vertex program its algorithms pass to ``pregel``."""
    count = []
    real = j_alg.pregel

    def counted(graph, init, vprog, send_msg, **kw):
        def vp(attr, agg):
            jax.debug.callback(lambda: count.append(1))
            return vprog(attr, agg)

        return real(graph, init, vp, send_msg, **kw)

    monkeypatch.setattr(j_alg, "pregel", counted)

    def read():
        jax.effects_barrier()
        n = len(count)
        count.clear()
        return n

    return read


class TestAcrossPageRank:
    port_modules = False

    @pytest.mark.parametrize("graph", sorted(GRAPHS))
    @pytest.mark.parametrize("kw", [
        {}, {"num_iterations": 200, "tol": 1e-5}, {"alpha": 0.6,
                                                   "num_iterations": 7}])
    def test_pagerank_within_1e6_with_equal_iterations(
            self, jax_iterations, graph, kw):
        J, T = _pair(graph)
        want = np.asarray(jg.pagerank(J, **kw))
        j_iters = jax_iterations()
        got = tg.pagerank(T, **kw).numpy()
        assert tg.pregel.last_iterations == j_iters
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert abs(float(got.astype(np.float64).sum()) - 1.0) < 1e-5

    @pytest.mark.parametrize("source", [0, 3])
    def test_personalized_pagerank(self, jax_iterations, source):
        J, T = _pair("random_80")
        want = np.asarray(jg.personalized_pagerank(J, source,
                                                   num_iterations=40,
                                                   tol=1e-6))
        j_iters = jax_iterations()
        got = tg.personalized_pagerank(T, source, num_iterations=40,
                                       tol=1e-6).numpy()
        assert tg.pregel.last_iterations == j_iters
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_connected_components_iterations(self, jax_iterations):
        J, T = _pair("sparse_120")
        jg.connected_components(J)
        j_iters = jax_iterations()
        tg.connected_components(T)
        assert tg.pregel.last_iterations == j_iters > 1


def _ratings(seed=5, users=30, items=25):
    rs = np.random.default_rng(seed)
    u, i, r = [], [], []
    for a in range(users):
        for b in range(items):
            if rs.random() < 0.4:
                u.append(a)
                i.append(b)
                r.append((4.5 if (a < users // 2) == (b < items // 2)
                          else 1.5) + 0.2 * rs.normal())
    return np.asarray(u), np.asarray(i), np.asarray(r, np.float32)


class TestAcrossSVDPlusPlus:
    port_modules = False

    def test_trained_from_the_same_draws_within_1e4(self):
        users, items, ratings = _ratings()
        rank, seed, iters = 4, 3, 120
        nu, ni = int(users.max()) + 1, int(items.max()) + 1
        # the JAX package's own draws (graph/algorithms.py:277-282)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        scale = 1.0 / jnp.sqrt(rank)
        P0, Q0, Y0 = (
            np.asarray(jax.random.normal(k, (rows, rank), jnp.float32)
                       * scale * 0.1)
            for k, rows in ((k1, nu), (k2, ni), (k3, ni)))
        want = jg.svd_plus_plus(users, items, ratings, rank=rank,
                                num_iterations=iters, seed=seed)
        got = t_alg._train_svd_plus_plus(
            users, items, ratings, torch.from_numpy(P0),
            torch.from_numpy(Q0), torch.from_numpy(Y0), iters, 0.5, 0.015)
        for f in ("user_vectors", "item_vectors", "user_bias", "item_bias"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=1e-4, err_msg=f)
        assert got.mean == pytest.approx(want.mean, abs=1e-6)
        np.testing.assert_allclose(got.predict(users, items),
                                   want.predict(users, items), atol=1e-4)
        assert got.loss_history[-1] < got.loss_history[0]

    def test_public_function_draws_on_the_entry_device(self):
        users, items, ratings = _ratings()
        a = tg.svd_plus_plus(users, items, ratings, rank=3,
                             num_iterations=30, seed=1, device=CPU)
        b = tg.svd_plus_plus(users, items, ratings, rank=3,
                             num_iterations=30, seed=1, device=CPU)
        np.testing.assert_array_equal(a.user_vectors, b.user_vectors)
        assert a.loss_history.shape == (31,)
        with pytest.raises(ValueError, match="user ids"):
            tg.svd_plus_plus(users, items, ratings, num_users=2, device=CPU)


class TestAcrossCarry:
    port_modules = False

    def test_graph_both_ways(self):
        J = jg.Graph.from_edge_ids(
            np.array([100, 7, 2**40]), np.array([7, 2**40, 100]),
            vertex_attr_by_id={100: 1.0, 7: 2.0, 2**40: 3.0},
            edge_attr=np.array([0.5, 1.5, 2.5], np.float32))
        T = convert.graph_from_reference(J, device=CPU)
        assert T.src.dtype == torch.int32
        np.testing.assert_array_equal(T.src.numpy(), np.asarray(J.src))
        np.testing.assert_array_equal(T.original_ids(), J.original_ids())
        np.testing.assert_array_equal(T.vertex_attr.numpy(),
                                      np.asarray(J.vertex_attr))
        np.testing.assert_allclose(tg.pagerank(T).numpy(),
                                   np.asarray(jg.pagerank(J)), atol=1e-6)
        kwargs, ids = convert.graph_to_reference(T)
        back = jg.Graph(**kwargs)
        np.testing.assert_array_equal(np.asarray(back.dst),
                                      np.asarray(J.dst))
        np.testing.assert_array_equal(np.asarray(back.edge_attr),
                                      np.asarray(J.edge_attr))
        np.testing.assert_array_equal(ids, J.original_ids())

    def test_svdpp_model_both_ways(self):
        users, items, ratings = _ratings(seed=6)
        jm = jg.svd_plus_plus(users, items, ratings, rank=2,
                              num_iterations=10)
        tm = convert.fitted_model_from_reference(jm, device=CPU)
        assert isinstance(tm, t_alg.SVDPlusPlusModel)
        np.testing.assert_array_equal(tm.predict(users, items),
                                      jm.predict(users, items))
        back = j_persistence._model_restore(
            convert.fitted_model_to_reference(tm))
        assert isinstance(back, j_alg.SVDPlusPlusModel)
        np.testing.assert_array_equal(back.predict(users, items),
                                      jm.predict(users, items))
        assert t_persistence.model_payload(tm).keys() == \
            convert.fitted_model_to_reference(tm).keys()
