"""The port's BLAS surface and collectives against the JAX package's.

Twins of ``tests/test_ops.py``'s ``TestBlas`` and ``TestCollectives`` on
``asyncframework_tpu_torch.ops.{blas,collectives}``, where a tensor takes
the place of a jax array, then the two packages on the same inputs, and
the fold order of ``psum_over_mesh`` (rank order onto the group's first
rank, one group per coordinate of the other axes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asyncframework_tpu.ops import blas as jblas
from asyncframework_tpu.ops import collectives as jcoll
from asyncframework_tpu.ops import gradients as jgrad
from asyncframework_tpu.parallel import make_mesh as jmake_mesh
from asyncframework_tpu.parallel import shard_batch as jshard_batch
from asyncframework_tpu_torch.ops import blas, collectives, gradients
from asyncframework_tpu_torch.parallel import make_mesh, shard_batch

CPU = torch.device("cpu")


class TestBlas:
    def test_axpy_inplace(self):
        y = np.array([1.0, 2.0, 3.0])
        x = np.array([1.0, 1.0, 1.0])
        out = blas.axpy_op(2.0, x, y)
        assert out is y  # in place, like BLASUtil.axpyOp
        np.testing.assert_allclose(y, [3.0, 4.0, 5.0])

    def test_axpy_unit_scale(self):
        y = np.ones(4)
        out = blas.axpy_op(1.0, np.arange(4.0), y)
        np.testing.assert_allclose(out, [1, 2, 3, 4])

    def test_dot_scal(self):
        x = np.array([1.0, 2.0])
        assert blas.dot_op(x, x) == pytest.approx(5.0)
        out = blas.scal_op(0.5, x)
        assert out is x
        np.testing.assert_allclose(x, [0.5, 1.0])

    def test_readonly_buffers_fall_back_out_of_place(self):
        g = np.arange(4.0)
        g.flags.writeable = False
        out = blas.scal_op(2.0, g)
        np.testing.assert_allclose(out, [0, 2, 4, 6])
        w = np.ones(4)
        w.flags.writeable = False
        out2 = blas.axpy_op(0.5, g, w)
        np.testing.assert_allclose(out2, [1, 1.5, 2, 2.5])

    def test_tensors_supported_and_never_written(self):
        """A tensor takes a jax array's place: a new tensor back, the old
        one (an old model version) untouched."""
        y = torch.ones(3)
        out = blas.axpy_op(2.0, torch.arange(3.0), y)
        assert out is not y
        np.testing.assert_allclose(out.numpy(), [1, 3, 5])
        np.testing.assert_allclose(y.numpy(), [1, 1, 1])
        x = torch.tensor([1.0, 2.0])
        assert blas.dot_op(x, x) == pytest.approx(5.0)
        assert isinstance(blas.dot_op(x, x), float)
        s = blas.scal_op(0.5, x)
        assert s is not x and x.tolist() == [1.0, 2.0]
        # a tensor into a host buffer: read back and added in place
        yh = np.ones(2, np.float32)
        assert blas.axpy_op(1.0, x, yh) is yh
        np.testing.assert_allclose(yh, [2.0, 3.0])

    @pytest.mark.parametrize("op", ["axpy", "dot", "scal"])
    def test_same_values_as_the_jax_package(self, op):
        rs = np.random.default_rng(1)
        x = rs.normal(size=7).astype(np.float32)
        y = rs.normal(size=7).astype(np.float32)
        if op == "axpy":
            got = blas.axpy_op(0.3, torch.from_numpy(x), torch.from_numpy(y))
            want = jblas.axpy_op(0.3, jnp.asarray(x), jnp.asarray(y))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
        elif op == "dot":
            assert blas.dot_op(torch.from_numpy(x), torch.from_numpy(y)) \
                == pytest.approx(jblas.dot_op(jnp.asarray(x),
                                              jnp.asarray(y)), rel=1e-5)
        else:
            got = blas.scal_op(-2.5, torch.from_numpy(x))
            want = jblas.scal_op(-2.5, jnp.asarray(x))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestCollectives:
    def test_tree_combine_matches_fold(self):
        xs = [np.full(3, float(i)) for i in range(9)]
        out = collectives.tree_combine(xs, lambda a, b: a + b)
        np.testing.assert_allclose(out, np.full(3, sum(range(9))))

    def test_tree_combine_empty_raises(self):
        with pytest.raises(ValueError):
            collectives.tree_combine([], lambda a, b: a + b)

    @pytest.mark.parametrize("n", [1, 2, 5, 8])
    def test_tree_combine_same_topology_as_the_jax_package(self, n):
        """The pairing is the reference's: a non-commutative op shows the
        combine tree."""
        xs = [str(i) for i in range(n)]

        def op(a, b):
            return f"({a}+{b})"

        assert collectives.tree_combine(xs, op) == jcoll.tree_combine(xs, op)

    def test_data_parallel_grad_matches_single_device_and_jax(
            self, devices8, tiny_problem):
        X, y, _ = tiny_problem
        mesh = make_mesh(8, devices=[CPU] * 8)
        w = np.full(X.shape[1], 0.2, np.float32)
        mask = np.ones(X.shape[0], np.float32)
        fn = collectives.data_parallel_grad_fn(
            gradients.least_squares_grad_sum, mesh)
        Xs, ys, ms = shard_batch(mesh, X, y, mask)
        g = fn(Xs, ys, torch.from_numpy(w), ms)
        expected = X.T @ (X @ w - y)
        np.testing.assert_allclose(g.numpy(), expected, rtol=2e-4, atol=1e-2)
        jmesh = jmake_mesh(8, devices=devices8)
        jfn = jcoll.data_parallel_grad_fn(jgrad.least_squares_grad_sum,
                                          jmesh)
        jg = jfn(*jshard_batch(jmesh, X, y), jnp.asarray(w),
                 jshard_batch(jmesh, mask))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=5e-5,
                                   atol=5e-4)

    def test_psum_folds_in_rank_order(self):
        """Each group's total is its members' partials added in rank
        order, on the first member's tensor; the members share it."""
        rs = np.random.default_rng(2)
        parts = [torch.from_numpy(rs.normal(size=5).astype(np.float32))
                 for _ in range(8)]
        mesh = make_mesh(8, devices=[CPU] * 8)
        out = collectives.psum_over_mesh(parts, mesh)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        assert torch.equal(out[0], acc) and all(o is out[0] for o in out)
        m2 = make_mesh(8, axis_names=("dp", "md"), axis_sizes=(4, 2),
                       devices=[CPU] * 8)
        by_dp = collectives.psum_over_mesh(parts, m2, "dp")
        for j in range(2):
            want = parts[j]
            for i in range(1, 4):
                want = want + parts[2 * i + j]
            assert all(torch.equal(by_dp[2 * i + j], want) for i in range(4))
        by_md = collectives.psum_over_mesh(parts, m2, "md")
        for i in range(4):
            assert torch.equal(by_md[2 * i], parts[2 * i] + parts[2 * i + 1])
        with pytest.raises(ValueError, match="no axis"):
            collectives.psum_over_mesh(parts, mesh, "md")
        with pytest.raises(ValueError, match="partials"):
            collectives.psum_over_mesh(parts[:3], mesh)
