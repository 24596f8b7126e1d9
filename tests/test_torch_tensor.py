"""The port's named-axis ``Tensor``, ``contract`` and ``partial_trace``
(``tensor.py``) against the JAX package's, on the CPU.

Every case of ``tests/test_tensor.py``, with the same float64 inputs through
both packages: names and shapes equal, elements within 1e-12 (einsums in
another summation order; the reshapes and permutations are exact).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_tpu import tensor as jt
from tensornetworkforml_torch import tensor as tt

TOL = 1e-12


def _both(elem, names):
    return (tt.Tensor(elem=elem.copy(), axes_names=list(names), device="cpu"),
            jt.Tensor(elem=elem.copy(), axes_names=list(names)))


def _same(got, want):
    assert list(got.axes_names) == list(want.axes_names)
    assert got.shape == tuple(want.shape)
    assert isinstance(got.elem, torch.Tensor) and got.elem.dtype == torch.float64
    np.testing.assert_allclose(got.elem.numpy(), np.asarray(want.elem), rtol=0, atol=TOL)
    assert got.aggregations == want.aggregations


def test_init_and_names():
    rng = np.random.default_rng(1)
    t, j = _both(rng.random((2, 3, 4)), ["a", "b", "c"])
    _same(t, j)
    assert t.rank == j.rank == 3
    assert t.ax_to_index("b") == j.ax_to_index("b") == 1
    assert t.ax_to_index(["c", "a"]) == j.ax_to_index(["c", "a"]) == [2, 0]
    assert t.ax_to_index(2) == 2
    with pytest.raises(KeyError):
        t.ax_to_index("z")
    with pytest.raises(ValueError):
        tt.Tensor(elem=rng.random((2, 3)), axes_names=["a"], device="cpu")
    with pytest.raises(ValueError):
        tt.Tensor()
    # a torch tensor stays where it is; numpy input goes to the device asked
    e = torch.ones(2, 2, dtype=torch.float64)
    assert tt.Tensor(elem=e, axes_names=["a", "b"]).elem is e
    assert repr(t) == "Tensor(shape=(2, 3, 4), axes=['a', 'b', 'c'])"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.Tensor(elem=np.ones(3), axes_names=["a"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.Tensor(shape=[2], axes_names=["a"])


def test_random_init_scale():
    t = tt.Tensor(shape=[50, 50], axes_names=["a", "b"], scale=10.0, device="cpu")
    e = t.elem.numpy()
    assert t.elem.dtype == torch.float32
    assert e.min() >= 0.0 and e.max() <= 0.1 and e.std() > 0.02
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tt.Tensor(shape=[4, 5], generator=g(), dtype=torch.float64, device="cpu")
    b = tt.Tensor(shape=[4, 5], generator=g(), dtype=torch.float64, device="cpu")
    assert torch.equal(a.elem, b.elem) and a.axes_names is None


def test_transpose_by_name():
    t, j = _both(np.random.default_rng(1).random((2, 3, 4)), ["a", "b", "c"])
    assert t.transpose(["c", "a", "b"]) is t
    j.transpose(["c", "a", "b"])
    _same(t, j)
    assert t.shape == (4, 2, 3)


def test_aggregate_disaggregate_roundtrip():
    e = np.random.default_rng(1).random((2, 3, 4, 5))
    t, j = _both(e, ["a", "b", "c", "d"])
    t.aggregate(axes_names=["c", "a"], new_ax_name="x")
    j.aggregate(axes_names=["c", "a"], new_ax_name="x")
    _same(t, j)
    assert t.shape == (8, 3, 5) and t.aggregations["x"] == {"c": 4, "a": 2}
    t.disaggregate("x")
    j.disaggregate("x")
    _same(t, j)
    np.testing.assert_array_equal(t.elem.numpy(), e.transpose(2, 0, 1, 3))
    # all axes at once, and the errors
    t2, j2 = _both(e, ["a", "b", "c", "d"])
    _same(t2.aggregate(new_ax_name="all"), j2.aggregate(new_ax_name="all"))
    for bad in (dict(axes_names=["a"]), dict(axes_names=["z"], new_ax_name="x")):
        with pytest.raises((ValueError, KeyError)):
            tt.Tensor(elem=e, axes_names=["a", "b", "c", "d"], device="cpu").aggregate(**bad)
    with pytest.raises(ValueError):
        tt.Tensor(elem=e, device="cpu").aggregate(new_ax_name="x")
    with pytest.raises(KeyError):
        t.disaggregate("b")
    with pytest.raises(KeyError):
        t.disaggregate("z")


def test_add_sub_align_axes():
    rng = np.random.default_rng(1)
    e1, e2 = rng.random((2, 3)), rng.random((3, 2))
    t1, j1 = _both(e1, ["a", "b"])
    t2, j2 = _both(e2, ["b", "a"])
    _same(t1 + t2, j1 + j2)
    _same(t1 - t2, j1 - j2)
    np.testing.assert_allclose((t1 + t2).elem.numpy(), e1 + e2.T, rtol=0, atol=TOL)
    c, jc = t1.copy(), j1.copy()
    c += t2
    jc += j2
    _same(c, jc)
    c -= t2
    jc -= j2
    _same(c, jc)
    _same(t1, j1)  # the copies left the originals alone
    with pytest.raises(ValueError):
        t1 + tt.Tensor(elem=e1, axes_names=["a", "z"], device="cpu")


def _contract_both(e1, n1, e2, n2, *args, **kw):
    t1, j1 = _both(e1, n1)
    t2, j2 = _both(e2, n2)
    if args and callable(args[0]):  # positional axes computed from each tensor
        targs, jargs = args[0](t1, t2), args[0](j1, j2)
    else:
        targs = jargs = args
    return tt.contract(t1, t2, *targs, **kw), jt.contract(j1, j2, *jargs, **kw)


def test_contract_single_axis():
    rng = np.random.default_rng(2)
    e1, e2 = rng.random((2, 3, 4)), rng.random((4, 5))
    got, want = _contract_both(e1, ["a", "b", "c"], e2, ["c", "e"], contracted="c")
    _same(got, want)
    assert list(got.axes_names) == ["a", "b", "e"]
    np.testing.assert_allclose(got.elem.numpy(), np.einsum("abc,ce->abe", e1, e2),
                               rtol=0, atol=TOL)


def test_contract_with_common_batch_axis():
    rng = np.random.default_rng(3)
    e1, e2 = rng.random((7, 3, 4)), rng.random((7, 4, 5))
    got, want = _contract_both(e1, ["b", "l", "right"], e2, ["b", "left", "r2"],
                               "right", "left", common="b")
    _same(got, want)
    assert list(got.axes_names) == ["l", "r2", "b"]


def test_contract_outer_product_with_common():
    rng = np.random.default_rng(4)
    e1, e2 = rng.random((7, 2)), rng.random((7, 3))
    got, want = _contract_both(e1, ["b", "d0"], e2, ["b", "d1"], common="b")
    _same(got, want)
    assert list(got.axes_names) == ["d0", "d1", "b"]


def test_contract_multi_axis_positional():
    rng = np.random.default_rng(5)
    e1, e2 = rng.random((3, 4, 5)), rng.random((4, 5, 6))
    got, want = _contract_both(
        e1, ["x", "right", "R_2"], e2, ["left", "L_2", "y"],
        lambda a, b: (a.ax_to_index(["right", "R_2"]), b.ax_to_index(["left", "L_2"])))
    _same(got, want)
    assert list(got.axes_names) == ["x", "y"]


def test_contract_common_axes_by_side_and_shape_errors():
    rng = np.random.default_rng(6)
    e1, e2 = rng.random((3, 4, 2)), rng.random((2, 4, 5))
    got, want = _contract_both(e1, ["i", "k", "b"], e2, ["c", "k2", "j"],
                               contracted_axis1="k", contracted_axis2="k2",
                               common_axis1="b", common_axis2="c")
    _same(got, want)
    t1, _ = _both(e1, ["i", "k", "b"])
    t2, _ = _both(e2, ["c", "k2", "j"])
    for kw in (dict(contracted_axis1="i", contracted_axis2="k2"),
               dict(contracted_axis1=["i", "k"], contracted_axis2="k2"),
               dict(common_axis1="i", common_axis2="j"),
               dict(common_axis1=["i", "k"], common_axis2="j")):
        with pytest.raises(ValueError):
            tt.contract(t1, t2, **kw)


def test_partial_trace():
    e = np.random.default_rng(7).random((4, 3, 4))
    t, j = _both(e, ["p", "m", "q"])
    got = tt.partial_trace(t, "p", "q")
    _same(got, jt.partial_trace(j, "p", "q"))
    np.testing.assert_allclose(got.elem.numpy(), np.einsum("ama->m", e), rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        tt.partial_trace(t, "p", "m")


def test_contract_matches_reference(reference_modules):
    """The reference's own ``contract``, where it is mounted."""
    ref = reference_modules["linalg"]
    RefTensor = reference_modules["Tensor"].Tensor
    rng = np.random.default_rng(8)
    e1, e2 = rng.random((6, 3, 4)), rng.random((6, 4, 5))
    ours = tt.contract(tt.Tensor(elem=e1, axes_names=["b", "l", "right"], device="cpu"),
                       tt.Tensor(elem=e2, axes_names=["b", "left", "r2"], device="cpu"),
                       "right", "left", common="b")
    theirs = ref.contract(RefTensor(elem=e1.copy(), axes_names=["b", "l", "right"]),
                          RefTensor(elem=e2.copy(), axes_names=["b", "left", "r2"]),
                          "right", "left", common="b")
    assert list(ours.axes_names) == list(theirs.axes_names)
    np.testing.assert_allclose(ours.elem.numpy(), theirs.elem, rtol=1e-10, atol=1e-12)
