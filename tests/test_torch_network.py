"""The port's ``Network`` facade (``models/network.py``) against the JAX
package's, on the CPU.

The JAX facade's weights are carried across through
``utils.checkpoint.mps_from_numpy`` (the two packages draw from different
generators), in float64. Then:

* ``forward``, ``apply_act_func``, ``compute_loss_derivate``, ``accuracy``,
  ``tensor_svd`` (through the gauge-invariant product of its factors) and
  ``compute_L2_reg`` within 1e-10;
* ``sweep`` as ``tests/test_torch_sweep.py`` holds the sweep it wraps: a
  right and a left float64 sweep with the exact split, each from the JAX
  model carried across, within 1e-8, with the per-step series it appends
  to ``var_hist``; ``train`` (canonical split) the same way on two small
  epochs;
* ``save`` and ``load`` through the ``.npz`` files both packages read, in
  both directions, exactly.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.network import Network
from tensornetworkforml_torch.tensor import Tensor, contract
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

TOL = 1e-10
SWEEP_TOL = 1e-8  # float64 sweeps with the exact split (test_torch_sweep.py)
N, M, L = 8, 5, 3


def _jax_net(act_fn="softmax", loss_fn="full_cross_ent", l_pos=0, seed=3):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.network import Network as JNet
    from tensornetworkforml_tpu.ops.embedding import psi_embed

    phi = np.asarray(psi_embed(jnp.asarray(np.random.default_rng(seed).random((16, N)))))
    j = JNet(N=N, M=M, L=L, normalize=True, calibration_X=phi, act_fn=act_fn,
             loss_fn=loss_fn, dtype=jnp.float64, seed=seed)
    if l_pos:
        j.mps = j.mps.replace(l_pos=l_pos)
    return j


def _carry(j):
    net = Network.__new__(Network)
    m = j.mps
    net.mps = mps_from_numpy(np.asarray(m.sites), np.asarray(m.label_site), l_pos=m.l_pos,
                             act_fn=m.act_fn, loss_fn=m.loss_fn, T=m.T, device="cpu")
    return net


def _close(got, want, tol=TOL):
    got = got.elem if isinstance(got, Tensor) else got
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want.elem if hasattr(want, "elem") else want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _data(B=12, seed=5):
    rng = np.random.default_rng(seed)
    return rng.random((B, N)), rng.integers(0, L, B)


@pytest.mark.parametrize("act_fn,loss_fn", [("softmax", "full_cross_ent"),
                                            ("sigmoid", "cross_entropy"),
                                            ("linear", "MSE")])
def test_inference_methods_match_jax(act_fn, loss_fn):
    from tensornetworkforml_tpu.ops.embedding import psi_embed

    j = _jax_net(act_fn, loss_fn)
    t = _carry(j)
    x, y = _data()
    assert (t.N, t.M, t.D, t.L, t.T, t.act_fn, t.loss_fn, t.l_pos) == (
        j.N, j.M, j.D, j.L, j.T, j.act_fn, j.loss_fn, j.l_pos)
    for a, b in zip(t.As, j.As):
        np.testing.assert_array_equal(a, b)
    for X in (x, np.asarray(psi_embed(x)), torch.as_tensor(x)):  # raw, embedded, a tensor
        f, jf = t.forward(X), j.forward(np.asarray(X))
        assert list(f.axes_names) == ["l", "b"] and f.elem.dtype == torch.float64
        _close(f, jf)
    fa, jfa = t.apply_act_func(f), j.apply_act_func(jf)
    _close(fa, jfa)
    y1h = np.eye(L)[y].T
    _close(t.compute_loss_derivate(fa, y1h), j.compute_loss_derivate(jfa, y1h))
    assert t.accuracy(x, y) == j.accuracy(x, y)
    assert t.accuracy(x, y, f) == j.accuracy(x, y, jf)


@pytest.mark.parametrize("l_pos,left_dir", [(2, False), (3, True), (0, False), (7, True)])
def test_tensor_svd_matches_jax(l_pos, left_dir):
    from tensornetworkforml_tpu.tensor import Tensor as JTensor
    from tensornetworkforml_tpu.tensor import contract as jcontract

    j = _jax_net(l_pos=l_pos)
    t = _carry(j)
    D = 2
    elem = np.random.default_rng(l_pos).standard_normal((M, D, D, L, M))
    names = ["left", "da", "db", "l", "right"]
    T = Tensor(elem=elem.copy(), axes_names=names, device="cpu")
    JT = JTensor(elem=elem.copy(), axes_names=names)
    for x in (T, JT):
        x.aggregate(axes_names=["da", "left"], new_ax_name="i")
        x.aggregate(axes_names=["db", "right", "l"], new_ax_name="j")
        x.transpose(["i", "j"])
    U, V = t.tensor_svd(T, left_dir=left_dir)
    JU, JV = j.tensor_svd(JT, left_dir=left_dir)
    for a, b in ((U, JU), (V, JV)):
        assert list(a.axes_names) == list(b.axes_names) and a.shape == tuple(b.shape)
    # the factors are gauge-dependent; their product is not
    _close(contract(U, V, "right", "left"), jcontract(JU, JV, "right", "left"))
    with pytest.raises(ValueError):
        t.tensor_svd(Tensor(elem=elem, axes_names=names, device="cpu"))


@pytest.mark.parametrize("l_pos,left_dir", [(0, False), (2, False), (4, True), (7, True)])
def test_compute_L2_reg_matches_jax(l_pos, left_dir):
    from tensornetworkforml_tpu.tensor import Tensor as JTensor

    j = _jax_net(l_pos=l_pos)
    t = _carry(j)
    rng = np.random.default_rng(10 + l_pos)
    names = ["left", "d0", "d1", "l", "right"]
    shape = [M, 2, 2, L, M]
    if l_pos - int(left_dir) == 0:  # the pair at the left chain end has no left bond
        names, shape = names[1:], shape[1:]
    if l_pos + 1 - int(left_dir) == N - 1:  # ... at the right end no right bond
        names, shape = names[:-1], shape[:-1]
    elem = rng.standard_normal(shape) * 0.3
    loss, deriv = t.compute_L2_reg(Tensor(elem=elem, axes_names=names, device="cpu"),
                                   0.01, left_dir)
    jloss, jderiv = j.compute_L2_reg(JTensor(elem=elem, axes_names=names), 0.01, left_dir)
    assert abs(loss - jloss) <= TOL * max(1.0, abs(jloss))
    assert list(deriv.axes_names) == names
    _close(deriv, jderiv)


def test_sweep_right_then_left_matches_jax():
    """The facade's sweep: f_final, the swept model on fresh inputs and the
    series appended to var_hist, both directions."""
    j = _jax_net()
    x, y = _data(B=16)
    fresh = np.random.default_rng(9).random((6, N))
    for left_dir in (False, True):
        # each sweep from the JAX model carried across (the sweeps' split
        # factors are gauge-dependent, so two chained sweeps part at the
        # gauge's degenerate directions; the function is what is held)
        t = _carry(j)
        hist, jhist = [[], []], [[], []]
        f = t.sweep(x, y, None, 0.05, 1e-3, left_dir=left_dir, var_hist=hist)
        jf = j.sweep(x, y, None, 0.05, 1e-3, left_dir=left_dir, var_hist=jhist)
        assert t.l_pos == j.l_pos == (0 if left_dir else N - 1)
        _close(f, jf, SWEEP_TOL)
        _close(t.forward(fresh), j.forward(fresh), SWEEP_TOL)
        for a, b in zip(hist, jhist):
            assert len(a) == len(b) == N - 1
            _close(np.array(a), np.array(b), SWEEP_TOL)
    t = _carry(j)
    hist, jhist = [[] for _ in range(7)], [[] for _ in range(7)]
    y1h = np.eye(L)[y].T  # one-hot labels, debug series
    t.sweep(x, y1h, None, 0.05, 1e-3, var_hist=hist, debug=True)
    j.sweep(x, y1h, None, 0.05, 1e-3, var_hist=jhist, debug=True)
    for a, b in zip(hist, jhist):
        _close(np.array(a), np.array(b), SWEEP_TOL)
    assert t.l_pos == N - 1
    with pytest.raises(ValueError, match="direction"):
        t.sweep(x, y, None, 0.05, 1e-3, left_dir=False)


def test_train_matches_jax():
    from tensornetworkforml_tpu.data.loader import prepare_dataset as jprep
    from tensornetworkforml_torch.data.loader import prepare_dataset

    j = _jax_net(act_fn="linear", loss_fn="MSE")
    t = _carry(j)
    x, y = _data(B=96)
    args = (x, y, 1.0, 0.25, 24, 24, 24)
    kw = dict(lr=0.05, n_epochs=2, weight_dec=1e-3, L2_flag=False, split_mode="canonical",
              verbose=False)
    val, hist = t.train(*prepare_dataset(*args, embed=False, seed=2)[:2], **kw)
    jval, jhist = j.train(*jprep(*args, embed=False, seed=2)[:2], **kw)
    assert val == pytest.approx(jval, abs=1e-12)
    assert hist.shape == np.asarray(jhist).shape
    _close(hist, jhist, SWEEP_TOL)
    _close(t.forward(x), j.forward(x), SWEEP_TOL)


def test_constructor_draws_from_the_seed_and_calibrates():
    from tensornetworkforml_torch.ops.embedding import psi_embed

    phi = psi_embed(torch.as_tensor(np.random.default_rng(0).random((16, N))))
    kw = dict(N=N, M=M, L=L, normalize=True, calibration_X=phi.numpy(), act_fn="softmax",
              loss_fn="full_cross_ent", dtype=torch.float64, device="cpu")
    a, b = Network(seed=4, **kw), Network(seed=4, **kw)
    assert torch.equal(a.mps.sites, b.mps.sites) and a.device.type == "cpu"
    assert not torch.equal(a.mps.sites, Network(seed=5, **kw).mps.sites)
    # calibrated: the un-activated output is O(1) on the calibration batch
    assert abs(float(a.forward(phi.numpy()).elem.abs().max()) - 1.0) < 1e-9
    # seed=None draws the seed from np.random, as the JAX facade does
    np.random.seed(11)
    c = Network(**kw)
    np.random.seed(11)
    assert torch.equal(c.mps.sites, Network(**kw).mps.sites)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Network(N=N, M=M, L=L, seed=0)


def test_save_and_load_both_ways(tmp_path):
    from tensornetworkforml_tpu.models.network import Network as JNet

    j = _jax_net()
    t = _carry(j)
    j.save(str(tmp_path / "jax.npz"))
    got = Network.load(str(tmp_path / "jax.npz"), device="cpu")
    for name in ("sites", "label_site"):
        np.testing.assert_array_equal(getattr(got.mps, name).numpy(), np.asarray(getattr(j.mps, name)))
    assert (got.l_pos, got.act_fn, got.loss_fn, got.T) == (j.l_pos, j.act_fn, j.loss_fn, j.T)
    t.save(str(tmp_path / "port.npz"))
    back = JNet.load(str(tmp_path / "port.npz"))
    for name in ("sites", "label_site"):
        np.testing.assert_array_equal(np.asarray(getattr(back.mps, name)),
                                      getattr(t.mps, name).numpy())
    f32 = Network.load(str(tmp_path / "jax.npz"), dtype=torch.float32, device="cpu")
    assert f32.mps.dtype == torch.float32
    # a reference .dat pickle the JAX package wrote: the JAX Network.load's
    # arrays and settings, float64 unless asked
    from tensornetworkforml_tpu.utils.checkpoint import save_reference_pickle

    save_reference_pickle(j.mps, str(tmp_path / "model.dat"))
    dat = Network.load(str(tmp_path / "model.dat"), device="cpu")
    jdat = JNet.load(str(tmp_path / "model.dat"))
    assert dat.mps.dtype == torch.float64
    for name in ("sites", "label_site"):
        np.testing.assert_array_equal(getattr(dat.mps, name).numpy(),
                                      np.asarray(getattr(jdat.mps, name)))
    assert (dat.l_pos, dat.act_fn, dat.loss_fn, dat.T) == (jdat.l_pos, jdat.act_fn,
                                                           jdat.loss_fn, jdat.T)
    assert Network.load(str(tmp_path / "model.dat"), dtype=torch.float32,
                        device="cpu").mps.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Network.load(str(tmp_path / "jax.npz"))
