"""The reference's ``.dat`` pickles in the port (``utils/checkpoint.py``)
against the JAX package's, on the CPU in float64.

* A ``.dat`` the JAX package writes loads in the port, and one the port
  writes loads in the JAX package, with the same forward (rtol 1e-12), with
  the label at site 0, in the middle and at N-1, and for a model whose bonds
  a sweep truncated (the reference's rank recurrence).
* Both packages write the same bytes for the same model: the pickle names
  only the module and the class of its stubs.
* ``mps_from_reference_net`` on a stub net with ragged bonds and permuted
  axis names gives the JAX function's arrays exactly.
* ``_RefUnpickler`` maps the six names of ``_SUBSTITUTE`` (the JAX set).
* The two packages share the stub modules' names (``Network_class``,
  ``Tensor_class``): each save uses whatever class ``sys.modules`` holds
  under them, so both saves work in one process in either order.
* ``Predictor.from_checkpoint`` serves a ``.dat`` as the JAX ``Predictor``
  does (its float32 tolerance, rtol 1e-4 and atol 1e-6).
"""

import contextlib
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.utils import checkpoint as ckpt

N, M, L = 8, 4, 3
RTOL = 1e-12
STUB_MODULES = ("Network_class", "Tensor_class")


def _jax_model(l_pos=0, seed=0):
    """A JAX float64 MPS with its label at ``l_pos`` (O(1) outputs)."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import MPS

    rng = np.random.default_rng(seed)
    sites = rng.random((N, M, 2, M)) / (0.64 * M)
    sites[0, 1:] = 0.0  # the chain's open ends: one-hot boundary rows
    sites[N - 1, :, :, 1:] = 0.0
    label = rng.random((M, 2, L, M)) / (0.64 * M)
    if l_pos == 0:
        label[1:] = 0.0
    if l_pos == N - 1:
        label[..., 1:] = 0.0
    return MPS(sites=jnp.asarray(sites), label_site=jnp.asarray(label), l_pos=l_pos,
               act_fn="softmax", loss_fn="full_cross_ent", T=0.1)


def _swept_model():
    """The JAX test's reference-recurrence sweep (``rank_mode='reference'``):
    bonds truncated below M, label moved to N-1."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi
    from tensornetworkforml_tpu.train.sweep import SweepConfig, sweep_once

    mps = _jax_model(0, seed=1)
    rng = np.random.default_rng(2)
    phi = jpsi(jnp.asarray(rng.random((16, N))))
    y = jax.nn.one_hot(jnp.asarray(rng.integers(0, L, 16)), L, dtype=jnp.float64).T
    cfg = SweepConfig(act_fn=mps.act_fn, loss_fn=mps.loss_fn, rank_mode="reference")
    out = sweep_once(mps, phi, y, 0.01, 0.1, cfg)[0]
    assert out.l_pos == N - 1
    return out


MODELS = {"l_pos=0": lambda: _jax_model(0), "l_pos=3": lambda: _jax_model(3),
          f"l_pos={N - 1}": lambda: _jax_model(N - 1), "swept": _swept_model}


def _probe():
    return np.random.default_rng(9).random((12, N))


def _port_fwd(mps):
    return mps_forward(mps, psi_embed(torch.as_tensor(_probe()))).numpy()


def _jax_fwd(mps):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfwd
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    return np.asarray(jfwd(mps, jpsi(jnp.asarray(_probe()))))


def _port_copy(j):
    return ckpt.mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                               act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device="cpu")


@contextlib.contextmanager
def _stub_modules_free():
    """Neither stub module name in ``sys.modules`` inside the block; the
    entries as they were afterwards (whichever test file ran first)."""
    saved = {name: sys.modules.pop(name) for name in STUB_MODULES if name in sys.modules}
    try:
        yield
    finally:
        for name in STUB_MODULES:
            sys.modules.pop(name, None)
        sys.modules.update(saved)


@pytest.mark.parametrize("name", MODELS)
def test_pickles_cross_between_the_packages(name, tmp_path):
    from tensornetworkforml_tpu.utils import checkpoint as jckpt

    j = MODELS[name]()
    t = _port_copy(j)
    want = _jax_fwd(j)
    np.testing.assert_allclose(_port_fwd(t), want, rtol=RTOL)
    # the JAX package writes, the port reads
    jckpt.save_reference_pickle(j, str(tmp_path / "jax.dat"))
    got = ckpt.mps_from_reference_pickle(str(tmp_path / "jax.dat"), device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert (got.l_pos, got.act_fn, got.loss_fn, got.T) == (j.l_pos, j.act_fn, j.loss_fn, j.T)
    np.testing.assert_allclose(_port_fwd(got), want, rtol=RTOL)
    # the port writes, the JAX package reads
    ckpt.save_reference_pickle(t, str(tmp_path / "port.dat"))
    back = jckpt.mps_from_reference_pickle(str(tmp_path / "port.dat"))
    assert back.l_pos == j.l_pos
    np.testing.assert_allclose(_jax_fwd(back), want, rtol=RTOL)
    # the same bytes: only the stubs' module and class names are written
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()
    f32 = ckpt.mps_from_reference_pickle(str(tmp_path / "port.dat"), dtype=torch.float32,
                                         device="cpu")
    assert f32.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.mps_from_reference_pickle(str(tmp_path / "port.dat"))


def _ragged_net(perm_seed=0):
    """A reference-like net with ragged bonds (2, 3, 4, 3, 2 < M), the label
    at site 2, and each site's axes in a shuffled order."""
    rng = np.random.default_rng(perm_seed)
    n_sites, D, L_, M_, l_pos = 6, 2, 3, 4, 2
    bonds = [2, 3, 4, 3, 2]
    As = []
    for n in range(n_sites):
        axes = {}
        if n > 0:
            axes["left"] = bonds[n - 1]
        if n < n_sites - 1:
            axes["right"] = bonds[n]
        if n == l_pos:
            axes["l"] = L_
        axes[f"d{n}"] = D
        names = list(axes)
        order = rng.permutation(len(names))
        names = [names[i] for i in order]
        A = types.SimpleNamespace(elem=rng.random([axes[k] for k in names]),
                                  axes_names=np.array(names))
        As.append(A)
    return types.SimpleNamespace(N=n_sites, M=M_, D=D, L=L_, T=0.2, l_pos=l_pos,
                                 act_fn="linear", loss_fn="MSE", As=As)


def test_mps_from_reference_net_is_the_jax_function():
    from tensornetworkforml_tpu.utils.checkpoint import mps_from_reference_net as jfrom

    for seed in range(3):
        net = _ragged_net(seed)
        got = ckpt.mps_from_reference_net(net, device="cpu")
        want = jfrom(net)
        np.testing.assert_array_equal(got.sites.numpy(), np.asarray(want.sites))
        np.testing.assert_array_equal(got.label_site.numpy(), np.asarray(want.label_site))
        assert (got.l_pos, got.act_fn, got.loss_fn, got.T) == (
            want.l_pos, want.act_fn, want.loss_fn, want.T)
    net = _ragged_net(0)
    net.l_pos = 3  # the label axis sits at site 2
    with pytest.raises(ValueError, match="away from l_pos"):
        ckpt.mps_from_reference_net(net, device="cpu")


@pytest.mark.parametrize("module,name", sorted(ckpt._RefUnpickler._SUBSTITUTE))
def test_unpickler_maps_every_substitute_name(module, name, tmp_path, monkeypatch):
    from tensornetworkforml_tpu.utils.checkpoint import _RefUnpickler as JUnpickler

    assert ckpt._RefUnpickler._SUBSTITUTE == JUnpickler._SUBSTITUTE
    # a class pickled by reference under (module, name), then made unreachable
    cls = type(name, (), {})
    cls.__module__, cls.__qualname__ = module, name
    mod = sys.modules.get(module)
    if mod is None:
        mod = types.ModuleType(module)
        monkeypatch.setitem(sys.modules, module, mod)
    monkeypatch.setattr(mod, name, cls, raising=False)
    obj = cls()
    obj.N, obj.elem = 5, np.arange(3.0)
    path = tmp_path / "obj.dat"
    path.write_bytes(pickle.dumps(obj))
    monkeypatch.undo()
    assert getattr(sys.modules.get(module), name, None) is not cls
    got = ckpt.load_reference_pickle(str(path))
    assert type(got).__name__ == name and type(got) is not cls
    assert got.N == 5
    np.testing.assert_array_equal(got.elem, np.arange(3.0))


@pytest.mark.parametrize("first", ["port", "jax"])
def test_both_packages_save_in_one_process_in_either_order(first, tmp_path):
    """The stub modules' names are shared: the second save pickles with the
    class the first one installed, and the bytes stay the same."""
    from tensornetworkforml_tpu.utils import checkpoint as jckpt

    j = _jax_model(3, seed=4)
    t = _port_copy(j)
    saves = {"port": lambda p: ckpt.save_reference_pickle(t, p),
             "jax": lambda p: jckpt.save_reference_pickle(j, p)}
    order = [first, "jax" if first == "port" else "port"]
    with _stub_modules_free():
        for who in order:
            saves[who](str(tmp_path / f"{who}.dat"))
        assert sys.modules["Network_class"].Network.__module__ == "Network_class"
        # each file loads through plain pickle too, by the installed stubs
        with open(tmp_path / "port.dat", "rb") as fh:
            assert type(pickle.load(fh)) is sys.modules["Network_class"].Network
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()
    for who in order:
        np.testing.assert_allclose(
            _port_fwd(ckpt.mps_from_reference_pickle(str(tmp_path / f"{who}.dat"),
                                                     device="cpu")),
            _jax_fwd(j), rtol=RTOL)


def test_save_uses_the_class_a_module_already_holds(tmp_path):
    """A ``Network_class`` module that some other code put into
    ``sys.modules`` with its own class: the port pickles with that class, as
    pickle requires, and installs nothing over it."""
    j = _jax_model(0, seed=5)
    with _stub_modules_free():
        other = {}
        for mod_name, cls_name in (("Network_class", "Network"), ("Tensor_class", "Tensor")):
            mod = types.ModuleType(mod_name)
            cls = type(cls_name, (), {})
            cls.__module__ = mod_name
            setattr(mod, cls_name, cls)
            sys.modules[mod_name] = mod
            other[mod_name] = cls
        ckpt.save_reference_pickle(_port_copy(j), str(tmp_path / "m.dat"))
        assert sys.modules["Network_class"].Network is other["Network_class"]
        with open(tmp_path / "m.dat", "rb") as fh:
            net = pickle.load(fh)
        assert type(net) is other["Network_class"]
        assert type(net.As[0]) is other["Tensor_class"]
    np.testing.assert_allclose(
        _port_fwd(ckpt.mps_from_reference_pickle(str(tmp_path / "m.dat"), device="cpu")),
        _jax_fwd(j), rtol=RTOL)


def test_predictor_serves_a_reference_pickle_as_the_jax_predictor(tmp_path):
    from tensornetworkforml_tpu.models.serving import Predictor as JaxPredictor
    from tensornetworkforml_tpu.utils import checkpoint as jckpt

    from tensornetworkforml_torch.models.serving import Predictor

    for l_pos in (0, 3):
        path = str(tmp_path / f"m{l_pos}.dat")
        jckpt.save_reference_pickle(_jax_model(l_pos, seed=6), path)
        got = Predictor.from_checkpoint(path, device="cpu", batch_size=8)
        assert got.mps.dtype == torch.float32 and not got.use_kernel
        want = JaxPredictor.from_checkpoint(path, batch_size=8)
        x = np.random.default_rng(7).random((19, N)).astype(np.float32)
        np.testing.assert_allclose(got.scores(x), want.scores(x), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got.predict(x), got.scores(x).argmax(axis=1))
