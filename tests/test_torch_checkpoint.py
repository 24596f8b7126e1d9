"""The ``.npz`` checkpoint format is shared by the JAX package and the port:
each reads what the other writes, and both give the same forward pass."""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensornetworkforml_tpu.models import mps as jm
from tensornetworkforml_tpu.ops.embedding import psi_embed as j_psi
from tensornetworkforml_tpu.utils import checkpoint as jck
from tensornetworkforml_torch.models import mps as tm
from tensornetworkforml_torch.ops.embedding import psi_embed as t_psi
from tensornetworkforml_torch.utils import checkpoint as tck

N, M, D, L = 8, 4, 2, 3


def _jax_model(l_pos=2, seed=0):
    rng = np.random.default_rng(seed)
    return jm.MPS(
        sites=jnp.asarray(rng.standard_normal((N, M, D, M)) * 0.5),
        label_site=jnp.asarray(rng.standard_normal((M, D, L, M)) * 0.5),
        l_pos=l_pos, act_fn="softmax", loss_fn="full_cross_ent", T=0.25,
    )


def _x():
    return np.random.default_rng(1).random((5, N))


def _assert_same_model(t, j):
    assert (t.l_pos, t.act_fn, t.loss_fn, t.T) == (j.l_pos, j.act_fn, j.loss_fn, j.T)
    want = np.asarray(jm.mps_forward(j, j_psi(jnp.asarray(_x()))))
    got = tm.mps_forward(t, t_psi(torch.as_tensor(_x()))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_jax_checkpoint_loads_in_port(tmp_path):
    j = _jax_model()
    jck.save_checkpoint(j, str(tmp_path / "m.npz"))
    t = tck.load_checkpoint(str(tmp_path / "m.npz"), device="cpu")
    assert t.dtype == torch.float64
    _assert_same_model(t, j)
    t32 = tck.load_any_checkpoint(str(tmp_path / "m.npz"), dtype=torch.float32,
                                 device="cpu")
    assert t32.dtype == torch.float32


def test_port_checkpoint_loads_in_jax(tmp_path):
    j = _jax_model(l_pos=5, seed=3)
    t = tck.mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=5,
                           act_fn="softmax", loss_fn="full_cross_ent", T=0.25)
    tck.save_checkpoint(t, str(tmp_path / "m.npz"))
    _assert_same_model(t, jck.load_checkpoint(str(tmp_path / "m.npz")))


def test_both_packages_write_the_same_archive(tmp_path):
    j = _jax_model()
    jck.save_checkpoint(j, str(tmp_path / "j.npz"))
    tck.save_checkpoint(tck.load_checkpoint(str(tmp_path / "j.npz"), device="cpu"),
                        str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["label_site", "meta", "sites"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        assert json.loads(bytes(b["meta"]).decode())["version"] == 1


def test_training_state_round_trips_both_ways(tmp_path):
    j = _jax_model()
    jck.save_training_state(str(tmp_path / "s.npz"), j, epoch=4)
    template = tm.MPS(torch.zeros(1, 1, 1, 1, dtype=torch.float32),
                      torch.zeros(1, 1, 1, 1, dtype=torch.float32))
    t, epoch = tck.load_training_state(str(tmp_path / "s.npz"), template=template)
    assert epoch == 4 and t.dtype == torch.float32
    t64, _ = tck.load_training_state(str(tmp_path / "s.npz"))
    _assert_same_model(t64, j)
    tck.save_training_state(str(tmp_path / "p.npz"), t64, epoch=7)
    j2, epoch2 = jck.load_training_state(str(tmp_path / "p.npz"))
    assert epoch2 == 7
    _assert_same_model(t64, j2)


def test_boundary_checkpoint_is_not_ported(tmp_path):
    """A boundary-label checkpoint written by the JAX package: since the
    family was ported (ROADMAP queue 1 item 10) ``load_any_checkpoint``
    returns a ``BoundaryMPS`` with its arrays, where it used to raise."""
    from tensornetworkforml_torch.models.boundary import BoundaryMPS

    rng = np.random.default_rng(2)
    fake = types.SimpleNamespace(
        sites=rng.standard_normal((N, M, D, M)), w=rng.standard_normal((M, L)),
        act_fn="linear", loss_fn="MSE", T=0.1,
    )
    jck.save_boundary_checkpoint(fake, str(tmp_path / "b.npz"))
    t = tck.load_any_checkpoint(str(tmp_path / "b.npz"), device="cpu")
    assert isinstance(t, BoundaryMPS) and (t.act_fn, t.loss_fn, t.T) == ("linear", "MSE", 0.1)
    np.testing.assert_array_equal(t.sites.numpy(), fake.sites)
    np.testing.assert_array_equal(t.w.numpy(), fake.w)


def test_archive_without_meta_is_rejected(tmp_path):
    np.savez(tmp_path / "x.npz", sites=np.zeros(3))
    with pytest.raises(ValueError, match="meta"):
        tck.load_any_checkpoint(str(tmp_path / "x.npz"))
