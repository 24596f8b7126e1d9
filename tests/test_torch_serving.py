"""The serving slice end to end: the JAX package's Predictor and the port's,
on the same ``.npz`` checkpoint and the same requests.

JAX is imported inside the fixtures, so that the test marked ``cuda`` runs
on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_serving.py``.
Tolerance: rtol 1e-4, atol 1e-6 in float32 (the Pallas kernel's, see
``tests/test_pallas_kernels.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.serving import Predictor
from tensornetworkforml_torch.ops.kernels import env_scan
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy, save_checkpoint

N, M, L = 20, 8, 3
SIZES = (1, 7, 8, 9, 23)
RTOL, ATOL = 1e-4, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requests(n=max(SIZES)):
    return np.random.default_rng(5).random((n, N)).astype(np.float32)


@pytest.fixture
def jax_model():
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    return product_init(jax.random.PRNGKey(3), N=N, M=M, L=L, dtype=jnp.float32,
                        act_fn="softmax", loss_fn="cross_entropy", noise=0.05)


def _jax_predictor(mps, **kw):
    from tensornetworkforml_tpu.models.serving import Predictor as JaxPredictor

    return JaxPredictor(mps, batch_size=8, **kw)


@pytest.mark.parametrize("use_kernel", [None, True])
def test_port_serves_what_the_pallas_predictor_serves(tmp_path, jax_model, use_kernel):
    from tensornetworkforml_tpu.utils.checkpoint import save_checkpoint as jax_save

    path = str(tmp_path / "m.npz")
    jax_save(jax_model, path)
    want_pred = _jax_predictor(jax_model, use_pallas=True)  # interpret mode on CPU
    got_pred = Predictor.from_checkpoint(path, device="cpu", batch_size=8,
                                         use_kernel=use_kernel)
    assert got_pred.use_kernel is bool(use_kernel)  # the default is off on CPU
    x = _requests()
    for n in SIZES:
        got = got_pred.scores(x[:n])
        assert got.shape == (n, L) and got.dtype == np.float32
        np.testing.assert_allclose(got, want_pred.scores(x[:n]), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_pred.predict(x), got_pred.scores(x).argmax(axis=1))


def test_use_pallas_is_the_jax_name_for_use_kernel(jax_model):
    t = mps_from_numpy(np.asarray(jax_model.sites), np.asarray(jax_model.label_site),
                       act_fn="softmax", T=jax_model.T)
    pred = Predictor(t, batch_size=8, use_pallas=False, device="cpu")
    ref = _jax_predictor(jax_model, use_pallas=False)
    assert not pred.use_kernel and pred.use_pallas is False and ref.use_pallas is False
    x = _requests()
    np.testing.assert_allclose(pred.scores(x), ref.scores(x), rtol=RTOL, atol=ATOL)
    on = Predictor(t, batch_size=8, use_pallas=True, device="cpu")
    assert on.use_kernel and on.use_pallas
    assert Predictor(t, use_kernel=True, use_pallas=True, device="cpu").use_kernel
    with pytest.raises(ValueError, match="use_pallas"):
        Predictor(t, use_kernel=True, use_pallas=False, device="cpu")
    with pytest.raises(ValueError, match="use_pallas"):
        Predictor(t, use_kernel=False, use_pallas=True, device="cpu")


def test_activation_mode_softmax_rows_sum_to_one(jax_model):
    t = mps_from_numpy(np.asarray(jax_model.sites), np.asarray(jax_model.label_site),
                       act_fn="softmax", T=jax_model.T)
    got = Predictor(t, batch_size=8, activation=True, device="cpu").scores(_requests())
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    want = _jax_predictor(jax_model, activation=True).scores(_requests())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_label_off_site_zero_takes_the_plain_route(jax_model):
    j = jax_model.replace(l_pos=N // 2)
    t = mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=N // 2)
    pred = Predictor(t, batch_size=8, device="cpu")
    assert not pred.use_kernel
    np.testing.assert_allclose(pred.scores(_requests()), _jax_predictor(j).scores(_requests()),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="site 0"):
        Predictor(t, batch_size=8, use_kernel=True, device="cpu").scores(_requests())


def test_unported_inputs_raise_naming_the_roadmap(tmp_path, jax_model):
    import torch.distributed as dist

    from tensornetworkforml_torch.parallel.mesh import make_mesh

    t = mps_from_numpy(np.asarray(jax_model.sites), np.asarray(jax_model.label_site))
    # mesh serving is ported (item 11): in a world of one on the CPU it scores
    # as the single-device predictor does, and as the JAX package's predictor
    # over a mesh of one device
    import jax

    from tensornetworkforml_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = make_mesh(device="cpu")
    try:
        got = Predictor(t, batch_size=8, mesh=mesh).scores(_requests())
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, Predictor(t, batch_size=8, device="cpu").scores(
        _requests()))
    jax_mesh = jax_make_mesh(shape=(1, 1), devices=jax.devices()[:1])
    np.testing.assert_allclose(got, _jax_predictor(jax_model, mesh=jax_mesh).scores(_requests()),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        Predictor.from_checkpoint(str(tmp_path / "model.dat"))
    # the boundary-label family is ported (item 10): it is served, not refused
    from tensornetworkforml_torch.utils.checkpoint import boundary_from_numpy

    rng = np.random.default_rng(1)
    b = boundary_from_numpy(rng.random((N, M, 2, M)) / M, rng.random((M, L)), device="cpu")
    assert Predictor(b, batch_size=8, device="cpu").scores(_requests()).shape == (max(SIZES), L)


def test_predictor_leaves_the_callers_model_alone(tmp_path):
    rng = np.random.default_rng(0)
    t = mps_from_numpy(rng.random((4, 2, 2, 2)), rng.random((2, 2, 3, 2)))
    pred = Predictor(t, batch_size=4, device="cpu")
    assert pred.mps is not t and t.dtype == torch.float64
    save_checkpoint(t, str(tmp_path / "m.npz"))
    pred.warmup()
    assert Predictor.from_checkpoint(str(tmp_path / "m.npz"),
                                    device="cpu").mps.dtype == torch.float32


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys\n"
        "import tensornetworkforml_torch, tensornetworkforml_torch.ops, "
        "tensornetworkforml_torch.models, tensornetworkforml_torch.utils, "
        "tensornetworkforml_torch.data, tensornetworkforml_torch.ops.kernels.env_scan\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'tensornetworkforml_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.cuda
def test_predictor_on_card_launches_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain kernel has no CPU mode")
    g = torch.Generator().manual_seed(0)
    from tensornetworkforml_torch.models.mps import product_init

    mps = product_init(g, N=N, M=M, L=L, act_fn="linear", loss_fn="MSE")
    pred = Predictor(mps, batch_size=8, device="cuda")
    assert pred.use_kernel
    launches = env_scan.right_env_chain.launches
    got = pred.scores(_requests())
    assert env_scan.right_env_chain.launches == launches + 3  # 23 requests, 3 chunks
    want = Predictor(mps, batch_size=8, device="cpu").scores(_requests())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
