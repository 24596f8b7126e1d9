"""The port's teacher task (``data/teacher.py``) against the JAX package's,
on the CPU.

The teachers are drawn from ``jax.random`` in one package and a
``torch.Generator`` in the other, so the JAX teachers are handed to the port
(``teacher_mps`` patched, through ``utils.checkpoint.mps_from_numpy``). The
task is then held three ways:

* the teachers' forward pass: the port's scores within 1e-5 of the scores'
  max of the JAX package's (float32 products in another order);
* the labeling: with the JAX package's scores handed over too
  (``teacher_scores`` patched), the whole task equals the JAX task bit for
  bit -- the pixels, the labels, the class balance and ``proto_mix``;
* the whole task with only the teachers handed over: a rounding difference
  between the two forward passes can move a sample across the margin cut or
  the per-class widest-margin cut, so the candidates' argmax labels must
  agree on at least 99.5% of the pool, and at least 99.5% of the task's
  rows must be the same sample with the same label; the classes are
  exactly balanced.

A sample's label is its row's argmax; the output's ``y`` arrays alone say
little, since after the exact balancing they depend only on the shuffle.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.data import teacher as tt
from tensornetworkforml_torch.data.loader import prepare_dataset
from tensornetworkforml_torch.models.mps import product_init
from tensornetworkforml_torch.train.trainer import evaluate_accuracy, train_model
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

FORWARD_TOL = 1e-5  # of max|scores|, float32
AGREE = 0.995  # share of labels that must agree when only the teachers are shared

# the shapes of tests/test_teacher_task.py, and the defaults (N=196, L=10)
SHAPES = {
    "balanced_seed5": dict(n_train=400, n_test=100, N=16, L=4, teacher_m=3, margin=0.3, seed=5),
    "balanced_seed6": dict(n_train=400, n_test=100, N=16, L=4, teacher_m=3, margin=0.3, seed=6),
    "learnable": dict(n_train=768, n_test=256, N=24, L=3, teacher_m=2, margin=0.5, seed=0),
    "defaults": dict(seed=0),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Small products: one intra-op thread is faster and keeps parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_teacher(seed, c, N, teacher_m, noise, x_cal):
    """The JAX package's teacher ``c``, drawn as its ``teacher_task`` draws it."""
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init as jpi

    return jpi(jax.random.PRNGKey(seed * 1000 + 7 + c), N=N, M=teacher_m, L=1,
               noise=noise, act_fn="linear", loss_fn="MSE", dtype=jnp.float32,
               calibration_x=x_cal)


def _to_port(j, device="cpu"):
    # float32 as the port draws it: under the tests' float64 mode the JAX
    # package's output-scale guard promotes the label core to float64
    return mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site), l_pos=j.l_pos,
                          act_fn=j.act_fn, loss_fn=j.loss_fn, T=j.T, device=device,
                          dtype=torch.float32)


def _jax_scores(teachers, x):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward
    from tensornetworkforml_tpu.ops.embedding import psi_embed

    phi = psi_embed(jnp.asarray(x))
    return np.asarray(jnp.concatenate([mps_forward(t, phi) for t in teachers], axis=0)).T


def test_teacher_forward_matches_jax():
    N, L, m = 196, 10, 4
    rng = np.random.default_rng(0)
    x_cal = rng.random((64, N)).astype(np.float32)
    x = rng.random((512, N)).astype(np.float32)
    jteachers = [_jax_teacher(0, c, N, m, 1 / np.sqrt(N), x_cal) for c in range(L)]
    want = _jax_scores(jteachers, x)
    got = tt.teacher_scores([_to_port(j) for j in jteachers], x)
    assert got.shape == want.shape == (512, L) and got.dtype == np.float32
    assert np.abs(want).max() > 1.0  # scores of order one, not a degenerate draw
    assert np.abs(got - want).max() <= FORWARD_TOL * np.abs(want).max()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_labeling_is_the_jax_labeling_bit_for_bit(shape, monkeypatch):
    from tensornetworkforml_tpu.data.teacher import teacher_task as jtask

    monkeypatch.setattr(tt, "teacher_mps", lambda seed, c, N, m, noise, x_cal, device:
                        _jax_teacher(seed, c, N, m, noise, x_cal))
    monkeypatch.setattr(tt, "teacher_scores", _jax_scores)
    got = tt.teacher_task(**SHAPES[shape], device="cpu")
    want = jtask(**SHAPES[shape])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_task_with_the_jax_teachers_agrees_with_the_jax_task(monkeypatch):
    from tensornetworkforml_tpu.data.teacher import teacher_task as jtask

    kw = SHAPES["defaults"]
    scores = {}
    real_scores = tt.teacher_scores

    def keep(teachers, x):
        out = real_scores(teachers, x)
        scores.setdefault("port", []).append(out)
        scores.setdefault("jax", []).append(
            _jax_scores([jteachers[c] for c in range(len(teachers))], x))
        return out

    jteachers = {}

    def draw(seed, c, N, m, noise, x_cal, device):
        jteachers[c] = _jax_teacher(seed, c, N, m, noise, x_cal)
        return _to_port(jteachers[c], device)

    monkeypatch.setattr(tt, "teacher_mps", draw)
    monkeypatch.setattr(tt, "teacher_scores", keep)
    got = tt.teacher_task(**kw, device="cpu")
    want = jtask(**kw)
    fp, fj = np.concatenate(scores["port"]), np.concatenate(scores["jax"])
    z = lambda f: (f - f.mean(0)) / f.std(0)  # noqa: E731
    assert np.mean(z(fp).argmax(1) == z(fj).argmax(1)) >= AGREE
    rows = np.mean([np.array_equal(a, b) for a, b in zip(got[0], want[0])])
    assert rows >= AGREE
    assert np.mean(got[1] == want[1]) >= AGREE
    total = np.bincount(np.concatenate([got[1], got[3]]), minlength=10)
    assert total.min() == total.max() == (4096 + 1024) // 10


def test_port_task_is_balanced_deterministic_and_seeded():
    """``test_teacher_task_balanced_and_deterministic`` with the port's own
    teachers."""
    kw = SHAPES["balanced_seed5"]
    a = tt.teacher_task(**kw, device="cpu")
    b = tt.teacher_task(**kw, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    tr_x, tr_y, te_x, te_y = a
    assert tr_x.shape == (400, 16) and te_x.shape == (100, 16)
    assert 0.0 <= tr_x.min() and tr_x.max() <= 1.0
    total = np.bincount(np.concatenate([tr_y, te_y]), minlength=4)
    assert total.min() == total.max() == 125
    assert np.bincount(tr_y, minlength=4).min() >= 80
    c = tt.teacher_task(**{**kw, "seed": 6}, device="cpu")
    assert not np.array_equal(a[0], c[0])
    # the same teachers whatever device the task runs on: drawn on the CPU
    t1 = tt.teacher_mps(5, 0, 16, 3, 0.25, tr_x[:8], "cpu")
    t2 = tt.teacher_mps(5, 0, 16, 3, 0.25, tr_x[:8], "cpu")
    assert torch.equal(t1.sites, t2.sites)


def test_task_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.teacher_task(**SHAPES["balanced_seed5"])


def test_port_trains_the_teacher_task():
    """``test_teacher_task_is_learnable_but_not_saturating`` on the port's
    task, init and trainer: N=24, M=8, L=3, cholqr, 6 epochs, test > 0.6
    (chance is 1/3)."""
    tr_x, tr_y, te_x, te_y = tt.teacher_task(**SHAPES["learnable"], device="cpu")
    data = np.concatenate([tr_x, te_x])
    labels = np.concatenate([tr_y, te_y])
    tl, _, test_l = prepare_dataset(data, labels, 0.75, 0.0, 128, 128, 256, embed=False,
                                    seed=1, even_train_batches=True)
    x_cal, _ = next(tl.batches())
    mps = product_init(torch.Generator().manual_seed(0), N=24, M=8, L=3, act_fn="linear",
                       loss_fn="MSE", calibration_x=x_cal, device="cpu")
    mps, _, _ = train_model(mps, tl, tl, lr=0.1, n_epochs=6, weight_dec=1e-5, L2_flag=False,
                            split_mode="canonical", svd_method="cholqr", verbose=False)
    assert evaluate_accuracy(mps, test_l) > 0.6
