"""K2, the hybrid engine's fused pre-split step: its plain version against
the JAX package's Pallas kernel (interpret mode on the CPU), and the CUDA
kernel against the plain version on a card.

JAX is imported inside the tests, so that the tests marked ``cuda`` run on a
machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_presplit.py``.

Tolerance: 1e-5 of each output's max|.|, in float32. Every output is a sum
of at most a few thousand float32 products taken in different orders, and
the clip factor multiplies a whole block; the inputs keep the loss
derivative away from its poles (full_cross_ent's 1/(f - 1 + y + 1e-4)).
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops.kernels import presplit_kernel as tpk

TOL = 1e-5
PAIRS = [("linear", "MSE"), ("softmax", "cross_entropy"), ("softmax", "full_cross_ent"),
         ("sigmoid", "MSE")]
NAMES = ("B_new", "y0", "g", "f_new", "left_part", "stats")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pre-split kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(L, M, D, B, q, seed, clip=True):
    """Kernel-layout inputs; ``clip=False`` shrinks the left environment so
    that sum|dB| stays below sum|B| and the L1 clip does not fire."""
    rng = np.random.default_rng(seed)
    I, DM = M * D, D * M
    f32 = np.float32
    x1, x2 = rng.random((B, D)).astype(f32), rng.random((B, D)).astype(f32)
    l_env = rng.standard_normal((B, M)).astype(f32) * (1.0 if clip else 1e-4)
    return dict(
        lab=(rng.standard_normal((L, I, M)) / np.sqrt(M)).astype(f32),
        a2m=(rng.standard_normal((M, DM)) / np.sqrt(M)).astype(f32),
        x1=x1, x2=x2, l_env=l_env,
        r_env=rng.standard_normal((B, M)).astype(f32),
        y1h=np.eye(L, dtype=f32)[rng.integers(0, L, B)].T.copy(),
        f=(0.3 * rng.standard_normal((L, B))).astype(f32),
        om=rng.standard_normal((L, DM, q)).astype(f32),
    )


def _assert_outputs_close(got, want, tol=TOL):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= tol * scale, (name, np.abs(a - b).max() / scale)


@pytest.mark.parametrize("act_fn,loss_fn", PAIRS)
@pytest.mark.parametrize("with_gram", [True, False])
@pytest.mark.parametrize("clip", [True, False])
def test_plain_version_matches_pallas(act_fn, loss_fn, with_gram, clip):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.kernels.presplit_kernel import two_site_presplit_pallas

    inp = _inputs(L=3, M=4, D=2, B=16, q=4, seed=len(act_fn) + 7 * clip, clip=clip)
    kw = dict(act_fn=act_fn, loss_fn=loss_fn, T=0.5, with_gram=with_gram)
    want = two_site_presplit_pallas(
        *[jnp.asarray(v) for v in inp.values()], 0.05, 1e-3, interpret=True, **kw
    )
    args = [torch.as_tensor(v) for v in inp.values()]
    got = tpk.two_site_presplit_reference(*args, 0.05, 1e-3, **kw)
    _assert_outputs_close(got, want)
    stats = got[5][0]
    assert bool(stats[1] > stats[0]) == clip  # the clip fired, or it did not
    launches = tpk.two_site_presplit.launches
    via_wrapper = tpk.two_site_presplit(*args, torch.tensor(0.05), torch.tensor(1e-3), **kw)
    assert tpk.two_site_presplit.launches == launches  # CPU: the plain version
    for a, b in zip(via_wrapper, got):
        assert torch.equal(a, b)


def test_accuracy_is_the_unique_max_rule():
    """acc counts a sample when the target's score ties the max, as the
    Pallas kernel does, rather than taking argmax's first index."""
    inp = _inputs(L=3, M=2, D=2, B=4, q=2, seed=1)
    inp["f"] = np.array([[1, 0, 2, 0], [1, 1, 0, 0], [0, 1, 2, 0]], np.float32)
    inp["y1h"] = np.eye(3, dtype=np.float32)[[1, 2, 2, 0]].T.copy()
    out = tpk.two_site_presplit_reference(*[torch.as_tensor(v) for v in inp.values()], 0.1,
                                          0.0, act_fn="linear", loss_fn="MSE")
    assert float(out[5][0, 4]) == 1.0  # every target ties its sample's max


def test_wrapper_rejects_a_device_it_has_no_kernel_for():
    args = [torch.as_tensor(v).to("meta") for v in _inputs(2, 2, 2, 4, 2, seed=0).values()]
    with pytest.raises(ValueError, match="CUDA"):
        tpk.two_site_presplit(*args, 0.1, 0.0)


# On the card: the flagship step (L = 10, M = 128, B = 256), the hybrid step
# at M = 256 (I = 512, above the JAX package's cap) and a ragged one.
CUDA_SHAPES = [(10, 128, 2, 256, 128), (10, 256, 2, 256, 256), (3, 5, 2, 37, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("L,M,D,B,q", CUDA_SHAPES)
@pytest.mark.parametrize("act_fn,loss_fn", PAIRS)
def test_kernel_matches_plain_on_card(L, M, D, B, q, act_fn, loss_fn, cuda):
    for clip, with_gram in ((True, True), (False, False)):
        inp = _inputs(L, M, D, B, q, seed=M + B, clip=clip)
        args = [torch.as_tensor(v, device=cuda) for v in inp.values()]
        lr, wd = torch.full((1,), 0.05, device=cuda), torch.full((1,), 1e-3, device=cuda)
        kw = dict(act_fn=act_fn, loss_fn=loss_fn, T=0.5, with_gram=with_gram)
        launches = tpk.two_site_presplit.launches
        got = tpk.two_site_presplit(*args, lr, wd, **kw)
        torch.cuda.synchronize()
        assert tpk.two_site_presplit.launches == launches + 1
        want = tpk.two_site_presplit_reference(*args, lr, wd, **kw)
        _assert_outputs_close([t.cpu() for t in got], [t.cpu() for t in want])
        again = tpk.two_site_presplit(*args, lr, wd, **kw)  # no atomics: same bits
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    inp = _inputs(2, 4, 2, 8, 4, seed=0)
    args = [torch.as_tensor(v, device=cuda) for v in inp.values()]
    with pytest.raises(TypeError):
        tpk.two_site_presplit(*[a.double() for a in args], 0.1, 0.0)
    bad = list(args)
    bad[1] = args[1][:, :4]  # a2m of the wrong width
    with pytest.raises(ValueError):
        tpk.two_site_presplit(*bad, 0.1, 0.0)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        tpk.two_site_presplit(*bad, 0.1, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,M,D,B,q", CUDA_SHAPES[:2])
@pytest.mark.parametrize("act_fn,loss_fn", PAIRS[:2])
def test_repeated_launches_are_bit_identical(L, M, D, B, q, act_fn, loss_fn, cuda):
    inp = _inputs(L, M, D, B, q, seed=7 * M + B)
    args = [torch.as_tensor(v, device=cuda) for v in inp.values()]
    kw = dict(act_fn=act_fn, loss_fn=loss_fn, T=0.5)
    first = tpk.two_site_presplit(*args, 0.05, 1e-3, **kw)
    for _ in range(4):
        again = tpk.two_site_presplit(*args, 0.05, 1e-3, **kw)
        for name, a, b in zip(NAMES, first, again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("L,M,D,B,q", CUDA_SHAPES)
def test_without_gram_the_other_outputs_keep_their_bits(L, M, D, B, q, cuda):
    inp = _inputs(L, M, D, B, q, seed=M + 3 * B)
    args = [torch.as_tensor(v, device=cuda) for v in inp.values()]
    full = tpk.two_site_presplit(*args, 0.05, 1e-3)
    bare = tpk.two_site_presplit(*args, 0.05, 1e-3, with_gram=False)
    assert bare[2].shape == (8, 128) and not bare[2].any()
    for i in (0, 1, 3, 4, 5):
        assert torch.equal(full[i].view(torch.int32), bare[i].view(torch.int32)), NAMES[i]
    want = tpk.two_site_presplit_reference(*args, 0.05, 1e-3, with_gram=False)
    _assert_outputs_close([t.cpu() for t in bare], [t.cpu() for t in want])


@pytest.mark.cuda
def test_a_large_batch_takes_the_dynamic_shared_memory_path(cuda):
    # loss_der[o, :] sits in dynamic shared memory: 4 B floats beside ~19 KB
    # of static shared memory, so B = 8192 passes the 48 KB default limit
    inp = _inputs(3, 8, 2, 8192, 8, seed=11)
    args = [torch.as_tensor(v, device=cuda) for v in inp.values()]
    got = tpk.two_site_presplit(*args, 0.05, 1e-3, act_fn="softmax", loss_fn="cross_entropy")
    torch.cuda.synchronize()
    want = tpk.two_site_presplit_reference(*args, 0.05, 1e-3, act_fn="softmax",
                                           loss_fn="cross_entropy")
    _assert_outputs_close([t.cpu() for t in got], [t.cpu() for t in want])
