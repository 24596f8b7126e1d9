"""The chain kernel's module: its plain version against the JAX package's
Pallas kernel (interpret mode on the CPU), and the CUDA kernel against the
plain version on a card.

JAX is imported inside the fixtures, so that the tests marked ``cuda`` run
on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_env_scan.py``.

Tolerance: rtol 1e-4, atol 1e-6 in float32, as ``tests/test_pallas_kernels.py``
holds the Pallas kernel; both sum 2M terms per site in different orders. The
kernel's form plan (latency or throughput form, cluster size) is mirrored in
Python (``env_scan.plan``): the CPU tests pin its choices on an H100's 132 SMs,
and a card test holds the built kernel's choice to the mirror.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels import env_scan
from tensornetworkforml_torch.utils.checkpoint import mps_from_numpy

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture
def jax_env_scan():
    from tensornetworkforml_tpu.ops.kernels import env_scan as jes

    return jes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain kernel has no CPU mode")
    return torch.device("cuda")


def _chain(n, M, B, seed=0):
    rng = np.random.default_rng(seed)
    sites = (rng.standard_normal((n, M, 2, M)) / np.sqrt(M)).astype(np.float32)
    return sites, rng.random((B, n)).astype(np.float32)


@pytest.mark.parametrize("n", [5, 16, 21])
def test_right_env_chain_matches_pallas(n, jax_env_scan):
    import jax.numpy as jnp

    sites, x = _chain(n, 8, 4, seed=n)
    want = np.asarray(jax_env_scan.right_env_chain_pallas(
        jnp.asarray(sites), jnp.asarray(x), interpret=True))
    launches = env_scan.right_env_chain.launches
    for fn in (env_scan.right_env_chain_reference, env_scan.right_env_chain):
        got = fn(torch.as_tensor(sites), torch.as_tensor(x))
        assert got.shape == (4, 8) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert env_scan.right_env_chain.launches == launches  # CPU: no launch


def test_forward_scores_matches_pallas_and_model(jax_env_scan):
    import jax
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import product_init

    j = product_init(jax.random.PRNGKey(0), N=20, M=8, L=3, dtype=jnp.float32)
    t = mps_from_numpy(np.asarray(j.sites), np.asarray(j.label_site))
    x = np.random.default_rng(31).random((16, 20)).astype(np.float32)
    want = np.asarray(jax_env_scan.forward_scores_pallas(j, jnp.asarray(x), interpret=True))
    got = env_scan.forward_scores(t, torch.as_tensor(x))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), mps_forward(t, psi_embed(torch.as_tensor(x))).numpy(),
        rtol=RTOL, atol=ATOL,
    )


def test_forward_scores_requires_label_at_start():
    sites, _ = _chain(6, 4, 1)
    mps = mps_from_numpy(sites, np.zeros((4, 2, 2, 4), np.float32), l_pos=5)
    with pytest.raises(ValueError, match="site 0"):
        env_scan.forward_scores(mps, torch.zeros((2, 6)))


def test_empty_chain_is_the_boundary_vector():
    got = env_scan.right_env_chain(torch.zeros((0, 3, 2, 3)), torch.zeros((2, 0)))
    np.testing.assert_array_equal(got.numpy(), [[1, 0, 0], [1, 0, 0]])


def test_non_cpu_non_cuda_input_raises_instead_of_falling_back():
    sites, x = _chain(4, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        env_scan.right_env_chain(torch.as_tensor(sites).to("meta"),
                                 torch.as_tensor(x).to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        env_scan.right_env_chain(torch.as_tensor(sites),
                                 torch.as_tensor(x).to("meta"))


# The form plan on an H100 (132 SMs), mirrored from csrc/env_scan.cu.
H100_SMS = 132


@pytest.mark.parametrize("M,B,form,C", [
    (128, 256, "latency", 3),       # the flagship at the Predictor's batch: 32 clusters of 3
    (128, 1, "latency", 4),
    (128, 240, "latency", 4),       # the last batch whose clusters of 4 fit one wave (30)
    (128, 248, "latency", 3),
    (128, 1000, "latency", 1),
    (128, 4160, "latency", 1),      # the last batch before the throughput form
    (128, 4161, "throughput", 1),
    (128, 8192, "throughput", 1),   # bulk scoring
    (512, 256, "latency", 3),       # the M=512 model served
    (130, 37, "latency", 3),        # an M the cluster does not divide
    (62, 256, "latency", 2),
    (5, 37, "latency", 1),
    (256, 8192, "throughput", 1),
    (300, 8192, "latency", 1),      # the throughput form's buffers do not fit
    (2248, 100, "latency", 4),
])
def test_plan_picks_the_form_by_shape(M, B, form, C):
    got = env_scan.plan(M, B, H100_SMS)
    assert (got["form"], got["C"]) == (form, C)
    assert got["BT"] == (64 if form == "throughput" else 8)
    assert got["fits"] and got["smem"] <= 232448
    assert (2 <= got["stages"] <= 4) if form == "throughput" else got["stages"] == 0


def test_plan_follows_the_cards_cluster_capacity():
    """A card that holds 32 clusters of 4 takes B=256 on them in one wave."""
    assert env_scan.plan(128, 256, H100_SMS, {2: 66, 3: 39, 4: 32})["C"] == 4
    assert env_scan.plan(128, 256, H100_SMS)["C"] == 3


@pytest.mark.parametrize("M,B", [(2248, 1), (2248, 4160), (561, 4193), (561, 8192),
                                 (3584, 256)])
def test_plan_takes_every_shape_the_first_kernel_took(M, B):
    """The first K3 took M up to 2248 below 4193 samples and up to 561 from
    there (its env, scaled env and A tile in 227 KB of shared memory)."""
    assert env_scan.plan(M, B, H100_SMS)["fits"]


def test_plan_marks_the_shapes_no_form_fits():
    """The latency form keeps two envs of M x 8 in shared memory: M = 3584 is
    the last that fits."""
    assert env_scan.plan(3584, 256, H100_SMS)["fits"]
    assert not env_scan.plan(3585, 256, H100_SMS)["fits"]


# On the card: the first kernel's five shapes (each of its tile widths, M over
# one 128-row pass, a ragged M and B, the flagship), then B=1, the throughput
# switch and one past it, the last batch on clusters of 4 and one past it
# (both from the card's SM count and cluster capacity), an M that the
# cluster does not divide, the M=512 model served at B=256, and the flagship
# at B=8192.
CUDA_CASES = [
    (16, 8, 4),
    (21, 5, 37),
    (10, 200, 50),
    (40, 8, 4300),
    (195, 128, 256),
    (195, 128, 1),
    (20, 128, "throughput switch"),
    (20, 128, "throughput switch + 1"),
    (20, 128, "cluster switch"),
    (20, 128, "cluster switch + 1"),
    (21, 130, 37),
    (195, 512, 256),
    (195, 128, 8192),
]


def _batch(B, card):
    """A batch size, or the named form boundary on a card ``(sms, clusters)``."""
    if isinstance(B, int):
        return B
    sms, clusters = card
    last = {"throughput switch": 64 * ((sms + 1) // 2 - 1), "cluster switch": 8 * clusters[4]}
    return last[B.split(" +")[0]] + B.endswith("+ 1")


def _card_chain(n, M, B, cuda):
    sites, x = _chain(n + 1, M, B, seed=M)
    s = torch.as_tensor(sites, device=cuda)[1:]
    return s, torch.as_tensor(x, device=cuda)[:, 1:]  # rows strided, as in serving


@pytest.mark.cuda
@pytest.mark.parametrize("n,M,B", CUDA_CASES)
def test_kernel_matches_plain_on_card(n, M, B, cuda):
    B = _batch(B, env_scan.kernel_card(cuda))
    sites, x = _chain(n + 1, M, B, seed=M)
    s = torch.as_tensor(sites, device=cuda)[1:]
    xt = torch.as_tensor(x, device=cuda)[:, 1:]  # rows strided, as in serving
    launches = env_scan.right_env_chain.launches
    got = env_scan.right_env_chain(s, xt)
    torch.cuda.synchronize()
    assert env_scan.right_env_chain.launches == launches + 1
    want = env_scan.right_env_chain_reference(s.double(), xt.double())
    assert got.shape == (B, M) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=RTOL * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,M,B", [(195, 128, 256), (195, 128, 8192), (21, 130, 37),
                                   (21, 5, 37)])
def test_kernel_gives_the_same_bits_twice_on_card(n, M, B, cuda):
    s, xt = _card_chain(n, M, B, cuda)
    first, second = env_scan.right_env_chain(s, xt), env_scan.right_env_chain(s, xt)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
def test_kernel_plan_agrees_with_the_mirror_on_card(cuda):
    card = env_scan.kernel_card(cuda)
    assert card[0] == torch.cuda.get_device_properties(cuda).multi_processor_count
    seen = set()
    for M in (1, 5, 62, 63, 128, 130, 256, 300, 512, 2248):
        for B in (1, 37, 256, _batch("cluster switch", card), _batch("cluster switch + 1", card),
                  _batch("throughput switch", card), _batch("throughput switch + 1", card), 8192):
            got = env_scan.kernel_plan(M, B, cuda)
            assert got == env_scan.plan(M, B, *card), (M, B)
            seen.add((got["form"], got["C"]))
    assert {("latency", 1), ("latency", 2), ("latency", 3), ("latency", 4),
            ("throughput", 1)} <= seen


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    sites, x = _chain(5, 4, 3)
    s, xt = torch.as_tensor(sites, device=cuda), torch.as_tensor(x, device=cuda)
    with pytest.raises(TypeError):
        env_scan.right_env_chain(s.double(), xt.double())
    with pytest.raises(ValueError):
        env_scan.right_env_chain(s.transpose(1, 3), xt)  # not contiguous
    with pytest.raises(ValueError):
        env_scan.right_env_chain(s, xt[:, :4])  # wrong n
    with pytest.raises(ValueError):
        env_scan.right_env_chain(s, torch.as_tensor(x))  # x on the CPU
    big = torch.zeros((1, 3585, 2, 3585), device=cuda)  # no form's buffers fit
    with pytest.raises(RuntimeError, match="invalid argument"):
        env_scan.right_env_chain(big, torch.zeros((3, 1), device=cuda))
