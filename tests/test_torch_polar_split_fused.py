"""K8, the all-in-one polar split: its plain version against the JAX
package's ``polar_split_pallas`` (interpret mode on the CPU) with the JAX
package's Omega, against the port's other polar splits, and the CUDA kernel
against the plain version on a card.

JAX is imported inside the fixtures and tests, so that the tests marked
``cuda`` run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_polar_split_fused.py``.

Tolerances:
* Q and its projector ``Q Q^T``, on matrices whose kept spectrum spans one
  decade: 1e-3. Both sides form ``y = B Omega`` and ``G = B B^T`` as float32
  sums in another order (the Pallas kernel in J-tiles), which the ~19
  Newton-Schulz passes amplify: measured up to 1.4e-4 over six seeds (the JAX
  package holds its own hybrid split to this kernel at 5e-4 on Q);
* R, relative to max|B|: 2e-4 (measured up to 9e-5; the JAX package's
  two-stage test uses 2e-4);
* on the JAX package's two-decade spectra float32 cannot pin the weakest kept
  columns: G squares the spectrum, so they sit near 1e-4 of the iterate's
  largest, and Q moved by up to 2e-2 at J = 5120 across six seeds while R
  stayed within 1e-4 of max|B|. There R and the captured energy
  ``|R|^2 / sum of the top singular values squared`` (within 1e-5) are held;
* exactly dead rows of B give exactly zero rows of Q, on both sides;
* the port's three polar splits on one matrix with one Omega, by the
  projector: 1e-3 (K1's limit: the same iteration on reductions summed in
  another order);
* on the card, the kernel against the plain version on the same input: the
  projector 1e-3, ``Q R`` 1e-4 of max|B| and the isometry of the live columns
  1e-4, ``chip_smoke.py``'s K1 limits;
* on the card, the kernel against ``polar_split_two_stage`` (K5, then K1) where
  J needs no pad for Omega: bit for bit, since the two run the same sums in
  the same order.
"""

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.kernels import polar_split as tps

Q_TOL, R_TOL = 1e-3, 2e-4
PROJ_TOL, REC_TOL, ISO_TOL = 1e-3, 1e-4, 1e-4


@pytest.fixture
def jps():
    from tensornetworkforml_tpu.ops.kernels import polar_split

    return polar_split


@pytest.fixture
def jax_omega(monkeypatch):
    """Make the port sketch with the JAX package's Omega (both packages ask
    for it at the padded length)."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        om = np.array(_rangefinder_omega(J, q, jnp.float32))
        return torch.as_tensor(om).to(dtype=dtype, device=device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", omega)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split kernel has no CPU mode")
    return torch.device("cuda")


def _gapped(I, J, rank, seed, decay_top=1.0, gap=0.004):
    """A two-site-like spectrum: ``rank`` kept directions over ``decay_top``
    decades, then a gap (the JAX package's split tests use two decades)."""
    r = np.random.default_rng(seed)
    k = min(I, J)
    u, _ = np.linalg.qr(r.standard_normal((I, k)))
    v, _ = np.linalg.qr(r.standard_normal((J, k)))
    s = np.ones(k)
    s[:rank] = np.logspace(0, -decay_top, rank)
    s[rank:] = s[rank - 1] * gap * np.logspace(0, -2, k - rank)
    return ((u * s) @ v.T).astype(np.float32)


def _dead_rows(I, J, live, seed):
    b = np.random.default_rng(seed).standard_normal((I, J)).astype(np.float32)
    b[live:] = 0.0  # padded bond slots
    return b


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


# name: (b, rank, n_power, dtype)
CASES = {
    "two_site": (lambda: _gapped(128, 1280, 64, seed=1), 64, 1, np.float32),
    "multi_chunk": (lambda: _gapped(128, 5120, 64, seed=2), 64, 1, np.float32),
    "padded": (lambda: _gapped(96, 300, 48, seed=3), 48, 1, np.float32),
    "padded_two_rounds": (lambda: _gapped(96, 300, 48, seed=3), 48, 2, np.float32),
    "rank_above_rows": (lambda: _gapped(32, 128, 32, seed=4), 64, 1, np.float32),
    "float64": (lambda: _gapped(96, 300, 48, seed=5), 48, 1, np.float64),
    "dead_rows": (lambda: _dead_rows(64, 640, 32, seed=6), 32, 1, np.float32),
    # step 98's two-site matrix shape at M=256 (L=10): K1's cluster form at
    # I=512, q=256 on the card
    "m256": (lambda: _gapped(512, 5120, 256, seed=9), 256, 1, np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas(case, jps, jax_omega):
    import jax.numpy as jnp

    make, rank, n_power, dtype = CASES[case]
    b = make().astype(dtype)
    I, J = b.shape
    jq, jr = jps.polar_split_pallas(jnp.asarray(b), rank, n_power=n_power, interpret=True)
    launches = tps.polar_split.launches
    tq, tr = tps.polar_split(torch.as_tensor(b), rank, n_power=n_power)
    assert tps.polar_split.launches == launches  # CPU: the plain version
    assert tq.shape == (I, rank) and tr.shape == (rank, J)
    assert tq.dtype == tr.dtype == torch.as_tensor(b).dtype
    q, want_q = _np(tq), _np(jq)
    assert np.abs(q - want_q).max() < Q_TOL
    assert np.abs(q @ q.T - want_q @ want_q.T).max() < Q_TOL
    assert np.abs(_np(tr) - _np(jr)).max() < R_TOL * np.abs(b).max()
    if case == "dead_rows":
        assert float(tq[32:].abs().max()) == 0.0 == float(np.abs(want_q[32:]).max())
    if rank > I:
        assert float(tq[:, I:].abs().max()) == 0.0 == float(tr[I:].abs().max())


@pytest.mark.parametrize("J", [1280, 5120])
def test_two_decade_spectra_match_pallas_by_r_and_capture(J, jps, jax_omega):
    """The JAX package's own test matrices (``tests/test_split_kernel.py``):
    R and the captured energy; Q's weakest columns are set by rounding."""
    import jax.numpy as jnp

    b = _gapped(128, J, 64, seed=J, decay_top=2.0)
    jq, jr = jps.polar_split_pallas(jnp.asarray(b), 64, interpret=True)
    tq, tr = tps.polar_split(torch.as_tensor(b), 64)
    assert np.abs(_np(tr) - _np(jr)).max() < R_TOL * np.abs(b).max()
    top = (np.linalg.svd(b.astype(np.float64), compute_uv=False)[:64] ** 2).sum()
    cap, want = (_np(tr) ** 2).sum() / top, (_np(jr) ** 2).sum() / top
    assert abs(cap - want) < 1e-5 and cap > 1 - 1e-5


@pytest.mark.parametrize("I,J", [(96, 300), (128, 5120), (256, 2560), (1024, 10240), (5, 7)])
def test_padding_matches_jax(I, J, jps):
    assert tps._tile_j(I, J) == jps._tile_j(I, J)


def test_omega_is_drawn_at_the_padded_length(monkeypatch):
    """Omega comes from ``ops.svd.rangefinder_omega`` at ``J + pad`` rows, of
    which the split uses the first J."""
    asked = []
    real = tsvd.rangefinder_omega

    def spy(J, q, dtype=torch.float32, device=None):
        asked.append((J, q))
        return real(J, q, dtype, device)

    monkeypatch.setattr(tsvd, "rangefinder_omega", spy)
    tps.polar_split(torch.as_tensor(_gapped(96, 300, 48, seed=0)), 48)
    assert asked == [(300 + tps._tile_j(96, 300)[2], 48)]


def test_matches_the_ports_other_polar_splits(jax_omega):
    """One matrix, one Omega (J needs no padding): K8's split, the two-stage
    split (K5 + K1) and the hybrid split (K1) take the same subspace."""
    b = torch.as_tensor(_gapped(128, 1280, 64, seed=7))
    assert tps._tile_j(128, 1280)[2] == 0
    q8, r8 = tps.polar_split(b, 64)
    for split in (tps.polar_split_two_stage, tps.hybrid_polar_split):
        q, r = split(b, 64)
        assert np.abs(_np(q8 @ q8.T) - _np(q @ q.T)).max() < PROJ_TOL
        assert np.abs(_np(q8 @ r8) - _np(q @ r)).max() < REC_TOL * float(b.abs().max())


def test_wrapper_rejects_a_device_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        tps.polar_split(torch.zeros((8, 16), device="meta"), 4)


def _card_agreement(b, q, r, qp):
    q64, p64, b64 = q.double(), qp.double(), b.double()
    proj = float((q64 @ q64.T - p64 @ p64.T).abs().max())
    rec = float((q64 @ r.double() - p64 @ (p64.T @ b64)).abs().max() / b64.abs().max())
    live = torch.linalg.vector_norm(q64, dim=0) > 0.5
    eye = torch.eye(int(live.sum()), dtype=torch.float64, device=q.device)
    iso = float((q64[:, live].T @ q64[:, live] - eye).abs().max())
    return proj, rec, iso


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["two_site", "multi_chunk", "padded_two_rounds", "dead_rows",
                                  "rank_above_rows", "flagship", "m256"])
def test_kernel_matches_plain_on_card(case, cuda):
    if case == "flagship":  # the two-site matrix's shape at N=196, M=128, L=10
        b, rank, n_power = _gapped(256, 2560, 128, seed=8), 128, 1
    else:
        make, rank, n_power, _ = CASES[case]
        b = make()
    bt = torch.as_tensor(b, device=cuda)
    launches = tps.polar_split.launches
    q, r = tps.polar_split(bt, rank, n_power=n_power)
    torch.cuda.synchronize()
    assert tps.polar_split.launches == launches + 1
    qp, rp = tps.polar_split_reference(bt, rank, n_power=n_power)
    assert q.shape == qp.shape and r.shape == rp.shape and bool(torch.isfinite(q).all())
    proj, rec, iso = _card_agreement(bt, q, r, qp)
    assert proj < PROJ_TOL and rec < REC_TOL and iso < ISO_TOL, (proj, rec, iso)
    if case == "dead_rows":
        assert float(q[32:].abs().max()) == 0.0
    again = tps.polar_split(bt, rank, n_power=n_power)  # no atomics: the same bits
    assert torch.equal(q, again[0]) and torch.equal(r, again[1])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    b = torch.randn((16, 64), device=cuda)
    with pytest.raises(TypeError):
        tps.polar_split(b.double(), 8)
    with pytest.raises(ValueError):
        tps.polar_split(b.T, 8)  # not contiguous
    with pytest.raises(ValueError):
        tps.polar_split(b[:, :0], 8)


@pytest.mark.cuda
@pytest.mark.parametrize("I,J,q", [(256, 2560, 128), (512, 5120, 256)])
def test_kernel_is_the_two_stage_split_bit_for_bit(I, J, q, cuda):
    """The flagship's and M=256's two-site shapes: one Omega (no pad), K5's
    tiles and sums, then K1, in one chain or as two calls."""
    assert tps._tile_j(I, J)[2] == 0
    bt = torch.as_tensor(_gapped(I, J, q, seed=I + q), device=cuda)
    q8, r8 = tps.polar_split(bt, q)
    q2, r2 = tps.polar_split_two_stage(bt, q)
    torch.cuda.synchronize()
    assert torch.equal(q8.view(torch.int32), q2.view(torch.int32))
    assert torch.equal(r8.view(torch.int32), r2.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("I,J,q", [(256, 2560, 128), (512, 5120, 256), (96, 300, 48),
                                   (32, 128, 32), (130, 1000, 60)])
def test_scratch_parts_start_on_256_byte_boundaries(I, J, q, cuda):
    """Every part of K8's scratch, K5's partials and K1's scratch included,
    starts a whole number of 64 floats in, in order, inside the size the
    wrapper allocates."""
    layout = tps.split_scratch_layout(I, J, q)
    offsets = list(layout.values())
    assert len(offsets) == 8 and all(o % 64 == 0 for o in offsets), layout
    assert offsets == sorted(offsets) and offsets[0] == 0
    assert layout["floats"] == tps._split_lib().tnml_polar_split_scratch_floats(I, J, q)
    assert layout["G"] - layout["y"] >= I * q and layout["n2"] - layout["G"] >= I * I
