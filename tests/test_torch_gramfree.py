"""The large-bond polar splits: K4a, K4b and K5's plain versions against the
JAX package's Pallas kernels (interpret mode on the CPU), ``gramfree_split``
and ``polar_split_two_stage`` against the JAX ones, the dispatch of
``svd_method="polar"`` by shape, and the CUDA kernels against their plain
versions on a card.

JAX is imported inside the fixtures and tests, so that the tests marked
``cuda`` run on a machine with a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_gramfree.py``.

Tolerances:
* the reductions (``B Omega``, ``B (B^T y)``, ``B B^T``, ``|B|_F^2``) are
  float32 sums of at most a few hundred terms in another order: 1e-5 of each
  output's largest entry;
* the splits, compared by the projector ``Q Q^T`` in float32: 1e-5 with the
  Newton-Schulz engine (as K1's tests: both sides run the same ~40
  dependent products over a gapped spectrum), 1e-4 with the CholQR engine
  (as the cholqr split's tests: a Cholesky in float32 of a Gram with a
  ridge of ~1e-5);
* ``Q R = Q Q^T B`` relative to max|B|: each entry sums I projector
  entries times entries of B in random signs, so the projector's tolerance
  grows by sqrt(I) ~ 10 at the I <= 96 here: 1e-4 (measured up to 2e-5);
* on the card, against a float64 run of the plain version: 1e-4 of the
  output's largest entry (float32 sums of up to 10^4 terms in another order;
  K4a and K4b run in 3xTF32 on the tensor cores, about ten times float32's
  error and measured up to 2.2e-5; TF32 alone reads above the limit, in an
  emulation on the CPU and in cuBLAS on the card);
* K4a and K4b's one-pass TF32 form on the card: against the plain product of
  the TF32-rounded operands (summed in float64, ``t`` rounded to float32 and
  TF32 between K4b's halves, as in the kernel), 5e-5 of the output's max
  (only the order of the float32 sums differs, and K4b's ``t`` can round the
  other way where its float32 sum sits on a TF32 tie: measured up to 1.4e-5
  at M=512 on an H100); against float64, 1e-3 (each product rounds its
  operands to TF32: measured up to 4.7e-4, as the emulation in
  ``tests/test_torch_precision.py`` and cuBLAS with TF32 read).
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.kernels import _build
from tensornetworkforml_torch.ops.kernels import polar_split as tps

RED_TOL = 1e-5
NS_TOL, CHOLQR_TOL = 1e-5, 1e-4
REC_TOL = 1e-4
CARD_TOL = 1e-4
ONE_PASS_PLAIN_TOL, ONE_PASS_TOL = 5e-5, 1e-3


@pytest.fixture
def jps():
    from tensornetworkforml_tpu.ops.kernels import polar_split

    return polar_split


@pytest.fixture
def jax_omega(monkeypatch, jps):
    """Make the port sketch with the JAX package's Omega. ``gramfree_split``
    in JAX pads J to its J-tile and draws Omega at the padded length, whose
    first J rows meet B; ``rows`` names the I of such a split."""
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    def use(gramfree_rows=None):
        def omega(J, q, dtype=torch.float32, device=None):
            pad = 0 if gramfree_rows is None else jps._tile_j(gramfree_rows, J, 2 ** 20)[2]
            om = np.array(_rangefinder_omega(J + pad, q, jnp.float32))[:J]
            return torch.as_tensor(om).to(dtype=dtype, device=device)

        monkeypatch.setattr(tsvd, "rangefinder_omega", omega)

    return use


@pytest.fixture
def pallas_calls(monkeypatch, jps):
    """Record the inputs and outputs of every Pallas call the JAX package's
    polar_split module makes."""
    calls = []
    real = jps.pl

    class Spy:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def pallas_call(*args, **kwargs):
            fn = real.pallas_call(*args, **kwargs)

            def run(*inputs):
                out = fn(*inputs)
                calls.append(([np.asarray(a) for a in inputs],
                              [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]))
                return out

            return run

    monkeypatch.setattr(jps, "pl", Spy())
    return calls


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sketch kernels have no CPU mode")
    return torch.device("cuda")


def _gapped(I, J, rank, seed, dead_rows=0, dead_cols=()):
    """A matrix with a kept spectrum over half a decade and a gap of 10 below
    it; optionally zero rows (padded bond slots) and zero columns."""
    r = np.random.default_rng(seed)
    k = min(I, J)
    u, _ = np.linalg.qr(r.standard_normal((I, k)))
    v, _ = np.linalg.qr(r.standard_normal((J, k)))
    s = np.ones(k)
    s[:rank] = np.logspace(0, -0.5, rank)
    s[rank:] = s[rank - 1] * 0.1 * np.logspace(0, -2, k - rank)
    b = (u * s) @ v.T
    if dead_rows:
        b[I - dead_rows :] = 0.0
    b[:, list(dead_cols)] = 0.0
    return b.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _proj_err(qa, qb):
    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    return np.abs(qa @ qa.T - qb @ qb.T).max()


# ragged: J off the 128-column tile (JAX pads it), q odd, zero columns
SHAPES = {"even": (64, 384, 32, ()), "ragged": (37, 301, 13, (0, 5, 300))}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gramfree_reductions_match_pallas(shape, jps, pallas_calls):
    """K4a and K4b's plain versions on the inputs the Pallas kernels got."""
    import jax.numpy as jnp

    I, J, rank, dead = SHAPES[shape]
    b = _gapped(I, J, rank, seed=I, dead_cols=dead)
    jps.gramfree_split.__wrapped__(jnp.asarray(b), rank, interpret=True)  # eager: spied
    (sk_in, (y0, n2)), (gm_in, (z,)) = pallas_calls
    om = torch.as_tensor(sk_in[1][:J])  # the padded rows meet zero columns of B
    bt = torch.as_tensor(b)
    launches = tps.gramfree_sketch.launches, tps.gramfree_gmul.launches
    got_y0, got_n2 = tps.gramfree_sketch(bt, om)  # CPU: the plain version
    got_z = tps.gramfree_gmul(bt, torch.as_tensor(gm_in[1]))
    assert (tps.gramfree_sketch.launches, tps.gramfree_gmul.launches) == launches
    assert got_y0.shape == (I, rank) and got_n2.shape == (1, 1) and got_z.shape == (I, rank)
    assert _rel(got_y0, y0) < RED_TOL and _rel(got_n2, n2) < RED_TOL
    assert _rel(got_z, z) < RED_TOL
    assert torch.equal(got_y0, tps.gramfree_sketch_reference(bt, om)[0])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sketch_gram_plain_version_matches_pallas(shape, jps):
    import jax.numpy as jnp

    I, J, rank, dead = SHAPES[shape]
    b = _gapped(I, J, rank, seed=I + 1, dead_cols=dead)
    om = np.random.default_rng(2).standard_normal((J, rank)).astype(np.float32)
    want = jps.polar_sketch_gram_pallas(jnp.asarray(b), jnp.asarray(om), interpret=True)
    launches = tps.polar_sketch_gram.launches
    got = tps.polar_sketch_gram(torch.as_tensor(b), torch.as_tensor(om))
    assert tps.polar_sketch_gram.launches == launches
    assert [tuple(g.shape) for g in got] == [(I, rank), (I, I), (1, 1)]
    for g, w in zip(got, want):
        assert _rel(g, w) < RED_TOL


SPLITS = {
    "odd": (96, 300, 48, 0, ()),  # the JAX package's own odd shape
    "ragged_dead": (37, 301, 13, 5, (0, 5, 300)),  # zero rows and columns
    "rank_above_rows": (12, 150, 16, 0, ()),  # q_cols = I < rank: padded slots
}


@pytest.mark.parametrize("case", sorted(SPLITS))
@pytest.mark.parametrize("orth", ["ns", "cholqr"])
def test_gramfree_split_matches_jax(case, orth, jps, jax_omega):
    import jax.numpy as jnp

    I, J, rank, dead_rows, dead_cols = SPLITS[case]
    b = _gapped(I, J, min(rank, I), seed=J, dead_rows=dead_rows, dead_cols=dead_cols)
    jax_omega(gramfree_rows=I)
    jq, jr = jps.gramfree_split(jnp.asarray(b), rank, interpret=True, orth=orth)
    tq, tr = tps.gramfree_split(torch.as_tensor(b), rank, orth=orth)
    assert tq.shape == (I, rank) and tr.shape == (rank, J) and tq.dtype == torch.float32
    tol = NS_TOL if orth == "ns" else CHOLQR_TOL
    assert _proj_err(tq, jq) < tol
    rec = np.abs((tq @ tr).double().numpy() - np.asarray(jq, np.float64) @ np.asarray(jr))
    assert rec.max() / np.abs(b).max() < max(tol, REC_TOL)
    if dead_rows:
        assert float(tq[I - dead_rows :].abs().max()) == 0.0
    if rank > I:
        assert float(tq[:, I:].abs().max()) == 0.0 == float(tr[I:].abs().max())


def test_gramfree_split_keeps_the_input_dtype_and_computes_in_float32():
    b = _gapped(40, 200, 8, seed=3).astype(np.float64)
    q64, r64 = tps.gramfree_split(torch.as_tensor(b), 8)
    q32, r32 = tps.gramfree_split(torch.as_tensor(b, dtype=torch.float32), 8)
    assert q64.dtype == r64.dtype == torch.float64
    assert torch.equal(q64.float(), q32) and torch.equal(r64.float(), r32)


def test_gramfree_split_rejects_reduced_precision_and_unknown_options():
    """Reduced ``precision`` and ``ns_prec`` are ported: on the CPU each gives
    the float32 split bit for bit (on the card K4a and K4b then run in one
    TF32 pass); a name outside the table and an unknown orth raise."""
    b = torch.as_tensor(_gapped(16, 64, 4, seed=1))
    want = tps.gramfree_split(b, 4)
    for kw in (dict(ns_prec="high"), dict(precision="high"),
               dict(precision="tensorfloat32", ns_prec="bfloat16", orth="ns")):
        assert all(torch.equal(u, v) for u, v in zip(tps.gramfree_split(b, 4, **kw), want)), kw
    with pytest.raises(ValueError, match="orth"):
        tps.gramfree_split(b, 4, orth="qr")
    with pytest.raises(ValueError, match="precision"):
        tps.gramfree_split(b, 4, precision="bf16")
    q, _ = tps.gramfree_split(b, 4, precision="highest", ns_prec="default")
    assert torch.equal(q, tps.gramfree_split(b, 4)[0])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rank", [24, 80])
def test_polar_split_two_stage_matches_jax(dtype, rank, jps, jax_omega):
    """K5 then K1 with the explicit n2; dead_tol follows the input dtype."""
    import jax.numpy as jnp

    I, J = 64, 330
    b = _gapped(I, J, min(rank, I), seed=rank, dead_rows=8).astype(dtype)
    jax_omega()
    jq, jr = jps.polar_split_two_stage(jnp.asarray(b), rank, interpret=True)
    tq, tr = tps.polar_split_two_stage(torch.as_tensor(b), rank)
    assert tq.dtype == getattr(torch, dtype) and tq.shape == (I, rank) and tr.shape == (rank, J)
    assert _proj_err(tq, jq) < NS_TOL
    rec = np.abs((tq @ tr).double().numpy() - np.asarray(jq, np.float64) @ np.asarray(jr))
    assert rec.max() / np.abs(b).max() < REC_TOL
    assert float(tq[I - 8 :].abs().max()) == 0.0


def test_two_stage_and_hybrid_splits_agree(jax_omega):
    """Same Omega, same iteration: only where y, G and n2 come from differs."""
    b = torch.as_tensor(_gapped(48, 256, 16, seed=9))
    q1, r1 = tps.polar_split_two_stage(b, 16)
    q2, r2 = tps.hybrid_polar_split(b, 16)
    assert _proj_err(q1, q2) < NS_TOL
    assert float((q1 @ r1 - q2 @ r2).abs().max() / b.abs().max()) < REC_TOL


@pytest.mark.parametrize("I,route", [(768, "hybrid_polar_split"), (776, "gramfree_split")])
def test_polar_method_dispatches_by_shape(I, route, monkeypatch):
    """Above 768 rows the polar split is gram-free, at and below it hybrid,
    on every device (the JAX package's dispatch on its chip)."""
    seen = []
    for name in ("hybrid_polar_split", "gramfree_split"):
        monkeypatch.setattr(tps, name, lambda b, r, _n=name: seen.append(_n) or (b, r))
    b = torch.zeros((I, 4))
    tsvd.truncated_svd_split(b, 2, "polar", split_mode="canonical")
    assert seen == [route]


def test_sketch_wrappers_reject_a_device_they_have_no_kernel_for():
    b, om = torch.zeros((4, 6)), torch.zeros((6, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tps.gramfree_sketch(b.to("meta"), om.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tps.polar_sketch_gram(b, om.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tps.gramfree_gmul(b.to("meta"), torch.zeros((4, 2), device="meta"))


# ---- 3xTF32, emulated on the CPU --------------------------------------------------

def _tf32(x):
    """float32 -> tf32 by round-to-nearest (ties away), as ``cvt.rna.tf32.f32``:
    the low 13 mantissa bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_3xtf32(a, b):
    """The tensor-core kernels' product: hi = tf32(x), lo = tf32(x - hi) for
    each operand, lo.hi + hi.lo, then hi.hi, summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _ill_scaled(I, J, q, seed):
    """B with row scales spanning 1e-3 to 1e3 (shuffled), Omega and an
    orthonormal y1."""
    r = np.random.default_rng(seed)
    scale = np.logspace(-3, 3, I)[r.permutation(I)]
    b = (r.standard_normal((I, J)) / np.sqrt(J) * scale[:, None]).astype(np.float32)
    om = r.standard_normal((J, q)).astype(np.float32)
    y1 = np.linalg.qr(r.standard_normal((I, q)))[0].astype(np.float32)
    return b, om, y1


def test_3xtf32_holds_the_card_limit_where_tf32_alone_does_not():
    """A numpy emulation of the product K4a and K4b run on the card: on an
    ill-scaled B, 3xTF32 stays within the card tests' limit (CARD_TOL of
    each output's max, against float64), TF32 alone does not. So the limit
    tells the two forms apart."""
    b, om, y1 = _ill_scaled(64, 384, 32, seed=0)
    b64 = b.astype(np.float64)
    want_y0, want_z = b64 @ om, b64 @ (b64.T @ y1)
    bt = np.ascontiguousarray(b.T)
    got3 = {"y0": _mm_3xtf32(b, om), "z": _mm_3xtf32(b, _mm_3xtf32(bt, y1))}
    got1 = {"y0": _mm_tf32(b, om), "z": _mm_tf32(b, _mm_tf32(bt, y1))}
    for name, want in (("y0", want_y0), ("z", want_z)):
        assert _rel(got3[name], want) < CARD_TOL, name
        assert _rel(got1[name], want) > CARD_TOL, name
    # the split itself: hi + lo carries x to ~2^-22 relative
    x = b.ravel()
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x) <= 2.0 ** -21 * np.abs(x))


def _mirrored(p):
    """K5's G from a full product: each element on or above the diagonal (of
    the upper triangle's tiles) written at (i, j) and (j, i)."""
    g = np.triu(p)
    return g + np.triu(g, 1).T


@pytest.mark.parametrize("shape", [(64, 384, 32), (256, 2560, 128)])
def test_3xtf32_gram_is_symmetric_and_holds_the_card_limit(shape):
    """A numpy emulation of K5's G on the card: the 3xTF32 product, its upper
    triangle mirrored, is exactly symmetric and within CARD_TOL of its max
    against float64 on an ill-scaled B, and an order of magnitude closer than
    TF32 alone. TF32 alone reads below CARD_TOL on G too (its largest entries
    are sums of squares, whose roundings do not add up), so on K5 the limit
    tells the two forms apart by y, as on K4a."""
    I, J, q = shape
    b, om, _ = _ill_scaled(I, J, q, seed=q)
    b64 = b.astype(np.float64)
    want_g, want_y = b64 @ b64.T, b64 @ om
    bt = np.ascontiguousarray(b.T)
    g3 = _mirrored(_mm_3xtf32(b, bt))
    g1 = _mirrored(_mm_tf32(b, bt))
    assert np.array_equal(g3, g3.T)
    assert _rel(g3, want_g) < CARD_TOL
    assert _rel(g3, want_g) < _rel(g1, want_g) / 10
    assert _rel(_mm_3xtf32(b, om), want_y) < CARD_TOL < _rel(_mm_tf32(b, om), want_y)


# ---- on the card ---------------------------------------------------------------

# the flagship two-site matrix (I = 2M, J = L D M, q = M at M = 128), the
# M = 512 one, and a ragged shape with J off the tile, q odd and zero columns
CARD_SHAPES = {"flagship": (256, 2560, 128, ()), "m512": (1024, 10240, 512, ()),
               "ragged": (77, 1000, 47, (0, 3, 999))}


def _card_inputs(shape, cuda):
    I, J, q, dead = CARD_SHAPES[shape]
    g = torch.Generator().manual_seed(I)
    b = torch.randn((I, J), generator=g) / np.sqrt(J)
    b[:, list(dead)] = 0.0
    om = torch.randn((J, q), generator=g)
    y1 = torch.linalg.qr(torch.randn((I, q), generator=g))[0]
    return b.to(cuda), om.to(cuda), y1.contiguous().to(cuda)


def _held(got, want64):
    assert got.shape == want64.shape and torch.isfinite(got).all()
    err = float((got.double() - want64).abs().max())
    assert err <= CARD_TOL * float(want64.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernels_match_plain_on_card(shape, cuda):
    b, om, y1 = _card_inputs(shape, cuda)
    counts = (tps.gramfree_sketch.launches, tps.gramfree_gmul.launches,
              tps.polar_sketch_gram.launches)
    y0, n2 = tps.gramfree_sketch(b, om)
    z = tps.gramfree_gmul(b, y1)
    y, g, n2g = tps.polar_sketch_gram(b, om)
    torch.cuda.synchronize()
    assert (tps.gramfree_sketch.launches, tps.gramfree_gmul.launches,
            tps.polar_sketch_gram.launches) == tuple(c + 1 for c in counts)
    w_y0, w_n2 = tps.gramfree_sketch_reference(b.double(), om.double())
    _held(y0, w_y0)
    _held(n2, w_n2)
    _held(z, tps.gramfree_gmul_reference(b.double(), y1.double()))
    for got, want in zip((y, g, n2g), tps.polar_sketch_gram_reference(b.double(), om.double())):
        _held(got, want)
    assert torch.equal(g, g.T)  # one triangle computed, mirrored


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_tensor_core_kernels_hold_the_card_limit_on_an_ill_scaled_b(shape, cuda):
    """K4a, K4b and K5 (3xTF32 on the tensor cores) on a B whose row scales
    span 1e-3 to 1e3: each output within CARD_TOL of its max against the
    float64 plain version, K5's G exactly symmetric and two launches
    bit-identical. Control: the same products through cuBLAS with TF32
    allowed (TF32 alone) read above CARD_TOL on y0 and z, so the limit tells
    the two forms apart at these shapes (on G it does not: its largest
    entries are sums of squares whose TF32 roundings do not add up, see the
    emulation above)."""
    I, J, q, dead = CARD_SHAPES[shape]
    b, om, y1 = _ill_scaled(I, J, q, seed=q)
    b[:, list(dead)] = 0.0
    b, om, y1 = (torch.as_tensor(a).to(cuda) for a in (b, om, y1))
    y0, n2 = tps.gramfree_sketch(b, om)
    z = tps.gramfree_gmul(b, y1)
    sk = tps.polar_sketch_gram(b, om)
    torch.cuda.synchronize()
    w_y0, w_n2 = tps.gramfree_sketch_reference(b.double(), om.double())
    w_z = tps.gramfree_gmul_reference(b.double(), y1.double())
    _held(y0, w_y0)
    _held(n2, w_n2)
    _held(z, w_z)
    for got, want in zip(sk, tps.polar_sketch_gram_reference(b.double(), om.double())):
        _held(got, want)
    assert torch.equal(sk[1], sk[1].T)
    assert all(torch.equal(u, v) for u, v in zip(sk, tps.polar_sketch_gram(b, om)))
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = {"y0": (b @ om, w_y0), "z": (b @ (b.T @ y1), w_z)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    for name, (got, want) in tf32.items():
        assert _rel(got.double().cpu().numpy(), want.cpu().numpy()) > CARD_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["polar_sketch", "polar_iterate"])
def test_gramfree_reductions_run_on_the_tensor_cores(name, cuda):
    """The built libraries of K4a, K4b and K5 (polar_sketch) and of K8
    (polar_iterate, whose first stage is K5's) hold Hopper's tf32 warpgroup
    products (``HGMMA ... TF32`` in their SASS), not only float32 FMAs."""
    {"polar_sketch": tps._sketch_lib, "polar_iterate": tps._lib}[name]()  # builds it
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    assert any("HGMMA" in ln and "TF32" in ln for ln in sass.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_repeat_launches_are_bit_identical(shape, cuda):
    b, om, y1 = _card_inputs(shape, cuda)
    for fn, args in ((tps.gramfree_sketch, (b, om)), (tps.gramfree_gmul, (b, y1)),
                     (tps.polar_sketch_gram, (b, om))):
        first, second = fn(*args), fn(*args)
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        assert all(torch.equal(u, v) for u, v in zip(first, second)), fn.__name__


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    b, om = torch.zeros((8, 12), device=cuda), torch.zeros((12, 4), device=cuda)
    with pytest.raises(TypeError):
        tps.gramfree_sketch(b.double(), om.double())
    with pytest.raises(ValueError):
        tps.gramfree_sketch(b, om[:6])  # om not (J, q)
    with pytest.raises(ValueError):
        tps.gramfree_gmul(b, om)  # y1 not (I, q)
    with pytest.raises(ValueError):
        tps.polar_sketch_gram(torch.zeros((12, 8), device=cuda).T, om)  # not contiguous
    with pytest.raises(ValueError):
        tps.polar_sketch_gram(b, om.cpu())  # mixed devices
    with pytest.raises(ValueError):
        tps.gramfree_sketch(b, om[:, :0].contiguous())  # empty q


def _tf32_card(x):
    """float32 -> tf32 as ``cvt.rna.tf32.f32`` (ties away), on any device."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _one_pass_plain(b, om, y1):
    """K4a's and K4b's one-pass products from TF32-rounded operands, in
    float64: ``(y0, z)``, ``t`` rounded to float32 and TF32 between K4b's
    halves as the kernel stores and rereads it."""
    bt = _tf32_card(b).double()
    t = (bt.T @ _tf32_card(y1).double()).float()
    return bt @ _tf32_card(om).double(), bt @ _tf32_card(t).double()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_one_pass_kernels_match_the_tf32_rounded_plain_product(shape, cuda):
    """K4a and K4b in one TF32 pass (``gramfree_sketch_tf32``,
    ``gramfree_gmul_tf32``): one launch each, within ONE_PASS_PLAIN_TOL of the
    TF32-rounded plain product and ONE_PASS_TOL of float64, n2 to CARD_TOL,
    two launches bit-identical, and the 3xTF32 form closer to float64."""
    b, om, y1 = _card_inputs(shape, cuda)
    counts = (tps.gramfree_sketch_tf32.launches, tps.gramfree_gmul_tf32.launches)
    y0, n2 = tps.gramfree_sketch_tf32(b, om)
    z = tps.gramfree_gmul_tf32(b, y1)
    torch.cuda.synchronize()
    assert (tps.gramfree_sketch_tf32.launches, tps.gramfree_gmul_tf32.launches) == tuple(
        c + 1 for c in counts)
    w_y0, w_z = _one_pass_plain(b, om, y1)
    f_y0, f_n2 = tps.gramfree_sketch_reference(b.double(), om.double())
    f_z = tps.gramfree_gmul_reference(b.double(), y1.double())
    _held(n2, f_n2)
    for got, tf, f64, three in ((y0, w_y0, f_y0, tps.gramfree_sketch(b, om)[0]),
                                (z, w_z, f_z, tps.gramfree_gmul(b, y1))):
        assert got.shape == tf.shape and torch.isfinite(got).all()
        scale = float(f64.abs().max())
        assert float((got.double() - tf).abs().max()) <= ONE_PASS_PLAIN_TOL * scale
        err = float((got.double() - f64).abs().max())
        assert err <= ONE_PASS_TOL * scale
        assert float((three.double() - f64).abs().max()) < err
    assert torch.equal(tps.gramfree_sketch_tf32(b, om)[0], y0)
    assert torch.equal(tps.gramfree_gmul_tf32(b, y1), z)


@pytest.mark.cuda
def test_one_pass_kernels_issue_a_third_of_the_tensor_core_products(cuda):
    """In the SASS of libpolar_sketch, each one-pass GEMM kernel
    (``tf1_gemm_kernel``: K4a and K4b's two halves, ``csrc/tc_tf32.cuh``)
    holds tf32 warpgroup products (HGMMA ... TF32), one a k step of 8 of its
    chunk of 32 for each 64-row block of a warpgroup (no lo terms: four for
    K4b's halves, eight for K4a's two blocks), and each 3xTF32 instantiation
    (``tc_gemm_kernel``) keeps its six, three a k step of its chunk of 16: a
    one-pass product is a third of a 3xTF32 one."""
    tps._sketch_lib()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path("polar_sketch"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    count, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[-1].strip()
            count[fn] = 0
        elif fn and "HGMMA" in ln and "TF32" in ln:
            count[fn] += 1
    one = sorted(n for f, n in count.items() if "tf1_gemm_kernel" in f)
    three = [n for f, n in count.items() if "tc_gemm_kernel" in f]
    assert one == [4, 4, 8]  # K4b's two halves, K4a
    assert three == [6, 6, 6]


def test_one_pass_operands_start_on_16_byte_boundaries():
    """The one-pass wrappers hand the TMA operands that start on 16-byte
    boundaries: ``_aligned16`` keeps such a tensor and copies one that does
    not (a contiguous view one float in), values unchanged; on the CPU the
    one-pass wrappers of such a view give the plain version's result."""
    rng = np.random.default_rng(11)
    flat = torch.as_tensor(rng.standard_normal(1 + 24 * 40), dtype=torch.float32)
    b = flat[1:].view(24, 40)  # contiguous, 4 bytes past an aligned start
    assert b.is_contiguous() and b.data_ptr() % 16 == 4
    fixed = tps._aligned16(b)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, b)
    aligned = torch.as_tensor(rng.standard_normal((24, 40)), dtype=torch.float32)
    assert tps._aligned16(aligned) is aligned
    om = torch.as_tensor(rng.standard_normal((40, 8)), dtype=torch.float32)
    y1 = torch.as_tensor(rng.standard_normal((24, 8)), dtype=torch.float32)
    for got, want in zip(tps.gramfree_sketch_tf32(b, om), tps.gramfree_sketch_reference(b, om)):
        assert torch.equal(got, want)
    assert torch.equal(tps.gramfree_gmul_tf32(b, y1), tps.gramfree_gmul_reference(b, y1))


@pytest.mark.parametrize("entry", sorted(tps._SCRATCH))
def test_every_entry_names_its_scratch_function(entry):
    """Each C entry of K4a and K4b sizes its scratch with a function of its
    own form: the one-pass entries with the one-pass pipeline's layouts, the
    3xTF32 ones with the 3xTF32 core's, as ``csrc/polar_sketch.cu`` exports
    them."""
    src = (_build.CSRC / "polar_sketch.cu").read_text()
    name = tps._SCRATCH[entry]
    assert f"long {name}(int I, int J, int q)" in src and f"int {entry}(" in src
    assert name.startswith("tnml_gramfree_sketch" if "sketch" in entry else "tnml_gmul")
    assert name.endswith("_tf32_scratch_floats") == entry.endswith("_tf32")
