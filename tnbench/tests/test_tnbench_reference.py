"""The plain reference against the port's plain CPU path, in float64, at a
small size: scores, both splits and whole epochs.

The port's plain splits compute in float32 whatever their input (as its
kernels do), so the splits are held against the port's plain pieces run in
float64 (``polar_iterate_reference``, ``hqr_orth``), and the epochs against
the port's ``xla`` engine with its split replaced by those float64 pieces.
"""

import pytest
import torch

from tensornetworkforml_torch.models.mps import MPS, mps_forward
from tensornetworkforml_torch.models.serving import Predictor
from tensornetworkforml_torch.ops import svd as port_svd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels.polar_split import polar_iterate_reference
from tensornetworkforml_torch.ops.kernels.split_kernel import hqr_orth
from tensornetworkforml_torch.train import sweep as port_sweep
from tensornetworkforml_torch.train.epoch import fused_epoch
from tensornetworkforml_torch.train.sweep import SweepConfig, one_hot_labels, sweep_once

from tnbench import gen, train
from tnbench.reference import mps as ref

CFG = {"N": 16, "D": 2, "M": 6, "L": 10, "image_side": 8, "pool": 2}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    g = gen.generator(2 ** 40 + 17, CPU)
    cal, _ = gen.images(g, 64, CFG)
    sites, label = gen.product_weights(g, CFG, cal)
    x, y = gen.images(g, 4 * 16, CFG)
    fresh, _ = gen.images(g, 40, CFG)
    return sites, label, x.reshape(4, 16, -1), y.reshape(4, 16), fresh


def _port_polar64(bmat, rank):
    I, J = bmat.shape
    q_cols = min(rank, I)
    om = port_svd.rangefinder_omega(J, q_cols, torch.float64, bmat.device)
    q = polar_iterate_reference(bmat @ om, bmat @ bmat.T, dead_tol=ref.DEAD_TOL)
    if q_cols < rank:
        q = torch.cat([q, q.new_zeros((I, rank - q_cols))], dim=1)
    return q, q.T @ bmat


def _port_rangefinder64(bmat, rank, oversample=8, n_iter=6):
    I, J = bmat.shape
    q_cols = min(rank + oversample, I)
    bs = bmat / (torch.sqrt((bmat * bmat).sum()) + 1e-30)
    y = bs @ port_svd.rangefinder_omega(J, q_cols, torch.float64, bmat.device)
    g = bs @ bs.T
    for _ in range(n_iter):
        y = g @ hqr_orth(port_svd._colnorm(y))
    q = hqr_orth(port_svd._colnorm(y))[:, :rank]
    return q, q.T @ bmat


PORT_SPLITS = {"polar": _port_polar64, "rangefinder": _port_rangefinder64}


def test_scores_match_port(data):
    sites, label, _, _, fresh = data
    m = MPS(sites.double(), label.double(), l_pos=0, act_fn="linear", loss_fn="MSE")
    want = mps_forward(m, psi_embed(fresh.double())).T
    got = ref.scores(sites, label, fresh, block=16)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    served = Predictor(m, batch_size=16, device="cpu").scores(fresh.double().numpy())
    assert abs(served - got.numpy()).max() <= 1e-12 * abs(served).max()


@pytest.mark.parametrize("split", ["polar", "rangefinder"])
def test_split_matches_port(split):
    g = torch.Generator().manual_seed(5)
    for I, J, rank in [(12, 60, 6), (32, 80, 16), (8, 40, 6)]:
        b = torch.randn((I, J), generator=g, dtype=torch.float64)
        b[:, : J // 2] *= 1e-3  # a spread spectrum
        q, r = ref.SPLITS[split](b, rank)
        qp, rp = PORT_SPLITS[split](b, rank)
        # the same subspace and the same factors (Householder and LAPACK
        # reflectors share their sign convention)
        assert (q @ q.T - qp @ qp.T).abs().max() < 1e-10
        assert (q @ r - qp @ rp).abs().max() < 1e-10 * b.abs().max()


@pytest.mark.parametrize("split", ["polar", "rangefinder"])
def test_sweep_matches_port(data, split, monkeypatch):
    sites, label, x, y, _ = data
    monkeypatch.setattr(port_sweep, "truncated_svd_split",
                        lambda bmat, rank, method, **kw: PORT_SPLITS[method](bmat, rank))
    cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                      svd_method=split, engine="xla")
    m = MPS(sites.double(), label.double(), l_pos=0, act_fn="linear", loss_fn="MSE")
    new, _, _, metrics = sweep_once(m, psi_embed(x[0].double()),
                                    one_hot_labels(y[0], CFG["L"], torch.float64), 0.05, 1e-5, cfg)
    s_r, l_r, mae = ref.epoch(sites, label, x[:1], y[:1], 0.05, 1e-5, split)
    assert ((metrics["MAE"] - mae[0]).abs() / mae[0]).max() < 1e-10
    if split == "polar":  # the rangefinder's columns past B's rank differ (below)
        assert (new.sites - s_r).abs().max() < 1e-8
        assert (new.label_site - l_r).abs().max() < 1e-8 * l_r.abs().max()


# Over more sweeps the rangefinder's two float64 codes part: it keeps columns
# past B's rank at the chain's edge steps, rounding directions that LAPACK's
# Householder QR and the port's reflector loop pick differently, and the
# next steps' gradients grow them (8.5e-5 of the MAE after two epochs here);
# the polar split zeroes them below its dead-column tolerance
def test_epochs_match_port(data, monkeypatch):
    sites, label, x, y, fresh = data
    monkeypatch.setattr(port_sweep, "truncated_svd_split",
                        lambda bmat, rank, method, **kw: PORT_SPLITS[method](bmat, rank))
    cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                      svd_method="polar", engine="xla")
    m = MPS(sites.double(), label.double(), l_pos=0, act_fn="linear", loss_fn="MSE")
    s_r, l_r = sites, label
    for e in range(2):
        xe, ye = x[2 * e:2 * e + 2], y[2 * e:2 * e + 2]
        m, _, metrics = fused_epoch(m, xe.double(), ye, 0.05, 1e-5, cfg)
        s_r, l_r, mae = ref.epoch(s_r, l_r, xe, ye, 0.05, 1e-5, "polar")
        assert ((metrics["MAE"] - mae).abs() / mae).max() < 1e-10
        fp, fr = ref.scores(m.sites, m.label_site, fresh), ref.scores(s_r, l_r, fresh)
        assert (fp - fr).abs().max() < 1e-10 * fr.abs().max()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -12, 0.0])
    r = ref.tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0, 0.0]


@pytest.mark.parametrize("split", ["polar", "rangefinder"])
def test_isometry_gap_of_an_epoch(data, split, monkeypatch):
    # after an epoch every non-label site is a factor of the left sweep's
    # split: isometric rows; the initial product state's are not
    sites, label, x, y, _ = data
    monkeypatch.setattr(port_sweep, "truncated_svd_split",
                        lambda bmat, rank, method, **kw: PORT_SPLITS[method](bmat, rank))
    cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                      svd_method=split, engine="xla")
    m = MPS(sites.double(), label.double(), l_pos=0, act_fn="linear", loss_fn="MSE")
    m, _, _ = fused_epoch(m, x[:2].double(), y[:2], 0.05, 1e-5, cfg)
    assert train.isometry_gaps(m.sites).median() < 1e-10
    assert train.isometry_gaps(sites).median() > 0.1
