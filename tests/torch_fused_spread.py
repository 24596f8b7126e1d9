"""Float32 spreads behind the fused engine's tolerances
(``tests/test_torch_step_kernel.py`` and ``chip_smoke.py``'s K7 check), on the
CPU:

1. K7's renormalisation factor: ``gg`` (the largest column norm of
   ``a_left``) and the row norms of ``lenv_new``, float32 against float64 of
   the plain version, at the card test's shapes with ``renorm_envs``;
2. fused sweeps with weight decay on the JAX package's fused-test inputs:
   each package's float32 sweep against a float64 run of the port's sweep, on
   the JAX weight-decay test's draw (seed 3, decay 0.3) and 16 others;
3. on seeds 3 and 11, the live columns of Q per step, float32 against float64.

Run from the root of the repository (JAX on the CPU):
``JAX_PLATFORMS=cpu python -m tests.torch_fused_spread``.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU, float64 enabled)
from tensornetworkforml_torch.models.mps import mps_forward
from tensornetworkforml_torch.ops import svd as tsvd
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels import step_kernel as tsk
from tensornetworkforml_torch.train import sweep as tsw
from tests import test_torch_step_kernel as tk
from tests.test_torch_sweep import _both_sweeps


def renorm_spread():
    for L, M, B, kw in tk.CARD_CASES:
        kw = {**kw, "renorm_envs": True}
        a32 = [torch.as_tensor(v) for v in tk._inputs(L, M, 2, B, seed=M + B).values()]
        o32, o64 = (tsk.two_site_step_reference(*a, 0.5, 1e-3, **kw)
                    for a in (a32, [t.double() for t in a32]))
        gg = [torch.linalg.vector_norm(o[0].double(), dim=0).max() for o in (o32, o64)]
        rows = [torch.linalg.vector_norm(o[2].double(), dim=1) for o in (o32, o64)]
        print(f"[renorm] L={L} M={M} B={B} {kw}: gg rel {float(abs(gg[0] / gg[1] - 1)):.2e}, "
              f"|lenv_new[b]| {tk._rel(*rows):.2e} of max")


def weight_decay_spread(monkeypatch):
    import jax.numpy as jnp

    from tensornetworkforml_tpu.models.mps import mps_forward as jfw
    from tensornetworkforml_tpu.ops.embedding import psi_embed as jpsi

    for seed, wd in [(3, 0.3)] + [(s, w) for s in range(4, 12) for w in (0.3, 1e-5)]:
        j, t, x, y, fresh = tk._jax_test_inputs(seed)
        jres, tres = _both_sweeps(j, t, x, y, tk._fused(), lr=0.1, wd=wd)
        w = tk._fused_sweep_float64(j, x, y, wd, monkeypatch)
        want = tk._np(mps_forward(w[0], psi_embed(torch.as_tensor(fresh))))
        port = tk._np(mps_forward(tres[0], psi_embed(torch.as_tensor(fresh, dtype=torch.float32))))
        jax = tk._np(jfw(jres[0], jpsi(jnp.asarray(fresh, dtype=jnp.float32))))
        d = lambda a, b: np.abs(a - b).max()  # noqa: E731
        print(f"[decay] seed {seed} decay {wd:g}: f_final vs float64 port "
              f"{d(tk._np(tres[2]), tk._np(w[2])):.2e} jax {d(tk._np(jres[2]), tk._np(w[2])):.2e}; "
              f"fresh vs float64 port {d(port, want):.2e} jax {d(jax, want):.2e}")


def live_columns(monkeypatch):
    seen = []
    step = tsw.two_site_step

    def spy(*a, **k):
        out = step(*a, **k)
        seen.append(int((torch.linalg.vector_norm(out[0], dim=0) > 0.5).sum()))
        return out

    monkeypatch.setattr(tsw, "two_site_step", spy)
    for seed in (3, 11):
        j, t, x, y, _ = tk._jax_test_inputs(seed)
        y1h = torch.as_tensor(np.eye(j.L)[y].T)
        tsw.sweep_once(t, psi_embed(torch.as_tensor(x)), y1h, 0.1, 0.3,
                       tsw.SweepConfig(**tk._fused()))
        f32, seen[:] = list(seen), []
        tk._fused_sweep_float64(j, x, y, 0.3, monkeypatch)
        print(f"[live] seed {seed} decay 0.3: live columns per step float32 {f32}, "
              f"float64 {seen}")
        seen.clear()


if __name__ == "__main__":
    import jax.numpy as jnp

    from tensornetworkforml_tpu.ops.svd import _rangefinder_omega

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsvd, "rangefinder_omega", lambda J, q, dtype=torch.float32, device=None:
                   torch.as_tensor(np.array(_rangefinder_omega(J, q, jnp.float32))).to(
                       dtype=dtype, device=device))
        renorm_spread()
        weight_decay_spread(mp)
        live_columns(mp)
