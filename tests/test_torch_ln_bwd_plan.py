"""K7's backward on the CPU: the plan of ``csrc/layernorm.cu``'s backward
(``ops/fused_layernorm.bwd_plan``: road, CTAs, the rows of each warp or
CTA, the partial rows) and its plain version ``layernorm_bwd_ref`` against
``jax.vjp`` of fast3r_tpu's ``fused_layernorm`` (its Pallas backward in
interpret mode) in bfloat16.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from fast3r_torch.ops import fused_layernorm as tln
from fast3r_tpu.ops import fused_layernorm as jln


@pytest.mark.parametrize("rows,C,itemsize,aligned,road", [
    (15360, 1024, 2, True, "warp"),   # the blocks' shape, bf16
    (15360, 1024, 4, True, "warp"),   # 4 KB rows, one CTA an SM
    (300, 1024, 4, True, "warp"), (10, 5 * 64, 2, True, "warp"),
    (7, 96, 2, True, "warp"), (1, 8, 2, True, "warp"),
    (100000, 64, 2, True, "warp"),
    (4, 16384, 4, True, "cta"), (3000, 2056, 2, True, "cta"),
    (9, 100, 2, True, "scalar"), (33, 512, 2, False, "scalar"),
    (5000, 17, 4, True, "scalar")])
def test_bwd_plan_covers_every_row_once(rows, C, itemsize, aligned, road):
    plan = tln.bwd_plan(rows, C, itemsize, aligned, sms=132)
    assert plan.road == road
    seen = np.zeros(rows, np.int32)
    for g in range(plan.groups()):
        for r in plan.rows_of(g):
            seen[r] += 1
    assert np.all(seen == 1)
    # every CTA (warp road), CTA (CTA road) or warp (scalar road) writes
    # one partial row: as many as the grid has of them
    per = {"warp": 1, "cta": 1, "scalar": tln.BWD_WARPS}[road]
    assert plan.partials == plan.ctas * per
    if road == "warp":  # the CTAs that fit at once, no more than the rows
        assert plan.ctas == min(-(-rows // 8),
                                (2 if C * itemsize <= 2048 else 1) * 132)
    if road == "scalar":
        assert plan.partials <= 128


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("M,C", [(64, 1024), (40, 100)])
def test_layernorm_bwd_ref_matches_jax_vjp_bf16(M, C):
    """bf16 x and dy, fp32 scale: dx rounds once from fp32 on both sides
    (summation order apart: one bf16 step, 1e-2 + 2^-7 relative); dscale
    and dbias are fp32 sums over the rows in another order (1e-4)."""
    rng = np.random.default_rng(3)
    x = _bf16(rng.standard_normal((M, C)) * 3 + 1)
    dy = _bf16(rng.standard_normal((M, C)))
    s = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    assert jln._pick_rows(M, C, live_tiles=8) > 0  # the Pallas backward
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x_, s_, b_: jln.fused_layernorm(x_, s_, b_, 1e-6),
                         jnp.asarray(x, jnp.bfloat16), jnp.asarray(s),
                         jnp.asarray(b))
        jdx, jds, jdb = vjp(jnp.asarray(dy, jnp.bfloat16))
    dx, dw, db = tln.layernorm_bwd_ref(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s),
        torch.from_numpy(dy).to(torch.bfloat16), 1e-6)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jds), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-4,
                               atol=1e-4)
