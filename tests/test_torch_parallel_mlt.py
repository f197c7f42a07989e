"""The port's sharded Metropolis renderers against the JAX package's, on 4
gloo ranks on the CPU against the 8-virtual-device CPU mesh: the 1-D
mesh with the chain pipeline windowed (and the VLP grid), the 1-D mesh
with an indivisible chain count (the light pass renders replicated, as
the JAX package's does), and the 2 x 2 rows x spp mesh, whose chains are
windowed over the flattened mesh.

Same harness and tolerances as ``tests/test_torch_parallel.py``: the
port's films against its unsharded films under the CRN contract (the
tool's checks), the gathered table bit for bit against the port's
``mlt_vlps``, and the film against the JAX sharded film at p99.5 < 5e-5
(XLA:CPU's FMA contraction; the JAX sharded render takes the port's
table through its module's ``mlt_vlps``).  The table against the JAX
``mlt_vlps`` run op by op: the live mask equal and rtol = atol = 1e-5
(``tests/test_torch_bpt_mlt.py``: compiled, a contracted multiply-add
may flip a chain's ``verify_eps`` decision).
"""

import jax
import numpy as np
import pytest

from opencl_montecarlo_path_tracing_tpu.models import metropolis as JMT
from opencl_montecarlo_path_tracing_tpu.ops import intersect as JI
from opencl_montecarlo_path_tracing_tpu.parallel import mesh as JPM
from opencl_montecarlo_path_tracing_tpu_torch.models.metropolis import (
    mlt_vlps)
from opencl_montecarlo_path_tracing_tpu_torch.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu_torch.utils.crn import crn_ok
from tests.test_torch_parallel import (
    H, JSCENE, RANKS, SPP, TSCENE, W, XLA_VLP, jax_module_attr, keys,
    run_cases, serve_windows)
from tests.test_torch_utils import _one_thread_warm_sqrt  # noqa: F401

ROUNDS = 1
SEEDS = 8          # chains a light: 2 a rank on 4 ranks
SEEDS_ODD = 6      # indivisible by 4: replicated

_FRAME = dict(scene=TSCENE, width=W, height=H, spp=SPP,
              mutation_rounds=ROUNDS)
CASES = [
    ("metropolis_vlpgrid", "check_metropolis",
     dict(spec=(RANKS,), n_seedpaths=SEEDS, use_grid=True, **_FRAME)),
    ("metropolis_indivisible", "check_metropolis",
     dict(spec=(RANKS,), n_seedpaths=SEEDS_ODD, **_FRAME)),
    ("metropolis_2d", "check_metropolis",
     dict(spec=(2, 2), n_seedpaths=SEEDS, **_FRAME)),
]
WINDOWED = {"metropolis_vlpgrid": True, "metropolis_indivisible": False,
            "metropolis_2d": True}


@pytest.fixture(scope="module")
def results():
    key, jkey = keys()
    scn = prep_scene(TSCENE)
    port_tables = {n: mlt_vlps(key, scn, n, ROUNDS, device="cpu").numpy()
                   for n in (SEEDS, SEEDS_ODD)}
    jscn = JI.prep_scene(JSCENE)
    with jax.disable_jit():
        jax_tables = {n: np.asarray(JMT.mlt_vlps(jkey, jscn, n, ROUNDS))
                      for n in (SEEDS, SEEDS_ODD)}

    def chains(key, scn, n_seedpaths, mutation_rounds, quirks=None,
               verify_eps=1e-3, chain0=0, chains=None):
        return serve_windows(port_tables[n_seedpaths], n_seedpaths, chains,
                             chain0)

    m1 = JPM.make_spp_mesh(RANKS)
    args = (jkey, JSCENE, W, H, SPP)
    refs = {
        "metropolis_vlpgrid": lambda: JPM.render_metropolis_sharded(
            *args, m1, n_seedpaths=SEEDS, mutation_rounds=ROUNDS,
            use_grid=True),
        "metropolis_indivisible": lambda: JPM.render_metropolis_sharded(
            *args, m1, n_seedpaths=SEEDS_ODD, mutation_rounds=ROUNDS),
        "metropolis_2d": lambda: JPM.render_metropolis_sharded_2d(
            *args, JPM.make_mesh_2d(2, 2), n_seedpaths=SEEDS,
            mutation_rounds=ROUNDS),
    }
    port, jax_out = run_cases(CASES, refs,
                              jax_module_attr(JMT, "mlt_vlps", chains))
    return port, jax_out, jax_tables


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_metropolis_matches_jax(results, case):
    port, jax_out, _ = results
    r = port[case]
    assert r["ok"], r["detail"]   # table and film against the port's own
    assert r["windowed"] is WINDOWED[case]
    assert r["out"].shape == (H, W, 3) and r["out"].std() > 1.0
    ok, st = crn_ok(r["out"], jax_out[case], SPP, XLA_VLP)
    assert ok, st


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_chain_window_table_matches_jax(results, case):
    port, _, jax_tables = results
    n = SEEDS_ODD if case.endswith("indivisible") else SEEDS
    got, want = port[case]["table"], jax_tables[n]
    assert got.shape == want.shape == (2 * 4 * n, 4)
    np.testing.assert_array_equal(got[:, 3] > 0, want[:, 3] > 0)
    assert (got[:, 3] > 0).sum() >= 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
