"""The port's configuration, weights, outputs and Kuka constants equal the
reference package's, field for field (parallel_ddp_tpu_torch/config.py,
models/kuka/params.py, interop.py)."""

import dataclasses

import numpy as np
import pytest

from parallel_ddp_tpu import config as jcfg
from parallel_ddp_tpu.models.kuka import params as jparams
from parallel_ddp_tpu.models.kuka import soa as jsoa
from parallel_ddp_tpu_torch import config as tcfg
from parallel_ddp_tpu_torch import interop
from parallel_ddp_tpu_torch.models.kuka import params as tparams
from parallel_ddp_tpu_torch.models.kuka import soa as tsoa


def test_solver_config_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(jcfg.SolverConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tcfg.SolverConfig)}
    assert port == ref


@pytest.mark.parametrize("cls", ["CostWeights", "SolveOutput"])
def test_namedtuple_fields_and_defaults(cls):
    ref, port = getattr(jcfg, cls), getattr(tcfg, cls)
    assert port._fields == ref._fields
    assert port._field_defaults == ref._field_defaults


@pytest.mark.parametrize("num_alpha,alpha_base", [(16, 0.5), (32, 0.75), (1, 0.5)])
def test_alphas_equal(num_alpha, alpha_base):
    kw = dict(num_alpha=num_alpha, alpha_base=alpha_base)
    a = tcfg.SolverConfig(**kw).alphas()
    b = jcfg.SolverConfig(**kw).alphas()
    assert isinstance(a, np.ndarray) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_config_validation_matches():
    for kw in (dict(num_time_steps=10, m_blocks_b=4), dict(integrator=4),
               dict(bp_assoc_scan=True)):
        with pytest.raises(ValueError):
            jcfg.SolverConfig(**kw)
        with pytest.raises(ValueError):
            tcfg.SolverConfig(**kw)


def test_interop_config_and_weights():
    jc = jcfg.SolverConfig(num_time_steps=32, m_blocks_b=2, integrator=1,
                           pallas_riccati=True, state_reg=False, rho_init=3.0)
    assert dataclasses.asdict(interop.solver_config(jc)) == dataclasses.asdict(jc)
    jw = jcfg.CostWeights(q_ee1=300.0, r_ee=5e-4)
    assert interop.cost_weights(jw) == tcfg.CostWeights(q_ee1=300.0, r_ee=5e-4)


@pytest.mark.parametrize("ee_type", [0, 1, 2])
@pytest.mark.parametrize("gravity", [0.0, 9.81])
def test_kuka_constants_equal(ee_type, gravity):
    ref = jparams.build_constants(ee_type, gravity)
    port = tparams.build_constants(ee_type, gravity)
    for a, b in zip(port[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert port[4] == ref[4]
    # the flat layout the CUDA kernels read, from the reference's constants
    carried = interop.kuka_constants(jsoa._consts(ee_type, gravity)).flat()
    np.testing.assert_array_equal(carried, tsoa._consts(ee_type, gravity).flat())
    assert carried.shape == (7 * 9 + 7 * 3 + 7 * 36 + 3 + 1,)


def test_interop_kuka_params():
    from parallel_ddp_tpu.models.kuka.model import KukaParams as JKP

    assert interop.kuka_params(JKP(core="pallas", gravity=0.0)).core == "cuda"
    assert interop.kuka_params(JKP(core="rbd")).core == "soa"
    assert interop.kuka_params(JKP(ee_type=2, gravity=0.0)).gravity == 0.0
