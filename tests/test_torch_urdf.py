"""The port's URDF front end (parallel_ddp_tpu_torch/models/urdf.py, the
`urdf_plant` / `urdf_problem` presets, `interop.arm_model`) against the JAX
package's on the CPU, on the URDFs of tests/test_urdf.py.

  * The parser is the JAX package's numpy code, copied: every ArmModel array
    is held equal (atol 0), names and joint types too, on every URDF.
  * The port's own oracles, as tests/test_urdf.py holds the JAX package's:
    the textbook double pendulum, the analytic cart-pole (the port's
    models/cartpole.py) through a prismatic joint, flipped axes, off-chain
    lumping, the moving-branch error and `freeze_branches`, and the generic
    arm's invariants in float64.
  * A small solve against the JAX package's (ARM3, joint cost, N = 16, 2
    blocks, 4 alphas, RK3, 4 iterations): the port's spatial-algebra core
    with its Riccati op (the plain version on the CPU) against the JAX
    package's spatial-algebra core and scan.  The same alphas; J within
    J_RTOL: the JAX package's float32 solve is itself 2.7e-4 from the port's
    float64 solve of the same problem at iteration 1, where the port's
    float32 solve is 1.7e-5 from it (measured), so the JAX side's rounding
    sets the bound and the 1e-4 target is held against the float64 solve
    instead.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_urdf import ARM3_URDF, CARTPOLE_URDF

from parallel_ddp_tpu import presets as ref_presets
from parallel_ddp_tpu.config import CostWeights as RefWeights
from parallel_ddp_tpu.models.urdf import IIWA14_URDF as REF_IIWA14_URDF
from parallel_ddp_tpu.models.urdf import load_urdf as ref_load_urdf
from parallel_ddp_tpu.models.urdf import urdf_plant as ref_urdf_plant
from parallel_ddp_tpu.solver import ilqr_solve as ref_ilqr_solve
from parallel_ddp_tpu_torch import interop, presets
from parallel_ddp_tpu_torch.models import load_urdf, urdf_plant
from parallel_ddp_tpu_torch.models.cartpole import _dynamics as cartpole_dynamics
from parallel_ddp_tpu_torch.models.kuka import params as kp
from parallel_ddp_tpu_torch.models.kuka.rbd import KukaRBD
from parallel_ddp_tpu_torch.models.urdf import IIWA14_URDF, ArmModel
from parallel_ddp_tpu_torch.solver import make_ilqr_solver

J_RTOL = 1e-3          # the ARM3 solve's J trace against the JAX package's (see above)
X_ATOL = 1e-3          # its final trajectory (rad, rad/s), measured 3.8e-5
J_RTOL_F64 = 1e-4      # the port's float32 solve against its float64 solve

# tests/test_urdf.py's double pendulum (:77): both joints about +y, point
# masses at the link tips
M1, M2, L1, L2, G = 1.3, 0.7, 0.9, 0.6, 9.81
DPEND_URDF = f"""
<robot name="dpend">
  <link name="base"/>
  <link name="l1"><inertial><origin xyz="0 0 {-L1}"/><mass value="{M1}"/>
    <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/></inertial></link>
  <link name="l2"><inertial><origin xyz="0 0 {-L2}"/><mass value="{M2}"/>
    <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/></inertial></link>
  <joint name="j1" type="continuous">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 1.0"/><axis xyz="0 1 0"/></joint>
  <joint name="j2" type="continuous">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 {-L1}"/><axis xyz="0 1 0"/></joint>
</robot>
"""

# tests/test_urdf.py's SCARA-like r-p-r chain (:317)
SCARA_URDF = """
<robot name="scara">
  <link name="base"/>
  <link name="l1"><inertial><origin xyz="0.1 0 0"/><mass value="2.0"/>
    <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.02" iyz="0" izz="0.02"/></inertial></link>
  <link name="l2"><inertial><origin xyz="0 0 -0.1"/><mass value="1.0"/>
    <inertia ixx="0.005" ixy="0" ixz="0" iyy="0.005" iyz="0" izz="0.001"/></inertial></link>
  <link name="l3"><inertial><origin xyz="0.05 0 0"/><mass value="0.5"/>
    <inertia ixx="0.0005" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.002"/></inertial></link>
  <joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.3"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" velocity="3" effort="30"/></joint>
  <joint name="j2" type="prismatic"><parent link="l1"/><child link="l2"/>
    <origin xyz="0.2 0 0"/><axis xyz="0 0 -1"/>
    <limit lower="0" upper="0.3" velocity="1" effort="50"/></joint>
  <joint name="j3" type="continuous"><parent link="l2"/><child link="l3"/>
    <origin xyz="0 0 -0.15"/><axis xyz="0 0 1"/></joint>
</robot>
"""


def _pendulum_urdf(axis):
    """tests/test_urdf.py's one-link pendulum of the flipped-axis test (:429)."""
    return f"""
    <robot name="p"><link name="base"/>
      <link name="l1"><inertial><origin xyz="0.3 0 -0.7"/><mass value="1.3"/>
        <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.001"/></inertial></link>
      <joint name="j1" type="continuous"><parent link="base"/><child link="l1"/>
        <origin xyz="0 0 1"/><axis xyz="{axis}"/></joint></robot>"""


BRANCH_URDF = ARM3_URDF.replace(
    "</robot>",
    '<link name="extra"/><joint name="jx" type="fixed">'
    '<parent link="l1"/><child link="extra"/></joint></robot>')
FINGER_URDF = ARM3_URDF.replace(
    "</robot>",
    '<link name="finger"><inertial><origin xyz="0 0 0.02"/>'
    '<mass value="0.2"/><inertia ixx="0.0001" ixy="0" ixz="0" '
    'iyy="0.0001" iyz="0" izz="0.0001"/></inertial></link>'
    '<joint name="jf" type="revolute"><parent link="l2"/>'
    '<child link="finger"/><origin xyz="0 0.03 0.1"/>'
    '<axis xyz="0 0 1"/><limit lower="-1" upper="1" velocity="1" '
    'effort="5"/></joint></robot>')

# (name, port source, JAX source, load_urdf keywords)
PARSE_CASES = {
    "arm3": (ARM3_URDF, ARM3_URDF, {}),
    "arm3_tip_l3": (ARM3_URDF, ARM3_URDF, dict(tip="l3")),
    "cartpole": (CARTPOLE_URDF, CARTPOLE_URDF, {}),
    "iiwa14": (IIWA14_URDF, REF_IIWA14_URDF, {}),
    "dpend": (DPEND_URDF, DPEND_URDF, {}),
    "scara": (SCARA_URDF, SCARA_URDF, {}),
    "branch_tip": (BRANCH_URDF, BRANCH_URDF, dict(tip="tool")),
    "finger_frozen": (FINGER_URDF, FINGER_URDF, dict(tip="tool", freeze_branches=True)),
    **{f"axis_{a.replace(' ', '')}": (_pendulum_urdf(a), _pendulum_urdf(a), {})
       for a in ("0 1 0", "0 -1 0", "0 0 1", "0 0 -1", "1 1 0")},
}


def _assert_same_arm(port, ref):
    assert isinstance(port, ArmModel)
    assert port.name == ref.name
    assert port.joint_names == ref.joint_names
    assert port.joint_types == ref.joint_types
    for f in ("r_tree", "p_tree", "i_spatial", "ee_offset", "ee_rot", "pos_lower", "pos_upper",
              "vel_limit", "effort_limit"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("name", sorted(PARSE_CASES))
def test_parser_matches_reference(name):
    """Every ArmModel field equal (atol 0) to the JAX package's parse."""
    port_src, ref_src, kw = PARSE_CASES[name]
    _assert_same_arm(load_urdf(port_src, **kw), ref_load_urdf(ref_src, **kw))


def test_branching_needs_tip():
    with pytest.raises(AssertionError, match="branches"):
        load_urdf(BRANCH_URDF)
    assert load_urdf(BRANCH_URDF, tip="tool").n == 3


def test_offchain_fixed_mass_is_lumped():
    """tip='l3' makes the mass-carrying tool an off-chain fixed subtree; the
    dynamics must match the tip='tool' load, where the same tool is folded
    as a trailing chain joint."""
    full, cut = load_urdf(ARM3_URDF), load_urdf(ARM3_URDF, tip="l3")
    np.testing.assert_allclose(cut.i_spatial, full.i_spatial, atol=1e-12)
    np.testing.assert_allclose(cut.ee_offset, np.zeros(3), atol=0)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(0, 1, 6).astype(np.float32))
    u = torch.as_tensor(rng.normal(0, 5, 3).astype(np.float32))
    np.testing.assert_allclose(full.rbd(9.81).forward_dynamics(x, u),
                               cut.rbd(9.81).forward_dynamics(x, u), atol=1e-6)


def test_moving_branch_errors_unless_frozen():
    with pytest.raises(ValueError, match="moving joint 'jf'"):
        load_urdf(FINGER_URDF, tip="tool")
    frozen = load_urdf(FINGER_URDF, tip="tool", freeze_branches=True)
    fixed = load_urdf(FINGER_URDF.replace('name="jf" type="revolute"', 'name="jf" type="fixed"'),
                      tip="tool")
    np.testing.assert_allclose(frozen.i_spatial, fixed.i_spatial, atol=1e-12)


def test_double_pendulum_matches_textbook_dynamics():
    """Independent closed-form oracle (tests/test_urdf.py:77)."""
    rbd = load_urdf(DPEND_URDF).rbd(gravity=G)

    def analytic(q, qd, tau):
        c2, s2 = np.cos(q[1]), np.sin(q[1])
        m_mat = np.array([[(M1 + M2) * L1**2 + M2 * L2**2 + 2 * M2 * L1 * L2 * c2,
                           M2 * L2**2 + M2 * L1 * L2 * c2],
                          [M2 * L2**2 + M2 * L1 * L2 * c2, M2 * L2**2]])
        cor = np.array([-M2 * L1 * L2 * s2 * (2 * qd[0] * qd[1] + qd[1] ** 2),
                        M2 * L1 * L2 * s2 * qd[0] ** 2])
        grav = np.array([(M1 + M2) * G * L1 * np.sin(q[0]) + M2 * G * L2 * np.sin(q[0] + q[1]),
                         M2 * G * L2 * np.sin(q[0] + q[1])])
        return np.linalg.solve(m_mat, tau - cor - grav)

    rng = np.random.default_rng(2)
    for _ in range(5):
        q, qd, tau = rng.normal(0, 1.5, 2), rng.normal(0, 1.0, 2), rng.normal(0, 3.0, 2)
        qdd = rbd.forward_dynamics(torch.as_tensor(np.r_[q, qd], dtype=torch.float32),
                                   torch.as_tensor(tau, dtype=torch.float32))
        np.testing.assert_allclose(qdd, analytic(q, qd, tau), rtol=2e-4, atol=2e-4)


def test_prismatic_cartpole_matches_analytic():
    """A prismatic-x cart plus a revolute-y pole reproduces the port's
    hand-derived cart-pole (tests/test_urdf.py:292; theta measured
    oppositely)."""
    arm = load_urdf(CARTPOLE_URDF)
    assert arm.joint_types == "pr" and float(arm.pos_upper[0]) == 5.0
    rbd = arm.rbd(gravity=9.81)
    rng = np.random.default_rng(0)
    for _ in range(6):
        x, u = rng.normal(0, 1.0, 4), rng.normal(0, 5.0, 1)
        qdd_a = cartpole_dynamics(torch.as_tensor(x, dtype=torch.float32),
                                  torch.as_tensor(u, dtype=torch.float32))
        qdd_u = rbd.forward_dynamics(torch.as_tensor(np.r_[x[0], -x[1], x[2], -x[3]],
                                                     dtype=torch.float32),
                                     torch.as_tensor([u[0], 0.0], dtype=torch.float32))
        np.testing.assert_allclose(np.r_[qdd_u[0], -qdd_u[1]], qdd_a, rtol=2e-4, atol=2e-4)


def test_flipped_axis_equivalence():
    """axis = -a is the same joint with q measured oppositely:
    qdd_a(q, u) == -qdd_{-a}(-q, -u) (tests/test_urdf.py:429)."""
    rng = np.random.default_rng(0)
    for ax_pos, ax_neg in (("0 1 0", "0 -1 0"), ("0 0 1", "0 0 -1")):
        rbd_p = load_urdf(_pendulum_urdf(ax_pos)).rbd(gravity=9.81)
        rbd_n = load_urdf(_pendulum_urdf(ax_neg)).rbd(gravity=9.81)
        for _ in range(3):
            x = torch.as_tensor(rng.normal(0, 1, 2).astype(np.float32))
            u = torch.as_tensor(rng.normal(0, 2, 1).astype(np.float32))
            np.testing.assert_allclose(float(rbd_p.forward_dynamics(x, u)[0]),
                                       -float(rbd_n.forward_dynamics(-x, -u)[0]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["arm3", "scara"])
def test_generic_arm_invariants(name):
    """SPD mass matrix, ID(FD) = id, and, undriven in zero gravity, kinetic
    energy conserved over 200 RK4 steps in float64 (tests/test_urdf.py:160,
    :317)."""
    arm = load_urdf(ARM3_URDF if name == "arm3" else SCARA_URDF)
    n = arm.n
    rng = np.random.default_rng(1)
    q, qd, u = (torch.as_tensor(rng.normal(0, s, n).astype(np.float32)) for s in (1, 1, 5))
    rbd = arm.rbd(gravity=9.81)
    m_np = rbd.bias_and_mass(q, qd)[1].numpy()
    np.testing.assert_allclose(m_np, m_np.T, atol=1e-6)
    assert np.linalg.eigvalsh(m_np).min() > 0
    tau = rbd.inverse_dynamics(q, qd, rbd.forward_dynamics(torch.cat([q, qd]), u))
    np.testing.assert_allclose(tau, u, rtol=1e-4, atol=1e-4)

    rbd0 = arm.rbd(gravity=0.0)
    zero = torch.zeros(n, dtype=torch.float64)

    def f(s):
        return torch.cat([s[n:], rbd0.forward_dynamics(s, zero)])

    def energy(s):
        return 0.5 * float(s[n:] @ rbd0.bias_and_mass(s[:n], s[n:])[1] @ s[n:])

    s = torch.cat([q, qd]).double()
    e0, h = energy(s), 1e-3
    for _ in range(200):
        k1 = f(s)
        k2 = f(s + h / 2 * k1)
        k3 = f(s + h / 2 * k2)
        k4 = f(s + h * k3)
        s = s + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    assert abs(energy(s) - e0) / e0 < 1e-8


def test_iiwa_round_trip():
    """The port's iiwa14.urdf reproduces the port's hardcoded Kuka constants
    and dynamics (tests/test_urdf.py:129-158)."""
    arm = load_urdf(IIWA14_URDF)
    assert arm.n == 7 and arm.joint_names[0] == "joint_1"
    r_t, p_t, i_sp, _, _ = kp.build_constants(ee_type=0)
    np.testing.assert_allclose(arm.r_tree, r_t, atol=1e-7)
    np.testing.assert_allclose(arm.p_tree, p_t, atol=0)
    np.testing.assert_allclose(arm.i_spatial[:6], i_sp[:6], atol=0)
    np.testing.assert_allclose(arm.i_spatial[6], i_sp[6], atol=3e-5)   # link 7's baked rounding
    np.testing.assert_allclose(arm.pos_upper[1], 2.09439510239, rtol=1e-9)
    assert float(arm.effort_limit[0]) == 300.0
    ref, ours = KukaRBD(ee_type=0, gravity=9.81), arm.rbd(gravity=9.81)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = torch.as_tensor(rng.normal(0, 1.0, 14).astype(np.float32))
        u = torch.as_tensor(rng.normal(0, 50.0, 7).astype(np.float32))
        qdd_r = ref.forward_dynamics(x, u).numpy()
        err = np.abs(ours.forward_dynamics(x, u).numpy() - qdd_r).max()
        assert err / (1.0 + np.abs(qdd_r).max()) < 5e-3
        np.testing.assert_allclose(ours.ee_pose(x[:7]), ref.ee_pose(x[:7]), atol=1e-5)


def test_interop_arm_model_and_plant_names():
    """The JAX package's parsed arm crosses over with its constants; a URDF
    plant's name cannot carry them, so `interop.plant` refuses it."""
    arm = interop.arm_model(ref_load_urdf(ARM3_URDF))
    _assert_same_arm(arm, load_urdf(ARM3_URDF))
    assert all(not isinstance(getattr(arm, f), jax.Array) for f in ArmModel.__dataclass_fields__)
    ref_plant = ref_urdf_plant(ARM3_URDF, gravity=9.81, core="rbd")
    assert urdf_plant(arm, gravity=9.81).name == ref_plant.name == "urdf_arm3_3dof_g9.81_rbd"
    with pytest.raises(ValueError, match="arm_model"):
        interop.plant(ref_plant)


def test_urdf_plant_cores():
    """"auto" is the spatial-algebra core; "soa" the scalar-channel one;
    "cuda" is Kuka-only and raises, as the JAX package raises on "pallas"."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(0, 0.5, (5, 6)).astype(np.float32))
    u = torch.as_tensor(rng.normal(0, 2.0, (5, 3)).astype(np.float32))
    rbd, soa = (urdf_plant(ARM3_URDF, gravity=0.0, core=c) for c in ("auto", "soa"))
    assert (rbd.name, soa.name) == ("urdf_arm3_3dof_g0_rbd", "urdf_arm3_3dof_g0_soa")
    np.testing.assert_allclose(rbd.dynamics(x, u), soa.dynamics(x, u), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rbd.ee_jac(x[:, :3]), soa.ee_jac(x[:, :3]), atol=1e-5)
    assert rbd.ee_jac(x[:, :3]).dtype == torch.float32
    for bad in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="unknown core"):
            urdf_plant(ARM3_URDF, core=bad)


@pytest.mark.parametrize("ee", [False, True])
def test_urdf_problem_matches_reference_config_and_cost(ee):
    """The same solver config field for field, and the same cost (the EE
    cost with the URDF's limits scaled by `safety` feeding the penalties)
    on seeded states, float32 ulps apart."""
    kw = dict(gravity=0.0, ee=ee, use_limits=ee, num_time_steps=8, m_blocks=2, num_alpha=4)
    ref = ref_presets.urdf_problem(ARM3_URDF, **kw)
    port = presets.urdf_problem(ARM3_URDF, **kw)
    assert interop.solver_config(ref.cfg) == port.cfg
    assert port.plant.name == ref.plant.name
    assert (port.plant.rho_init_default, port.plant.num_alpha_default) == (5.0, 4)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1.5, (8, 6)).astype(np.float32)
    u = rng.normal(0, 40.0, (8, 3)).astype(np.float32)
    goal = (presets.ee_goal([0.2, 0.0, 0.7], n_state=6, device="cpu") if ee
            else torch.as_tensor(rng.normal(0, 0.5, 6).astype(np.float32)))
    w = RefWeights()
    ks = jnp.arange(8)
    ref_goal = {k: jnp.asarray(v.numpy()) for k, v in goal.items()} if ee else jnp.asarray(
        goal.numpy())
    r_stage = jax.vmap(lambda xk, uk, k: ref.cost.stage(xk, uk, k, ref_goal, w))(x, u, ks)
    r_H, r_g = jax.vmap(lambda xk, uk, k: ref.cost.quad(xk, uk, k, ref_goal, w))(x, u, ks)
    tw, tk = interop.cost_weights(w), torch.arange(8)
    stage = port.cost.stage(torch.as_tensor(x), torch.as_tensor(u), tk, goal, tw)
    H, g = port.cost.quad(torch.as_tensor(x), torch.as_tensor(u), tk, goal, tw)
    for got, want in ((stage, r_stage), (g, r_g), (H, r_H)):
        want = np.asarray(want, np.float64)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))


N, A, M, ITERS = 16, 4, 2, 4
ARM3_GOAL = [0.6, -0.4, 0.8, 0.0, 0.0, 0.0]


@functools.lru_cache(maxsize=1)
def _reference_solve():
    prob = ref_presets.urdf_problem(ARM3_URDF, num_time_steps=N, total_time=0.8, m_blocks=M,
                                    num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, max_iter=ITERS)
    out = ref_ilqr_solve(prob.plant, prob.cost, cfg, jnp.zeros((N, 6)), jnp.zeros((N, 3)),
                         jnp.asarray(ARM3_GOAL, jnp.float32), initial_rollout=True)
    return cfg, jax.device_get(out)


def _port_solve(dtype, pallas=True):
    prob = presets.urdf_problem(ARM3_URDF, num_time_steps=N, total_time=0.8, m_blocks=M,
                                num_alpha=A)
    cfg = dataclasses.replace(prob.cfg, max_iter=ITERS, pallas_riccati=pallas)
    f = dict(dtype=dtype)
    return make_ilqr_solver(prob.plant, prob.cost, cfg)(
        torch.zeros(N, 6, **f), torch.zeros(N, 3, **f), torch.tensor(ARM3_GOAL, **f),
        initial_rollout=True)


def _trace(out):
    it = int(out.iters)
    return (np.asarray(out.J_trace, np.float64)[: it + 1], np.asarray(out.alpha_trace)[: it + 1])


def test_arm3_solve_matches_reference():
    """The port's URDF solve (spatial-algebra core, Riccati op) against the
    JAX package's (its spatial-algebra core, scan): the same iterations and
    alphas, J within J_RTOL at every iteration, the final trajectory within
    X_ATOL; and the port's float32 solve within J_RTOL_F64 of its float64
    solve (the float32 rounding alone)."""
    cfg_ref, ref = _reference_solve()
    port = _port_solve(torch.float32)
    assert interop.solver_config(cfg_ref) == dataclasses.replace(
        presets.urdf_problem(ARM3_URDF, num_time_steps=N, total_time=0.8, m_blocks=M,
                             num_alpha=A).cfg, max_iter=ITERS)
    (pj, pa), (rj, ra) = _trace(port), _trace(ref)
    np.testing.assert_array_equal(pa, ra)
    assert int(port.iters) == int(ref.iters) == ITERS
    np.testing.assert_allclose(pj, rj, rtol=J_RTOL)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=X_ATOL)
    f64 = _port_solve(torch.float64, pallas=False)
    j64, a64 = _trace(f64)
    np.testing.assert_array_equal(pa, a64)
    np.testing.assert_allclose(pj, j64, rtol=J_RTOL_F64)


def test_ee_problem_with_limits_solves():
    """urdf_problem's EE cost with the URDF's limits on the port alone
    (tests/test_urdf.py:387's setting): finite J, the defects closed and the
    EE at the goal."""
    prob = presets.urdf_problem(ARM3_URDF, ee=True, gravity=0.0, use_limits=True,
                                num_time_steps=16, total_time=0.8, m_blocks=2, num_alpha=8)
    cfg = dataclasses.replace(prob.cfg, pallas_riccati=True)
    goal_xyz = [0.224, -0.015, 0.8]
    out = make_ilqr_solver(prob.plant, prob.cost, cfg)(
        torch.zeros(16, 6), torch.zeros(16, 3), presets.ee_goal(goal_xyz, n_state=6, device="cpu"),
        initial_rollout=True)
    assert bool(torch.isfinite(out.J))
    assert float(out.max_defect) < 0.1
    ee = prob.plant.ee_pos(out.x[-1][:3])[:3].numpy()
    assert np.linalg.norm(ee - np.asarray(goal_xyz)) < 0.1
