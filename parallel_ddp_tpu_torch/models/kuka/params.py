"""Kuka iiwa-14 physical parameters, derived from the URDF.

The reference hardcodes symbolically-generated spatial inertias and joint
transforms (initI/initT, dynamics_arm.cuh:71-430); these are exactly the URDF
quantities (plants/iiwa14.urdf) assembled as 6x6 spatial inertias at the joint
frames and fixed parent->child transforms, so we build them from the primary
URDF numbers instead (the reference README's own roadmap item, README.md:41).

Verified against initI: e.g. link 1 (m = 5.76, com = (0, -0.03, 0.12),
I_com = diag(0.033, 0.0333, 0.0123)) gives I_O[0,0] = 0.033 + 5.76*(0.03^2 +
0.12^2) = 0.121128 = s_I[0], and m*skew(c)[0,1] = -0.6912 = s_I[4].

End-effector options (EE_TYPE, dynamics_arm.cuh:48-66): the flange/payload
modifies link 7 — the reference scales the rotational inertia by
INERTIA_MODIFIER and adds WEIGHT_MODIFIER to the mass while keeping the
unscaled m*c terms; we reproduce those exact numbers (documented quirk).
"""

from __future__ import annotations

import numpy as np

# joint origins: (rpy, xyz) of joint i's frame in parent link's frame (iiwa14.urdf:64-271)
JOINT_ORIGINS = [
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.1575)),
    ((np.pi / 2, 0.0, np.pi), (0.0, 0.0, 0.2025)),
    ((np.pi / 2, 0.0, np.pi), (0.0, 0.2045, 0.0)),
    ((np.pi / 2, 0.0, 0.0), (0.0, 0.0, 0.2155)),
    ((-np.pi / 2, np.pi, 0.0), (0.0, 0.1845, 0.0)),
    ((np.pi / 2, 0.0, 0.0), (0.0, 0.0, 0.2155)),
    ((-np.pi / 2, np.pi, 0.0), (0.0, 0.081, 0.0)),
]

# links 1..7: mass, com (in link frame), inertia about com diag (iiwa14.urdf:73-283)
LINK_MASS = [5.76, 6.35, 3.5, 3.5, 3.5, 1.8, 1.2]
LINK_COM = [
    (0.0, -0.03, 0.12),
    (0.0003, 0.059, 0.042),
    (0.0, 0.03, 0.13),
    (0.0, 0.067, 0.034),
    (0.0001, 0.021, 0.076),
    (0.0, 0.0006, 0.0004),
    (0.0, 0.0, 0.02),
]
LINK_INERTIA = [
    (0.033, 0.0333, 0.0123),
    (0.0305, 0.0304, 0.011),
    (0.025, 0.0238, 0.0076),
    (0.017, 0.0164, 0.006),
    (0.01, 0.0087, 0.00449),
    (0.0049, 0.0047, 0.0036),
    (0.005, 0.005, 0.005),
]

# EE_TYPE options (dynamics_arm.cuh:48-66): (ee_z_offset, inertia_mod, weight_mod)
EE_TYPES = {
    0: (0.0, 1.0, 0.0),       # bare link 7
    1: (0.0635, 3.0, 0.03),   # flange only (default)
    2: (0.1524, 5.0, 0.5),    # flange + 6-inch peg
}


def rpy_to_rot(rpy):
    """URDF fixed-axis convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def spatial_inertia(mass, com, inertia_diag, mc_mass=None):
    """6x6 spatial inertia at the link frame, [omega; v] ordering:
    [[I_com - m*skew(c)^2, m*skew(c)], [m*skew(c)^T, m*E]].

    mc_mass lets the m*c coupling use a different mass than the diagonal —
    the reference's EE weight-modifier quirk (initI link 7, dynamics_arm.cuh:330-341
    uses m = 1.2 + WEIGHT_MODIFIER on the diagonal but m*c with m = 1.2)."""
    c = np.asarray(com)
    ch = skew(c)
    m_c = mass if mc_mass is None else mc_mass
    top_left = np.diag(inertia_diag) - m_c * (ch @ ch)
    out = np.zeros((6, 6))
    out[:3, :3] = top_left
    out[:3, 3:] = m_c * ch
    out[3:, :3] = m_c * ch.T
    out[3:, 3:] = mass * np.eye(3)
    return out


def build_constants(ee_type: int = 1, gravity: float = 9.81):
    """Return (R_tree (7,3,3), p_tree (7,3), I_spatial (7,6,6), ee_offset (3,), gravity).

    gravity = 0 reproduces the reference's MPC mode (the hardware Kuka gravity-
    compensates, dynamics_arm.cuh:42-46)."""
    ee_z, inertia_mod, weight_mod = EE_TYPES[ee_type]
    r_tree = np.stack([rpy_to_rot(rpy) for rpy, _ in JOINT_ORIGINS])
    p_tree = np.stack([np.asarray(xyz) for _, xyz in JOINT_ORIGINS])

    inertias = []
    for i in range(7):
        if i == 6:
            # link 7 with EE modifier: reference bakes I_O = diag(0.0055, 0.0055,
            # 0.005) * INERTIA_MODIFIER at the joint frame and adds the payload
            # weight only on the mass diagonal (initI, dynamics_arm.cuh:330-341)
            io = np.diag(np.array([0.0055, 0.0055, 0.005]) * inertia_mod)
            ch = skew(LINK_COM[6])
            m0 = LINK_MASS[6]
            out = np.zeros((6, 6))
            out[:3, :3] = io
            out[:3, 3:] = m0 * ch
            out[3:, :3] = m0 * ch.T
            out[3:, 3:] = (m0 + weight_mod) * np.eye(3)
            inertias.append(out)
        else:
            inertias.append(
                spatial_inertia(LINK_MASS[i], LINK_COM[i], LINK_INERTIA[i])
            )
    i_spatial = np.stack(inertias)
    ee_offset = np.array([0.0, 0.0, ee_z])
    return r_tree, p_tree, i_spatial, ee_offset, gravity
