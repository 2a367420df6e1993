"""Rigid-body dynamics of a serial arm in spatial algebra (twin of
`parallel_ddp_tpu/models/kuka/rbd.py`).

The same algorithms as the JAX package's core: the mass matrix by the
Composite Rigid Body Algorithm, the bias torques by RNEA with the
gravity-as-base-acceleration trick (the reference's `+GRAVITY` on the z
linear acceleration, dynamics_arm.cuh:1362), qdd = M^{-1} (tau - C), and the
derivatives d qdd / d (x, u) by `torch.func.jacfwd` through this code.

Where the JAX core works joint by joint on 3-vectors (cross products, 3x3
products), this one works on 6-vectors and 6x6 spatial transforms, over any
leading batch dims: one (..., 6, 6) @ (..., 6, 2) product carries a joint's
velocity and bias acceleration to the next link, the bias forces of all
links are one batched product, and the CRBA carries every mass-matrix
column down the chain at once.  Each tensor op is one node of a CUDA graph
on the card, so the count matters: for the iiwa-14 the forward dynamics
dispatches 527 aten ops at any batch size (about 140 of them launch a
kernel; the same code as one sample under `torch.func.vmap` dispatches 582),
and the vmapped `jacfwd` of an Euler step 2,558 (about 590 kernels), where a
joint-by-joint transliteration of the JAX core dispatches 1,716 and 6,796
(`tests/test_torch_rbd_core.py` bounds the counts).

Spatial vector convention: motion [omega; v], force [n; f], in link-local
frames; a revolute joint turns about its local z (S = e3 in the angular
slot), a prismatic one slides along it (S = e3 in the linear slot).
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_ddp_tpu_torch.models.kuka import params as kp

N_JOINTS = 7


def _skew(p):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(p[..., 0])
    x, y, w = p.unbind(-1)
    return torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


class SerialArmRBD:
    """Spatial-algebra RBD for any serial chain of revolute and/or prismatic
    joints acting about/along local z.

    Constants are (n,3,3) fixed parent->child rotations, (n,3) joint origins,
    (n,6,6) spatial inertias at the link frames, and a (3,) end-effector
    offset in the last link frame: the quantities a URDF provides
    (`models/urdf.py`).  joint_types: string of 'r' (revolute) / 'p'
    (prismatic); default all-revolute.  Every method takes any leading batch
    dims and computes in the dtype of its input (float32 for a bfloat16
    input, as in the JAX package: its float32 constants promote it); the
    constants become tensors once per (device, dtype).
    """

    def __init__(self, r_tree, p_tree, i_spatial, ee_offset, gravity,
                 ee_rot=None, joint_types=None):
        self.r_tree = np.asarray(r_tree, np.float64)
        self.p_tree = np.asarray(p_tree, np.float64)
        self.i_spatial = np.asarray(i_spatial, np.float64)
        self.ee_offset = np.asarray(ee_offset, np.float64)
        # tip-frame orientation in the last link frame (URDF tool frames)
        self.ee_rot = np.eye(3) if ee_rot is None else np.asarray(ee_rot, np.float64)
        self.gravity = float(gravity)
        self.n = int(self.r_tree.shape[0])
        self.joint_types = joint_types or "r" * self.n
        if len(self.joint_types) != self.n or not set(self.joint_types) <= {"r", "p"}:
            raise ValueError(f"bad joint_types {self.joint_types!r} for {self.n} joints")
        # the row of the 6-vector that S_i selects: angular z or linear z
        self._col = [2 if t == "r" else 5 for t in self.joint_types]
        self._tensors = {}

    def _consts(self, like):
        """The constants as tensors on like's device in like's dtype, but
        float32 below it (the JAX package's float32 constants, against which
        a bfloat16 input promotes), made once per (device, dtype): a copy from
        the host on every call would synchronise the stream."""
        key = (like.device, torch.promote_types(like.dtype, torch.float32))
        found = self._tensors.get(key)
        if found is None:
            n, f = self.n, dict(dtype=key[1], device=like.device)
            s = np.zeros((n, 6))
            s[np.arange(n), self._col] = 1.0
            # -crm(S_i): v x (S_i qd) = qd * (-crm(S_i) @ v), a constant map
            crm_s = np.zeros((n, 6, 6))
            sk = kp.skew([0.0, 0.0, 1.0])
            for i, c in enumerate(self._col):
                if c == 2:                 # crm([e3; 0]) = [[e3x, 0], [0, e3x]]
                    crm_s[i, :3, :3] = sk
                    crm_s[i, 3:, 3:] = sk
                else:                      # crm([0; e3]) = [[0, 0], [e3x, 0]]
                    crm_s[i, 3:, :3] = sk
            base = np.zeros((6, 2))
            base[5, 1] = self.gravity      # -g base acceleration trick
            found = dict(
                r_tree=torch.as_tensor(self.r_tree, **f),
                p_tree=torch.as_tensor(self.p_tree, **f),
                i_spatial=torch.as_tensor(self.i_spatial, **f),
                ee_offset=torch.as_tensor(self.ee_offset, **f),
                ee_rot=torch.as_tensor(self.ee_rot, **f),
                revolute=torch.as_tensor([t == "r" for t in self.joint_types],
                                         device=like.device),
                s=torch.as_tensor(s, **f), neg_crm_s=torch.as_tensor(-crm_s, **f),
                base=torch.as_tensor(base, **f),
                zero=torch.zeros((), **f), one=torch.ones((), **f),
                col_one_hot=torch.eye(n, **f))
            self._tensors[key] = found
        return found

    # ---------- kinematics ----------

    def _local_xforms(self, q):
        """Per-joint (r_cl (..., n, 3, 3), p_cl (..., n, 3)): child link
        frame pose in the parent frame.  Revolute: R_tree Rz(q) and the
        joint origin.  Prismatic: R_tree and the origin slid along the
        child z by q."""
        k = self._consts(q)
        rev, rt = k["revolute"], k["r_tree"]
        # a prismatic joint's (cos, sin) = (1, 0) leaves R_tree as it is
        c = torch.where(rev, torch.cos(q), k["one"])[..., None]           # (..., n, 1)
        s = torch.where(rev, torch.sin(q), k["zero"])[..., None]
        rt0, rt1, rt2 = rt.unbind(-1)                                     # (n, 3) columns
        r_cl = torch.stack([c * rt0 + s * rt1, c * rt1 - s * rt0,
                            rt2.expand(q.shape + (3,))], dim=-1)
        if "p" not in self.joint_types:
            return r_cl, k["p_tree"].expand(q.shape + (3,))
        return r_cl, k["p_tree"] + torch.where(rev, k["zero"], q)[..., None] * rt2

    def link_frames(self, q):
        """World pose of each link frame: (R (..., n, 3, 3), p (..., n, 3))."""
        r_cl, p_cl = self._local_xforms(q)
        r_w, p_w = r_cl[..., 0, :, :], p_cl[..., 0, :]
        rs, ps = [r_w], [p_w]
        for i in range(1, self.n):
            p_w = p_w + (r_w @ p_cl[..., i, :, None])[..., 0]
            r_w = r_w @ r_cl[..., i, :, :]
            rs.append(r_w)
            ps.append(p_w)
        return torch.stack(rs, -3), torch.stack(ps, -2)

    def ee_pose(self, q):
        """(..., 6) end-effector [xyz, rpy]; rpy extracted like the reference
        (atan2(R21,R22), atan2(-R20, sqrt(R21^2+R22^2)), atan2(R10,R00)),
        dynamics_arm.cuh:1890-1895."""
        k = self._consts(q)
        rs, ps = self.link_frames(q)
        r_n = rs[..., -1, :, :]
        pos = ps[..., -1, :] + r_n @ k["ee_offset"]
        r = r_n @ k["ee_rot"]
        # entries keep a trailing unit dim: under forward-mode AD a 0-d
        # float32 tensor combined with a Python number gets a float64 tangent
        r00, r10, r20 = r[..., 0, 0:1], r[..., 1, 0:1], r[..., 2, 0:1]
        r21, r22 = r[..., 2, 1:2], r[..., 2, 2:3]
        roll = torch.atan2(r21, r22)
        pitch = torch.atan2(-r20, torch.sqrt(r21 ** 2 + r22 ** 2))
        yaw = torch.atan2(r10, r00)
        return torch.cat([pos, roll, pitch, yaw], dim=-1)

    def ee_velocity(self, x):
        """(..., 6) EE [linear velocity; rpy rates] = d(ee_pose)/dt."""
        q, qd = x[..., : self.n], x[..., self.n:]
        return torch.func.jvp(self.ee_pose, (q,), (qd,))[1]

    def ee_pose_jacobian(self, q):
        """d ee_pose / dq: (..., n) -> (..., 6, n), `torch.func.jacfwd` of
        `ee_pose` over the flattened leading dims (the EE cost's
        `Plant.ee_jac`)."""
        flat = torch.func.vmap(torch.func.jacfwd(self.ee_pose))(q.reshape(-1, self.n))
        return flat.reshape(q.shape[:-1] + (6, self.n))

    # ---------- dynamics ----------

    def _motion_xforms(self, q):
        """X_i (..., n, 6, 6): the motion transform from parent to child
        coordinates, [[R^T, 0], [-R^T skew(p), R^T]] of the child's pose
        (R, p) in the parent; a force goes from child to parent by X_i^T."""
        r_cl, p_cl = self._local_xforms(q)
        rt = r_cl.transpose(-1, -2)
        lower = torch.cat([-(rt @ _skew(p_cl)), rt], dim=-1)
        upper = torch.cat([rt, torch.zeros_like(rt)], dim=-1)
        return torch.cat([upper, lower], dim=-2)

    def bias_and_mass(self, q, qd):
        """(C (..., n), M (..., n, n)): RNEA bias (Coriolis + gravity) and
        CRBA mass matrix."""
        k = self._consts(q)
        n, col = self.n, self._col
        xf = self._motion_xforms(q)                                      # (..., n, 6, 6)
        qd = qd[..., None]                                               # (..., n, 1)

        # --- forward sweep: velocity v_i and bias acceleration a_i (qdd = 0)
        #     v_i = X_i v_{i-1} + S_i qd_i;  a_i = X_i a_{i-1} + v_i x S_i qd_i
        va = k["base"]                                                   # [v | a] (6, 2)
        vs, acs = [], []
        for i in range(n):
            va = xf[..., i, :, :] @ va
            v = va[..., 0] + k["s"][i] * qd[..., i, :]
            a = va[..., 1] + (k["neg_crm_s"][i] @ v[..., None])[..., 0] * qd[..., i, :]
            vs.append(v)
            acs.append(a)
            va = torch.stack([v, a], dim=-1)
        v_all = torch.stack(vs, dim=-2)                                  # (..., n, 6)

        # --- per-link bias forces, all links at once: f = I a + v x* (I v)
        ia = k["i_spatial"] @ torch.stack([v_all, torch.stack(acs, dim=-2)], dim=-1)
        iv, fa = ia[..., 0], ia[..., 1]
        w, lin = v_all[..., :3], v_all[..., 3:]
        n_c = torch.linalg.cross(w, iv[..., :3]) + torch.linalg.cross(lin, iv[..., 3:])
        f_c = torch.linalg.cross(w, iv[..., 3:])
        fs = fa + torch.cat([n_c, f_c], dim=-1)                          # (..., n, 6)

        # --- backward sweep: the force each joint transmits, S_i^T of it
        f_tot = fs[..., n - 1, :]
        c_out = [f_tot[..., col[n - 1]:col[n - 1] + 1]]
        for i in reversed(range(n - 1)):
            f_tot = fs[..., i, :] + (xf[..., i + 1, :, :].transpose(-1, -2)
                                     @ f_tot[..., None])[..., 0]
            c_out.append(f_tot[..., col[i]:col[i] + 1])
        c_vec = torch.cat(c_out[::-1], dim=-1)

        # --- CRBA from the tip: the composite inertia Ic_j and, for every
        #     column i >= j, the force Ic_i S_i carried down into frame j
        #     (columns < j stay 0); row j of the upper triangle is S_j^T of it
        i_sp, one_hot = k["i_spatial"], k["col_one_hot"]
        ic = i_sp[n - 1].expand(q.shape[:-1] + (6, 6))
        cols = ic[..., :, col[n - 1], None] * one_hot[n - 1]            # (..., 6, n)
        rows = [cols[..., col[n - 1], :]]
        for j in reversed(range(n - 1)):
            x_t = xf[..., j + 1, :, :].transpose(-1, -2)
            ic = i_sp[j] + x_t @ ic @ xf[..., j + 1, :, :]
            cols = x_t @ cols + ic[..., :, col[j], None] * one_hot[j]
            rows.append(cols[..., col[j], :])
        upper = torch.stack(rows[::-1], dim=-2)                          # M[j, i], i >= j
        m_mat = upper + torch.triu(upper, 1).transpose(-1, -2)
        return c_vec, m_mat

    def forward_dynamics(self, x, u):
        """qdd = M^{-1} (u - C) (dynamics_arm.cuh:2095-2163), by a Cholesky
        factor and two triangular solves.  On the card both must be
        capturable into a CUDA graph: `cholesky_ex`, not `cholesky` (which
        reads its `info` on the host), and `solve_triangular` (cuBLAS), not
        `cholesky_solve`, whose batched form runs MAGMA's `spotrs_batched`,
        which allocates device memory during the capture and breaks it
        (measured on an H100, torch 2.11)."""
        q, qd = x[..., : self.n], x[..., self.n:]
        c_vec, m_mat = self.bias_and_mass(q, qd)
        chol = torch.linalg.cholesky_ex(m_mat)[0]
        z = torch.linalg.solve_triangular(chol, (u - c_vec)[..., None], upper=False)
        return torch.linalg.solve_triangular(chol.transpose(-1, -2), z, upper=True)[..., 0]

    def inverse_dynamics(self, q, qd, qdd):
        """tau = M qdd + C (for testing)."""
        c_vec, m_mat = self.bias_and_mass(q, qd)
        return (m_mat @ qdd[..., None])[..., 0] + c_vec


class KukaRBD(SerialArmRBD):
    """SerialArmRBD bound to the iiwa-14 constants (params.build_constants)."""

    def __init__(self, ee_type: int = 1, gravity: float = 9.81):
        r_tree, p_tree, i_sp, ee_off, grav = kp.build_constants(ee_type, gravity)
        super().__init__(r_tree, p_tree, i_sp, ee_off, grav)
