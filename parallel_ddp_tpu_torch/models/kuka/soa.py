"""Kuka iiwa-14 rigid-body dynamics in scalar-channel (structure-of-arrays) form.

Twin of `parallel_ddp_tpu/models/kuka/soa.py`, on torch tensors.  In the
dynamics every quantity is a scalar channel: a tensor of whatever batch shape
the caller passes, and the only operations are elementwise
mul/add/sin/cos/sqrt/div.  Constants are Python floats.  The same dataflow is
written once more, by hand, in C++ for the CUDA kernels
(`csrc/kuka_soa.cuh`).  The end-effector FK and its Jacobian, which the cost
runs eagerly over whole trajectories, keep the joint index as a tensor
dimension instead (`SerialArmSoA._frames`): the same math in a few dozen
launches rather than hundreds.

Algorithms (identical math to the reference):
  * RNEA with gravity-as-base-acceleration for the bias C
  * CRBA for the mass matrix M
  * unrolled 7x7 Cholesky solve for qdd = M^{-1}(tau - C)
  * FK chain for the end-effector pose (atan2 rpy extraction) and its
    Jacobian by forward mode, all joint tangents in one pass

Conventions: vectors are Python lists [x, y, z] of channels; 3x3 matrices are
row-major nested lists.  A channel is a tensor of the batch shape plus a
trailing unit dim.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from parallel_ddp_tpu_torch.models.kuka import params as kp

N_JOINTS = 7


# ---------- tuple-algebra helpers (all elementwise) ----------

def _v_add(a, b):
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2]]


def _v_cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _m_vec(m, v):
    return [
        m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2],
        m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2],
        m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2],
    ]


def _mT_vec(m, v):
    return [
        m[0][0] * v[0] + m[1][0] * v[1] + m[2][0] * v[2],
        m[0][1] * v[0] + m[1][1] * v[1] + m[2][1] * v[2],
        m[0][2] * v[0] + m[1][2] * v[1] + m[2][2] * v[2],
    ]


def _m_mul(a, b):
    return [
        [sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]


def _m_T(a):
    return [[a[j][i] for j in range(3)] for i in range(3)]


def _skew(v):
    z = v[0] * 0.0
    return [[z, -v[2], v[1]], [v[2], z, -v[0]], [-v[1], v[0], z]]


class _Consts:
    """Chain constants as plain Python floats.

    Generic over chain length and per-joint type ('r' revolute / 'p'
    prismatic, both about/along local z)."""

    def __init__(self, r_tree, p_tree, i_sp, ee_off, gravity,
                 joint_types=None, ee_rot=None):
        n = len(r_tree)
        self.n = n
        self.r_tree = [[[float(r_tree[k][i][j]) for j in range(3)] for i in range(3)]
                       for k in range(n)]
        self.p_tree = [[float(p_tree[k][i]) for i in range(3)] for k in range(n)]
        self.i_spatial = [[[float(i_sp[k][i][j]) for j in range(6)] for i in range(6)]
                          for k in range(n)]
        self.ee_offset = [float(ee_off[i]) for i in range(3)]
        self.ee_rot = (None if ee_rot is None else
                       [[float(ee_rot[i][j]) for j in range(3)] for i in range(3)])
        self.gravity = float(gravity)
        self.joint_types = joint_types or "r" * n
        if len(self.joint_types) != n or not set(self.joint_types) <= {"r", "p"}:
            raise ValueError(f"bad joint_types {self.joint_types!r} for {n} joints")

    def flat(self) -> np.ndarray:
        """The constants as one float32 vector, in the layout the CUDA kernels
        read (`csrc/kuka_soa.cuh`): r_tree (n,3,3) | p_tree (n,3) |
        i_spatial (n,6,6) | ee_offset (3) | gravity."""
        return np.concatenate([
            np.asarray(self.r_tree, np.float64).ravel(),
            np.asarray(self.p_tree, np.float64).ravel(),
            np.asarray(self.i_spatial, np.float64).ravel(),
            np.asarray(self.ee_offset, np.float64),
            [self.gravity],
        ]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _consts(ee_type: int, gravity: float) -> _Consts:
    """Cached Kuka iiwa-14 constants."""
    r_tree, p_tree, i_sp, ee_off, grav = kp.build_constants(ee_type, gravity)
    return _Consts(r_tree, p_tree, i_sp, ee_off, grav)


def _local_rots(cc, q):
    """r_cl[i]: revolute = R_tree[i] @ Rz(q_i); prismatic = R_tree[i]."""
    rcls = []
    for i in range(cc.n):
        rt = cc.r_tree[i]
        if cc.joint_types[i] == "p":
            rcls.append(rt)
            continue
        c, s = torch.cos(q[i]), torch.sin(q[i])
        rcls.append(
            [
                [c * rt[r][0] + s * rt[r][1], -s * rt[r][0] + c * rt[r][1],
                 rt[r][2] + 0.0 * c]
                for r in range(3)
            ]
        )
    return rcls


def _local_ps(cc, q):
    """p_cl[i]: revolute = the constant joint origin; prismatic = origin
    translated along the child z axis by q_i."""
    pcls = []
    for i in range(cc.n):
        pt = cc.p_tree[i]
        if cc.joint_types[i] == "r":
            pcls.append(pt)
        else:
            rt = cc.r_tree[i]
            pcls.append([pt[r] + rt[r][2] * q[i] for r in range(3)])
    return pcls


def _i_mul6(ii, v6):
    """Constant 6x6 spatial inertia times a 6-channel vector; zero entries of
    the constant matrix are skipped."""
    out = []
    for r in range(6):
        acc = None
        for c in range(6):
            w = ii[r][c]
            if w == 0.0:
                continue
            term = w * v6[c]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else 0.0 * v6[0])
    return out


def _force_to_parent(r, p, n, f):
    """Spatial force (n, f) from child coords to parent coords."""
    f_p = _m_vec(r, f)
    n_p = _v_add(_m_vec(r, n), _v_cross(p, f_p))
    return n_p, f_p


def bias_and_mass_channels(cc: _Consts, q, qd):
    """RNEA bias C (n channels) + CRBA mass matrix M (nxn channel grid)."""
    rcl = _local_rots(cc, q)
    pcl = _local_ps(cc, q)
    zero = 0.0 * q[0]

    # --- forward sweep: velocities and bias accelerations (qdd = 0) ---
    w = [zero, zero, zero]
    v = [zero, zero, zero]
    dw = [zero, zero, zero]
    dv = [zero, zero, zero + cc.gravity]
    ws, vs, dws, dvs = [], [], [], []
    for i in range(cc.n):
        r, p = rcl[i], pcl[i]
        v = _mT_vec(r, _v_add(v, _v_cross(w, p)))
        w = _mT_vec(r, w)
        dv = _mT_vec(r, _v_add(dv, _v_cross(dw, p)))
        dw = _mT_vec(r, dw)
        sq = qd[i]
        if cc.joint_types[i] == "r":
            dw = _v_add(dw, [w[1] * sq, -w[0] * sq, zero])
            dv = _v_add(dv, [v[1] * sq, -v[0] * sq, zero])
            w = [w[0], w[1], w[2] + sq]
        else:
            dv = _v_add(dv, [w[1] * sq, -w[0] * sq, zero])
            v = [v[0], v[1], v[2] + sq]
        ws.append(w)
        vs.append(v)
        dws.append(dw)
        dvs.append(dv)

    # --- per-link bias force: f = I a + v x* (I v) ---
    fs = []
    for i in range(cc.n):
        mv = ws[i] + vs[i]
        ma = dws[i] + dvs[i]
        iv = _i_mul6(cc.i_spatial[i], mv)
        fa = _i_mul6(cc.i_spatial[i], ma)
        n_c = _v_add(_v_cross(ws[i], iv[:3]), _v_cross(vs[i], iv[3:]))
        f_c = _v_cross(ws[i], iv[3:])
        fs.append([fa[0] + n_c[0], fa[1] + n_c[1], fa[2] + n_c[2],
                   fa[3] + f_c[0], fa[4] + f_c[1], fa[5] + f_c[2]])

    # --- backward sweep: bias torques/forces ---
    c_out = [None] * cc.n
    n_acc = [zero, zero, zero]
    f_acc = [zero, zero, zero]
    for i in reversed(range(cc.n)):
        n_tot = _v_add(fs[i][:3], n_acc)
        f_tot = _v_add(fs[i][3:], f_acc)
        c_out[i] = n_tot[2] if cc.joint_types[i] == "r" else f_tot[2]
        n_acc, f_acc = _force_to_parent(rcl[i], pcl[i], n_tot, f_tot)

    # --- CRBA: composite inertias (6x6 as 3x3 blocks) then M ---
    ic = []
    for i in range(cc.n):
        isp = cc.i_spatial[i]
        mk = lambda r0, c0: [[isp[r0 + r][c0 + c] + zero for c in range(3)]
                             for r in range(3)]
        ic.append({"A": mk(0, 0), "B": mk(0, 3), "D": mk(3, 3)})

    for i in reversed(range(1, cc.n)):
        r, p = rcl[i], pcl[i]
        rt = _m_T(r)
        s_m = [[-x for x in row]
               for row in _m_mul(rt, _skew([p[0] + zero, p[1] + zero, p[2] + zero]))]
        a_m, b_m, d_m = ic[i]["A"], ic[i]["B"], ic[i]["D"]
        rta = _m_mul(_m_T(rt), a_m)
        rtb = _m_mul(_m_T(rt), b_m)
        rtd = _m_mul(_m_T(rt), d_m)
        std = _m_mul(_m_T(s_m), d_m)
        e_m = _m_mul(rtb, s_m)
        tl = _m_mul(rta, rt)
        sds = _m_mul(std, s_m)
        tl = [[tl[r][c] + e_m[r][c] + e_m[c][r] + sds[r][c] for c in range(3)]
              for r in range(3)]
        tr = _m_mul(rtb, rt)
        sdr = _m_mul(std, rt)
        tr = [[tr[r][c] + sdr[r][c] for c in range(3)] for r in range(3)]
        br = _m_mul(rtd, rt)
        ic[i - 1] = {
            "A": [[ic[i - 1]["A"][r][c] + tl[r][c] for c in range(3)] for r in range(3)],
            "B": [[ic[i - 1]["B"][r][c] + tr[r][c] for c in range(3)] for r in range(3)],
            "D": [[ic[i - 1]["D"][r][c] + br[r][c] for c in range(3)] for r in range(3)],
        }

    m_mat = [[None] * cc.n for _ in range(cc.n)]
    for i in range(cc.n):
        if cc.joint_types[i] == "r":
            n_f = [ic[i]["A"][0][2], ic[i]["A"][1][2], ic[i]["A"][2][2]]
            f_f = [ic[i]["B"][2][0], ic[i]["B"][2][1], ic[i]["B"][2][2]]
        else:
            n_f = [ic[i]["B"][0][2], ic[i]["B"][1][2], ic[i]["B"][2][2]]
            f_f = [ic[i]["D"][0][2], ic[i]["D"][1][2], ic[i]["D"][2][2]]
        m_mat[i][i] = n_f[2] if cc.joint_types[i] == "r" else f_f[2]
        for j in reversed(range(i)):
            n_f, f_f = _force_to_parent(rcl[j + 1], pcl[j + 1], n_f, f_f)
            mij = n_f[2] if cc.joint_types[j] == "r" else f_f[2]
            m_mat[i][j] = mij
            m_mat[j][i] = mij
    return c_out, m_mat


def _chol_solve7(m_mat, rhs):
    """qdd = M^{-1} rhs via fully-unrolled Cholesky (channel form)."""
    n = len(m_mat)
    l_mat = [[None] * n for _ in range(n)]
    for j in range(n):
        acc = m_mat[j][j]
        for k in range(j):
            acc = acc - l_mat[j][k] * l_mat[j][k]
        l_mat[j][j] = torch.sqrt(acc)
        inv = 1.0 / l_mat[j][j]
        for i in range(j + 1, n):
            acc = m_mat[i][j]
            for k in range(j):
                acc = acc - l_mat[i][k] * l_mat[j][k]
            l_mat[i][j] = acc * inv
    z = [None] * n
    for i in range(n):
        acc = rhs[i]
        for k in range(i):
            acc = acc - l_mat[i][k] * z[k]
        z[i] = acc / l_mat[i][i]
    y = [None] * n
    for i in reversed(range(n)):
        acc = z[i]
        for k in range(i + 1, n):
            acc = acc - l_mat[k][i] * y[k]
        y[i] = acc / l_mat[i][i]
    return y


def qdd_channels(cc: _Consts, q, qd, tau):
    """Forward dynamics qdd (n channels) = M^{-1}(tau - C)."""
    c_vec, m_mat = bias_and_mass_channels(cc, q, qd)
    rhs = [tau[i] - c_vec[i] for i in range(cc.n)]
    return _chol_solve7(m_mat, rhs)


# ---------- tensor-in / tensor-out wrappers ----------

def _split(x, n):
    # channels keep a trailing unit dim: forward-mode AD (torch.func.jvp)
    # promotes a 0-d float32 tensor times a Python float to float64
    return [x[..., i:i + 1] for i in range(n)]


class SerialArmSoA:
    """Array API over the scalar-channel core for any revolute/prismatic
    chain.  Accepts single samples (x: (2n,)) or any leading batch dims
    (x: (..., 2n))."""

    def __init__(self, cc: _Consts):
        self.cc = cc
        self.n = cc.n
        self.gravity = cc.gravity
        self._tensors = {}        # (device, dtype) -> `_frame_consts`

    def forward_dynamics(self, x, u):
        n = self.n
        q = _split(x[..., :n], n)
        qd = _split(x[..., n:], n)
        tau = _split(u, n)
        return torch.cat(qdd_channels(self.cc, q, qd, tau), dim=-1)

    def bias_and_mass(self, q, qd):
        n = self.n
        c_ch, m_ch = bias_and_mass_channels(self.cc, _split(q, n), _split(qd, n))
        c_vec = torch.cat(c_ch, dim=-1)
        m_mat = torch.stack([torch.cat(row, dim=-1) for row in m_ch], dim=-2)
        return c_vec, m_mat

    def inverse_dynamics(self, q, qd, qdd):
        c_vec, m_mat = self.bias_and_mass(q, qd)
        return torch.einsum("...ij,...j->...i", m_mat, qdd) + c_vec

    def _frame_consts(self, like):
        """(r_tree (n, 3, 3), p_tree (n, 3), ee_offset (3,), ee_rot or None,
        revolute mask (n,), 0-d zero, 0-d one, identity mask (n, n)) as
        tensors on like's device, made once per device and dtype: a copy from
        the host on every call would synchronise the stream."""
        key = (like.device, like.dtype)
        found = self._tensors.get(key)
        if found is None:
            cc, f = self.cc, dict(dtype=like.dtype, device=like.device)
            found = (torch.as_tensor(cc.r_tree, **f), torch.as_tensor(cc.p_tree, **f),
                     torch.as_tensor(cc.ee_offset, **f),
                     None if cc.ee_rot is None else torch.as_tensor(cc.ee_rot, **f),
                     torch.as_tensor([t == "r" for t in cc.joint_types], device=like.device),
                     torch.zeros((), **f), torch.ones((), **f),
                     torch.eye(self.n, dtype=torch.bool, device=like.device))
            self._tensors[key] = found
        return found

    def _frames(self, q, tangents: bool = False):
        """The FK chain: (EE rotation (..., 3, 3), EE position (..., 3)) and,
        with tangents=True, their derivatives along each joint,
        (..., n, 3, 3) and (..., n, 3) with joint j on dim -3 / -2.

        Unlike the dynamics, FK keeps the joint index as a tensor dimension
        and chains batched 3x3 products: a few dozen launches instead of the
        scalar channels' hundreds, the same math (the reference's
        `fk_channels`: R_w <- R_w R_local, p_w <- p_w + R_w p_local).  The
        tangents are forward-mode AD written out: all n unit tangents in one
        pass, each product differentiated by the rule PyTorch's forward AD
        applies to it, so they equal `torch.func.jacfwd`'s bit for bit on the
        CPU."""
        n = self.n
        r_tree, p_tree, off, ee_rot, revolute, zero, one, eye = self._frame_consts(q)
        # local frames (`_local_rots`, `_local_ps`): R_tree[i] Rz(q_i) and the
        # joint origin, or R_tree[i] and the origin slid along z by q_i
        cq, sq = torch.cos(q), torch.sin(q)
        c = torch.where(revolute, cq, one)[..., None]                      # (..., n, 1)
        s = torch.where(revolute, sq, zero)[..., None]
        rt0, rt1, rt2 = r_tree.unbind(-1)                                  # (n, 3) columns
        r_loc = torch.stack([c * rt0 + s * rt1, c * rt1 - s * rt0,
                             rt2.expand(q.shape + (3,))], dim=-1)          # (..., n, 3, 3)
        p_loc = p_tree + torch.where(revolute, zero, q)[..., None] * rt2  # (..., n, 3)
        r_w, p_w = r_loc[..., 0, :, :], p_loc[..., 0, :]
        if tangents:
            # q_j moves only local frame j: (cos, sin)' = (-sin, cos) for a
            # revolute joint, the origin's slide along z for a prismatic one
            dc = torch.where(revolute, -sq, zero)[..., None]
            ds = torch.where(revolute, cq, zero)[..., None]
            d_own = torch.stack([dc * rt0 + ds * rt1, dc * rt1 - ds * rt0,
                                 zero.expand(q.shape + (3,))], dim=-1)     # (..., n, 3, 3)
            dp_own = (torch.where(revolute, zero, one)[..., None] * rt2
                      + torch.zeros_like(p_loc))                          # (..., n, 3)
            dr_loc = torch.where(eye[:, :, None, None], d_own[..., None, :, :, :], zero)
            dp_loc = torch.where(eye[:, :, None], dp_own[..., None, :, :], zero)
            dr_w, dp_w = dr_loc[..., 0, :, :], dp_loc[..., 0, :]          # (..., n, 3, 3)
        for i in range(1, n):
            p_i, r_i = p_loc[..., i, :, None], r_loc[..., i, :, :]
            if tangents:
                dp_w = dp_w + (dr_w @ p_i[..., None, :, :]
                               + r_w[..., None, :, :] @ dp_loc[..., i, :, None])[..., 0]
                dr_w = dr_w @ r_i[..., None, :, :] + r_w[..., None, :, :] @ dr_loc[..., i, :, :]
            p_w = p_w + (r_w @ p_i)[..., 0]
            r_w = r_w @ r_i
        p_ee = p_w + r_w @ off                                             # (..., 3)
        r_ee = r_w if ee_rot is None else r_w @ ee_rot
        if not tangents:
            return r_ee, p_ee
        return (r_ee, p_ee, dr_w if ee_rot is None else dr_w @ ee_rot,
                dp_w + dr_w @ off)

    def ee_pose(self, q):
        """EE [xyz, rpy] (..., 6) (rpy extraction: dynamics_arm.cuh:1890-1895)."""
        r, p = self._frames(q)
        # entries keep a trailing unit dim, as the channels do (`_split`)
        r00, r10, r20 = r[..., 0, 0:1], r[..., 1, 0:1], r[..., 2, 0:1]
        r21, r22 = r[..., 2, 1:2], r[..., 2, 2:3]
        roll = torch.atan2(r21, r22)
        pitch = torch.atan2(-r20, torch.sqrt(r21 ** 2 + r22 ** 2))
        yaw = torch.atan2(r10, r00)
        return torch.cat([p, roll, pitch, yaw], dim=-1)

    def ee_pose_jacobian(self, q):
        """d ee_pose / dq: (..., n) -> (..., 6, n), by forward mode over
        `_frames` with the n unit tangents in one pass, then through the
        three atan2 of `ee_pose` by the same rules.  Equal to
        `torch.func.jacfwd(ee_pose)` bit for bit on the CPU, without its
        transforms (under `torch.func` it took ~90 ms a call on an H100)."""
        if not set(self.cc.joint_types) <= {"r", "p"}:
            raise NotImplementedError(f"joint types {self.cc.joint_types!r}")
        # over a flat batch, as `torch.func.vmap` of jacfwd runs it
        r, _, dr, dp = self._frames(q.reshape(-1, self.n), tangents=True)
        r00, r10, r20 = (r[..., None, i, 0] for i in range(3))            # (..., 1)
        r21, r22 = r[..., None, 2, 1], r[..., None, 2, 2]
        d00, d10, d20 = (dr[..., i, 0] for i in range(3))                 # (..., n)
        d21, d22 = dr[..., 2, 1], dr[..., 2, 2]

        def atan2_t(y, x, dy, dx):        # forward-mode rule of atan2(y, x)
            return (x * dy - y * dx) / (y * y + x * x)

        h = torch.sqrt(r21 ** 2 + r22 ** 2)
        dh = (2 * r21 * d21 + 2 * r22 * d22) / (2 * h)
        d_rpy = (atan2_t(r21, r22, d21, d22), atan2_t(-r20, h, -d20, dh),
                 atan2_t(r10, r00, d10, d00))
        jac = torch.cat([dp] + [d[..., None] for d in d_rpy], dim=-1).transpose(-1, -2)
        return jac.reshape(q.shape[:-1] + (6, self.n))

    def ee_velocity(self, x):
        q, qd = x[..., : self.n], x[..., self.n:]
        return torch.func.jvp(self.ee_pose, (q,), (qd,))[1]


class KukaSoA(SerialArmSoA):
    """SerialArmSoA bound to the cached iiwa-14 constants."""

    def __init__(self, ee_type: int = 1, gravity: float = 9.81):
        super().__init__(_consts(ee_type, float(gravity)))
