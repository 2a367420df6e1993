"""Horizon ('sp') sharding of one iLQR solve (twin of `parallel_ddp_tpu/parallel/sp.py`).

The reference splits the TIME axis of one solve over the mesh's 'sp' axis:
each shard owns a contiguous chunk of whole backward blocks (M_BLOCKS_B /
S) and whole shooting blocks (M_BLOCKS_F / S), and the couplings between
blocks become collectives (`parallel/sharding.py::Collectives`):
  * the backward pass's block seeds: a chunk's last block seeds from its
    right neighbour's first (P, p, x, xp2) (`from_right`);
  * the forward sweep's recurrence e_{k+1} = (A-BK) e_k + c_k: a local
    associative scan (`parallel/scan.py`, JAX's pairing) over the chunk,
    every chunk's total transform gathered (`all_gather`), the exclusive
    prefix composed in chunk order;
  * the shooting defects at chunk ends: the right neighbour's swept start
    states (`from_right`);
  * the cost, the expected reduction, the defect norms and the retry flag
    (`psum`, `pmax`, `any`).
The line search and the accept/reject logic run replicated on every shard:
the iteration is the single solve's (`solver.py`) with its derivative stage,
passes and reductions taken chunk-local.

In one process the chunk axis is a dim of the solve's tensors,
(B, S, Nl, ...), on the inputs' device: on one card the whole 'sp' solve is
one CUDA-graph replay, its kernels launched at chunk-local shapes, once a
chunk where the reference calls once a device: the rollout kernel (Nl steps
over M_BLOCKS_F / S blocks, only the last chunk's last step skipped) and,
under `pallas_riccati`, the Riccati kernel (M_BLOCKS_B / S lanes, the
chunk's global step indices); the Jacobian kernel takes every chunk's
samples in one launch.  Over a process group each rank holds its chunks and
the collectives cross ranks (`gloo` on the CPU; `nccl` has not run), with
the host loops of the CPU (no graphs).

As in the reference, the sp path never reads `bf16_rollout`, `bf16_cost`
or `bp_assoc_scan`: its forward simulation and stage cost are float32 and
its backward pass is the block pass.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from parallel_ddp_tpu_torch.config import CostWeights, SolveOutput, SolverConfig
from parallel_ddp_tpu_torch.costs.base import CostModel
from parallel_ddp_tpu_torch.models.base import Plant
from parallel_ddp_tpu_torch.parallel.backward import (BackwardPassResult, make_riccati_step,
                                                      rho_retry, run_block)
from parallel_ddp_tpu_torch.parallel.forward import (RolloutResult, make_sim_block,
                                                     sweep_combine)
from parallel_ddp_tpu_torch.parallel.scan import associative_scan
from parallel_ddp_tpu_torch.parallel.sharding import (Collectives, Mesh, _check_mesh,
                                                      scatter_batch)
from parallel_ddp_tpu_torch.solver import _derivatives, _Solver, per_scenario

# the fields of a SolveOutput along the time axis (the rest are replicated)
TIME_FIELDS = ("x", "u", "K", "d", "P", "p")


class _SpSolver(_Solver):
    """The solve of `make_sp_solver` (and, with `batch_axis`, of
    `make_batched_sp_solver`): the single solve's body on this rank's chunks
    (see the module docstring)."""

    def __init__(self, plant: Plant, cost: CostModel, cfg: SolverConfig, mesh: Mesh, axis: str,
                 batch_axis: Optional[str] = None):
        _check_mesh(mesh)
        S = mesh.shape[axis]
        if cfg.m_blocks_b % S or cfg.m_blocks_f % S:
            raise ValueError(
                f"m_blocks_b={cfg.m_blocks_b} and m_blocks_f={cfg.m_blocks_f} "
                f"must both be divisible by the '{axis}' axis size {S}")
        if cfg.slq:
            raise NotImplementedError("SLQ is single-shooting; use the unsharded solver")
        super().__init__(plant, cost, cfg)
        self.ranks = mesh.ranks
        self.sp = Collectives(mesh, axis)
        self.dp = None if batch_axis is None else Collectives(mesh, batch_axis)
        self.S = S
        self.Nl = cfg.num_time_steps // S
        self.Mb_l = cfg.m_blocks_b // S
        self.Mf_l = cfg.m_blocks_f // S
        n, m = plant.n_state, plant.n_ctrl
        # the options the reference's sp path never reads
        self.step_fwd, self.stage = self.step_fn, cost.stage
        # the fused forward simulation at the chunk's shapes (Nl steps over
        # Mf_l blocks), and the fused Riccati sweep over the chunk's lanes
        self.fused_sim = None
        if plant.fused_rollout is not None:
            self.fused_sim = plant.fused_rollout(cfg.integrator, cfg.dt, self.Nl, self.Mf_l,
                                                 cfg.num_alpha)
        self.riccati_call = None
        if cfg.pallas_riccati:
            from parallel_ddp_tpu_torch.ops.cuda_riccati import make_riccati_block_call

            self.riccati_call = make_riccati_block_call(cfg, n, m, mb=self.Mb_l)
        self.step = make_riccati_step(cfg, n, m)
        self._consts = {}

    # ---------------- entry points ----------------

    def __call__(self, x0, u0, goal, weights: Optional[CostWeights] = None,
                 initial_rollout: bool = True, device=None) -> SolveOutput:
        """One solve: x0 (N, n), u0 (N, m); time-axis fields come back at
        global shape, the scalars replicated."""
        return self._entry(False, x0, u0, goal, weights, None, None, None, initial_rollout,
                           False, None, device)

    def solve_batch(self, x0s, u0s, goals, weights: Optional[CostWeights] = None,
                    initial_rollout: bool = True, device=None) -> SolveOutput:
        """B solves: x0s (B, N, n), u0s (B, N, m), goals with a leading B;
        B must divide by the batch axis's size."""
        if self.dp is not None and len(x0s) % self.dp.size:
            raise ValueError(f"batch {len(x0s)} not divisible by the batch axis size "
                             f"{self.dp.size}")
        return self._entry(True, x0s, u0s, goals, weights, None, None, None, initial_rollout,
                           False, None, device)

    def _replayed(self, device) -> bool:
        # over ranks the collectives run between the host loops' steps
        return self.ranks == 1 and super()._replayed(device)

    def run_batch(self, x0, u0, goal, P0, p0, d0, it_cap, w, initial_rollout: bool,
                  ignore_first_defect: bool, shared_goal: bool = False):
        """The single solve's `run_batch` on this rank's scenarios and
        chunks; returns the whole batch's and horizon's output on every
        rank."""
        dp = self.dp if self.dp is not None and self.dp.group is not None else None
        if dp is not None:
            x0, u0, goal = scatter_batch(dp, x0, u0, goal)
        out, syncs = super().run_batch(self.sp.scatter(x0, 1), self.sp.scatter(u0, 1), goal,
                                       P0, p0, d0, it_cap, w, initial_rollout,
                                       ignore_first_defect, shared_goal)
        out = out._replace(**{f: self.sp.all_gather(getattr(out, f), 1) for f in TIME_FIELDS})
        if dp is not None:
            out = SolveOutput(*(dp.all_gather(t, 0) for t in out))
        return out, syncs

    # ---------------- chunk-local pieces ----------------

    def _chunk_consts(self, device) -> SimpleNamespace:
        """This rank's chunks' global step indices and masks, made once a
        device (before any capture: the eager warm-up runs the body)."""
        if device not in self._consts:
            cfg, Nl = self.cfg, self.Nl
            nf = cfg.num_time_steps - 1
            Nf = cfg.n_blocks_f
            chunk = torch.arange(self.sp.first, self.sp.first + self.sp.count, device=device)
            ks = chunk[:, None] * Nl + torch.arange(Nl, device=device)       # (S_l, Nl)
            last = chunk == self.S - 1
            k_f = ks.reshape(-1, self.Mf_l, Nf)
            self._consts[device] = SimpleNamespace(
                ks=ks,
                k_blk_b=ks.reshape(-1, self.Mb_l, cfg.n_blocks_b),
                k_blk_f=k_f,
                # the horizon's very last step, the one never simulated
                skip=[(k == nf).to(torch.uint8).contiguous() for k in k_f],
                # the globally final backward block (terminal seed) and
                # shooting block (no defect)
                final_b=last[:, None] & (torch.arange(self.Mb_l, device=device) == self.Mb_l - 1),
                final_f=last[:, None] & (torch.arange(self.Mf_l, device=device) == self.Mf_l - 1),
                on_boundary=((ks + 1) % Nf == 0) & (ks < nf),
            )
        return self._consts[device]

    def _chunks(self, t: torch.Tensor) -> torch.Tensor:
        """(B, S_l*Nl, ...) -> (B, S_l, Nl, ...), a view."""
        return t.reshape((t.shape[0], self.sp.count, self.Nl) + t.shape[2:])

    def _open_loop(self, x0, u0):
        """The cold start's rollout of the chunk's shooting blocks; the
        chunk's last defect against the right neighbour's first block start
        (none after the horizon's last block)."""
        B, n, m = x0.shape[0], x0.shape[-1], u0.shape[-1]
        Nf = self.cfg.n_blocks_f
        k = self._chunk_consts(x0.device)
        x_blk = x0.reshape(B, self.sp.count, self.Mf_l, Nf, n)
        u_blk = u0.reshape(B, self.sp.count, self.Mf_l, Nf, m)
        x_next = self.chain.open_loop(x_blk[..., 0, :], u_blk)              # (B, S_l, Mf_l, Nf, n)
        x_new = torch.cat([x_blk[..., :1, :], x_next[..., :-1, :]], dim=-2).reshape(x0.shape)
        right = self.sp.from_right(x_blk[:, :, 0, 0], dim=1)              # (B, S_l, n)
        next_starts = torch.cat([x_blk[:, :, 1:, 0], right[:, :, None]], dim=2)
        d_bnd = x_next[..., -1, :] - next_starts
        d_bnd = torch.where(k.final_f[..., None], torch.zeros_like(d_bnd), d_bnd)
        d = x0.new_zeros((B, self.sp.count, self.Nl, n))
        d[:, :, Nf - 1::Nf] = d_bnd
        return x_new, d.reshape(x0.shape)

    def _total_cost(self, stage, x, u):
        ks = self._chunk_consts(x.device).ks
        return self.sp.psum(stage(self._chunks(x), self._chunks(u), ks).sum(-1), dim=1)

    def _defect_norm(self, d):
        return self.sp.pmax(self._chunks(d).abs().sum(-1).amax(-1), dim=1)

    def _passes(self, c, goal, w, stage, alphas):
        k = self._chunk_consts(c.x.device)
        x, u, d, xp2, P, p = (self._chunks(t) for t in (c.x, c.u, c.d, c.xp2, c.P, c.p))
        AB, H, g = _derivatives(self.cfg, self.step_jac, per_scenario(self.cost.quad, c.goal_dims),
                                x, u, goal, w, ks=k.ks)
        bp = self._backward(k, AB, H, g, P, p, d, x, xp2, c.rho, c.drho)
        return bp, self._forward(k, stage, x, u, d, bp, alphas)

    def _backward(self, k, AB, H, g, Pp, pp, d, x, xp2, rho0, drho0) -> BackwardPassResult:
        """The block pass over the chunk's Mb_l blocks (the reference's
        `_backward_sp`): every input (B, S_l, Nl, ...), AB with its row at
        the global k = N-1 zero."""
        cfg, sp = self.cfg, self.sp
        B, S_l, Mb_l, Nb = x.shape[0], sp.count, self.Mb_l, self.cfg.n_blocks_b
        n = x.shape[-1]
        blk = lambda t: t.reshape((B, S_l, Mb_l, Nb) + t.shape[3:])
        flat = lambda t, tail: t.reshape((B, S_l * self.Nl) + t.shape[t.dim() - tail:])

        def seeds(t):
            """Each block's seed: the next block's first entry, the chunk's
            last block's from the right neighbour."""
            heads = blk(t)[:, :, :, 0]
            right = sp.from_right(heads[:, :, 0], dim=1)
            return torch.cat([heads[:, :, 1:], right[:, :, None]], dim=2)

        seeds_P, seeds_p = seeds(Pp), seeds(pp)
        if cfg.linear_transform_switch:
            # through the state change (linearXfrmOrLoad, bpHelpers.cuh:16-34)
            seeds_p = seeds_p + (seeds_P @ (seeds(x) - seeds(xp2))[..., None])[..., 0]
        # the globally final block starts from the terminal expansion
        # (bpHelpers.cuh:361-367)
        seeds_P = torch.where(k.final_b[..., None, None], H[:, :, -1, None, :n, :n], seeds_P)
        seeds_p = torch.where(k.final_b[..., None], g[:, :, -1, None, :n], seeds_p)
        AB_b, H_b, g_b, d_b = blk(AB), blk(H), blk(g), blk(d)
        tails = (2, 1, 2, 1, 2, 1)              # P, p, K, du, ApBK, Bdu: trailing dims

        if self.riccati_call is not None:
            def attempt(rho):
                # one launch a chunk, at its Mb_l lanes and global step indices
                outs = [self.riccati_call(rho, seeds_P[:, j], seeds_p[:, j], AB_b[:, j],
                                          H_b[:, j], g_b[:, j], d_b[:, j], k.k_blk_b[j])
                        for j in range(S_l)]
                fields = [torch.stack(f, dim=1) for f in zip(*outs)]
                return (*(flat(t, tl) for t, tl in zip(fields[:6], tails)),
                        sp.psum(fields[6], dim=1), sp.any(fields[7], dim=1))
        else:
            def attempt(rho):
                outs = run_block(self.step, rho[:, None, None], seeds_P, seeds_p, AB_b, H_b, g_b,
                                 d_b, k.k_blk_b)
                return (*(flat(t, tl) for t, tl in zip(outs[:6], tails)),
                        sp.psum(outs[6].sum(dim=(2, 3)), dim=1),
                        sp.any(outs[7].any(-1).any(-1), dim=1))

        return rho_retry(cfg, attempt, rho0, drho0)

    def _sweep(self, k, ApBK, Bdu, d, x, alphas):
        """The forward sweep across chunks (the reference's `_sweep_sp`):
        inputs (B, S_l, Nl, ...); returns x_swept (B, S_l, A, Nl, n)."""
        n = x.shape[-1]
        c = (-alphas[:, None] * Bdu[..., None, :]
             + torch.where(k.on_boundary[..., None], d, torch.zeros_like(d))[..., None, :])
        # the local inclusive scan over all Nl steps (the globally final
        # step's entry is never consumed)
        Mscan, Vscan = associative_scan(sweep_combine, (ApBK, c), dim=2)
        # every chunk's total transform, and the exclusive prefix of each
        Mg = self.sp.all_gather(Mscan[:, :, -1], dim=1)                    # (B, S, n, n)
        Vg = self.sp.all_gather(Vscan[:, :, -1], dim=1)                    # (B, S, A, n)
        pms = [torch.eye(n, dtype=x.dtype, device=x.device).expand(Mg[:, 0].shape)]
        pvs = [torch.zeros_like(Vg[:, 0])]
        for i in range(1, self.S):
            pm, pv = sweep_combine((pms[-1], pvs[-1]), (Mg[:, i - 1], Vg[:, i - 1]))
            pms.append(pm)
            pvs.append(pv)
        lo, hi = self.sp.first, self.sp.first + self.sp.count
        pm, pv = torch.stack(pms[lo:hi], dim=1), torch.stack(pvs[lo:hi], dim=1)
        # e entering local step k: the chunk's prefix at k = 0, else the
        # local scan up to k-1 composed with it
        _, Vloc = sweep_combine((pm[:, :, None], pv[:, :, None]), (Mscan[:, :, :-1],
                                                                   Vscan[:, :, :-1]))
        e_at = torch.cat([pv[:, :, None], Vloc], dim=2)                    # (B, S_l, Nl, A, n)
        return x[:, :, None] + e_at.transpose(2, 3)

    def _forward(self, k, stage, x, u, d, bp, alphas) -> RolloutResult:
        """The sweep, the multiple-shooting rollout and the reductions over
        the chunks (the reference's `_rollout_sp`); candidates come back as
        (B, A, S_l*Nl, ...)."""
        cfg, sp = self.cfg, self.sp
        B, S_l, Nl, n, m = x.shape[0], sp.count, self.Nl, x.shape[-1], u.shape[-1]
        Mf_l, Nf, A = self.Mf_l, cfg.n_blocks_f, alphas.shape[0]
        K, du, ApBK, Bdu = (self._chunks(t) for t in (bp.K, bp.du, bp.ApBK, bp.Bdu))
        if cfg.m_blocks_f > 1:
            x_swept = self._sweep(k, ApBK, Bdu, d, x, alphas)
        else:
            x_swept = x[:, :, None].expand(B, S_l, A, Nl, n)
        xs_blk = x_swept.reshape(B, S_l, A, Mf_l, Nf, n)
        if self.fused_sim is not None:
            # one launch a chunk; only the last chunk's last step is skipped
            outs = [self.fused_sim(x_swept[:, j], u[:, j], K[:, j], du[:, j], x[:, j], alphas,
                                   skip_mask=k.skip[j]) for j in range(S_l)]
            x_next_all, u_new_all = (torch.stack(f, dim=1) for f in zip(*outs))
        else:
            sim_block = make_sim_block(self.step_fwd, cfg.num_time_steps - 1)
            per_chunk = lambda t, *tail: t.reshape((B, S_l, 1, Mf_l, Nf) + tail)
            x_next_all, u_new_all = sim_block(
                alphas[:, None], xs_blk[..., 0, :], per_chunk(u, m), per_chunk(K, m, n),
                per_chunk(du, m), per_chunk(x, n), k.k_blk_f[:, None])
        # x_next_all: (B, S_l, A, Mf_l, Nf, n)

        x_cand = torch.cat([xs_blk[..., :1, :], x_next_all[..., :-1, :]], dim=-2)
        x_cand = x_cand.reshape(B, S_l, A, Nl, n)
        u_cand = u_new_all.reshape(B, S_l, A, Nl, m)
        # defects: the chunk's last block against the right neighbour's swept
        # start states, per alpha; none after the horizon's last block
        right = sp.from_right(xs_blk[:, :, :, 0, 0], dim=1)                # (B, S_l, A, n)
        next_starts = torch.cat([xs_blk[:, :, :, 1:, 0], right[:, :, :, None]], dim=3)
        drop = k.final_f[:, None, :, None]
        d_bnd = x_next_all[..., -1, :] - next_starts                       # (B, S_l, A, Mf_l, n)
        d_bnd = torch.where(drop, torch.zeros_like(d_bnd), d_bnd)
        d_cand = x.new_zeros((B, S_l, A, Nl, n))
        d_cand[..., Nf - 1::Nf, :] = d_bnd
        norms = d_bnd.abs().sum(-1)
        max_defect = sp.pmax(torch.where(drop[..., 0], torch.zeros_like(norms), norms).amax(-1),
                             dim=1)                                        # (B, A)
        J = sp.psum(stage(x_cand, u_cand, k.ks[:, None, :]).sum(-1), dim=1)  # (B, A)
        to_carry = lambda t: t.transpose(1, 2).reshape((B, A, S_l * Nl) + t.shape[-1:])
        return RolloutResult(to_carry(x_cand), to_carry(u_cand), to_carry(d_cand), J, max_defect)


def make_sp_solver(plant: Plant, cost: CostModel, cfg: SolverConfig, mesh: Mesh,
                   axis: str = "sp") -> _SpSolver:
    """Build solve(x0, u0, goal, weights=None, initial_rollout=True,
    device=None) -> SolveOutput with the horizon sharded over `axis` of
    `mesh` (the reference's `make_sp_solver`): x0 (N, n), u0 (N, m).
    Time-axis fields come back at global shape, the scalars replicated.
    Raises ValueError unless m_blocks_b and m_blocks_f both divide by the
    axis size, NotImplementedError for `cfg.slq`.  `bf16_rollout`,
    `bf16_cost` and `bp_assoc_scan` are not read (the reference's sp path
    does not read them).  The solver keeps `graphs` and `host_syncs` as
    `make_ilqr_solver`'s does."""
    return _SpSolver(plant, cost, cfg, mesh, axis)


def make_batched_sp_solver(plant: Plant, cost: CostModel, cfg: SolverConfig, mesh: Mesh,
                           batch_axis: str = "dp", axis: str = "sp"):
    """The 2-D form (the reference's `make_batched_sp_solver`): scenarios
    over `batch_axis`, each solve's horizon over `axis`.  Returns
    solve_batch(x0s (B, N, n), u0s (B, N, m), goals (a leading B on each
    tensor leaf), weights=None, initial_rollout=True) -> SolveOutput with a
    leading B; `solve_batch.solver` is the solver.  In one process every
    scenario and chunk is one solve (the scenarios a batch, as in
    `make_batched_solver`); over ranks each solves its scenarios' chunks."""
    solver = _SpSolver(plant, cost, cfg, mesh, axis, batch_axis)

    def solve_batch(x0s, u0s, goals, weights: Optional[CostWeights] = None,
                    initial_rollout: bool = True) -> SolveOutput:
        return solver.solve_batch(x0s, u0s, goals, weights, initial_rollout=initial_rollout)

    solve_batch.solver = solver
    return solve_batch
