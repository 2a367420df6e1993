"""Fused block-Riccati backward sweep: the CUDA kernel and its plain version.

Twin of `parallel_ddp_tpu/ops/pallas_riccati.py`.  The factory
`make_riccati_block_call(cfg, n, m)` returns

    bp(rho, seeds_P (...,Mb,n,n), seeds_p (...,Mb,n), AB_blk (...,Mb,Nb,n,n+m),
       H_blk (...,Mb,Nb,n+m,n+m), g_blk (...,Mb,Nb,n+m), d_blk (...,Mb,Nb,n),
       k_blk (Mb,Nb) global step indices)
      -> (P (...,Mb*Nb,n,n), p, K, du, ApBK, Bdu, dJexp (...,2), fail bool (...))

one rho attempt of the block-parallel backward pass (backPassKern,
bpHelpers.cuh:336-420), for one problem or, with leading scenario dims
"...", for a batch of independent ones (rho then has the scenario dims):
  * on CPU tensors, the plain version: `parallel/backward.py::run_block` over
    all block lanes at once (the per-step recursion `make_riccati_step`);
  * on CUDA tensors, the kernel `csrc/riccati.cu` (one thread block per
    lane, every scenario's lanes in one launch, the block's inputs staged
    into shared memory ahead of the sweep, the cost-to-go in shared memory
    across the block's steps), or it raises.
Inside the kernel rho is one value or one per lane; dJ is summed per lane and
then over each scenario's lanes in lane order, and fail is the OR of a
scenario's lanes, all in the kernel.
"""

from __future__ import annotations

import torch

from parallel_ddp_tpu_torch.ops import build
from parallel_ddp_tpu_torch.parallel.backward import make_riccati_step, run_block

# the sizes csrc/riccati.cu takes (RIC_NMAX, RIC_MMAX)
MAX_N = 16
MAX_M = 8


def riccati_cuda(rho, seeds_P, seeds_p, AB_blk, H_blk, g_blk, d_blk, k_blk, *,
                 nf: int, n_blocks_f: int, state_reg: bool, use_defect: bool):
    """Launch the Riccati kernel on S = prod(...) scenarios of Mb lanes:
    seeds_P (..., Mb, n, n) etc.  rho is a 0-d tensor (one value for every
    lane) or (..., Mb) (one per lane); k_blk (Mb, Nb) is int64.  Returns the
    per-step outputs flattened over (lane, step), (..., Mb*Nb, ...), and dJ
    (..., 2) and fail (...) bool reduced over each scenario's lanes by the
    kernel.  All outputs are views of one allocation."""
    *lead, Mb, Nb, n, nm = AB_blk.shape
    lead = tuple(lead)
    S = 1
    for d in lead:
        S *= d
    m = nm - n
    if n > MAX_N or m > MAX_M:
        raise ValueError(f"the Riccati kernel takes n <= {MAX_N}, m <= {MAX_M}; got n={n}, m={m}")
    build.check_input("rho", rho, lead + (Mb,) if rho.dim() else ())
    build.check_input("seeds_P", seeds_P, lead + (Mb, n, n))
    build.check_input("seeds_p", seeds_p, lead + (Mb, n))
    build.check_input("AB_blk", AB_blk, lead + (Mb, Nb, n, nm))
    build.check_input("H_blk", H_blk, lead + (Mb, Nb, nm, nm))
    build.check_input("g_blk", g_blk, lead + (Mb, Nb, nm))
    build.check_input("d_blk", d_blk, lead + (Mb, Nb, n))
    build.check_input("k_blk", k_blk, (Mb, Nb), torch.int64)
    dev = AB_blk.device
    for t in (rho, seeds_P, seeds_p, H_blk, g_blk, d_blk, k_blk):
        if t.device != dev:
            raise ValueError("all Riccati inputs must be on one device")
    steps = Mb * Nb
    # P, p, K, du, ApBK, Bdu, dJ, fail (S bytes), then the per-lane dJ and
    # fail the kernel reduces and its counters of finished lanes, one a
    # scenario (per-lane fail flags and the counters are int32 in
    # float32-sized slots)
    sizes = (S * steps * n * n, S * steps * n, S * steps * m * n, S * steps * m,
             S * steps * n * n, S * steps * n, 2 * S, (S + 3) // 4, 2 * S * Mb, S * Mb, S)
    buf = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
    P, p, K, du, ApBK, Bdu, dj, fail = buf.split(sizes)[:8]
    ptrs, at = [], buf.data_ptr()
    for size in sizes:
        ptrs.append(at)
        at += 4 * size
    build.launch(
        "pddp_riccati", dev, seeds_P.data_ptr(), seeds_p.data_ptr(), rho.data_ptr(),
        1 if rho.dim() else 0, AB_blk.data_ptr(), H_blk.data_ptr(), g_blk.data_ptr(),
        d_blk.data_ptr(), k_blk.data_ptr(), *ptrs[:6], ptrs[8], ptrs[9], ptrs[6], ptrs[7],
        ptrs[10], S, Mb, Nb, n, m, nf, n_blocks_f, int(state_reg), int(use_defect), None)
    riccati_cuda.counter.hit(dev)
    out = lead + (steps,)
    # the kernel wrote fail as one byte a scenario, 0 or 1: a valid bool
    return (P.view(out + (n, n)), p.view(out + (n,)), K.view(out + (m, n)), du.view(out + (m,)),
            ApBK.view(out + (n, n)), Bdu.view(out + (n,)), dj.view(lead + (2,)),
            fail.view(torch.uint8)[:S].view(torch.bool).view(lead))


riccati_cuda.counter = build.launch_counter("riccati")


def make_riccati_block_call(cfg, n: int, m: int, mb: int | None = None):
    """Factory for the fused backward-sweep attempt (see the module
    docstring).  `mb` is the number of block lanes a scenario (default
    cfg.m_blocks_b); rho is a number or 0-d (every lane), one value a
    scenario (...), or one a lane (..., Mb).
    Raises if the plant is larger than the kernel's shared-memory sizing."""
    if n > MAX_N or m > MAX_M:
        raise ValueError(f"the Riccati kernel takes n <= {MAX_N}, m <= {MAX_M}; got n={n}, m={m}")
    Mb = cfg.m_blocks_b if mb is None else mb
    Nb = cfg.n_blocks_b
    nf = cfg.num_time_steps - 1
    use_defect = cfg.m_blocks_f > 1
    step = make_riccati_step(cfg, n, m)

    def bp(rho, seeds_P, seeds_p, AB_blk, H_blk, g_blk, d_blk, k_blk):
        dtype = AB_blk.dtype
        lead = AB_blk.shape[:-4]
        rho = torch.as_tensor(rho, dtype=dtype, device=AB_blk.device)
        if rho.dim() and rho.dim() == len(lead):   # one value a scenario: one a lane
            rho = rho[..., None].expand(lead + (Mb,))
        if AB_blk.device.type == "cpu":
            flat = lambda a: a.reshape(lead + (Mb * Nb,) + a.shape[len(lead) + 2:])
            P, p, K, du, ApBK, Bdu, dj, fail = run_block(
                step, rho.expand(lead + (Mb,)), seeds_P, seeds_p, AB_blk, H_blk, g_blk,
                d_blk, k_blk)
            return (flat(P), flat(p), flat(K), flat(du), flat(ApBK), flat(Bdu),
                    dj.sum(dim=(-3, -2)), fail.any(-1).any(-1))
        return riccati_cuda(
            rho.contiguous(), seeds_P.contiguous(), seeds_p.contiguous(), AB_blk.contiguous(),
            H_blk.contiguous(), g_blk.contiguous(), d_blk.contiguous(),
            k_blk.to(torch.int64).contiguous(), nf=nf, n_blocks_f=cfg.n_blocks_f,
            state_reg=cfg.state_reg, use_defect=use_defect)

    return bp
